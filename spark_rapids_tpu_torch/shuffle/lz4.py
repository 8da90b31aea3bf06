"""LZ4 block-format codec with a dependency-free fallback.

The shuffle's lz4 TableCompressionCodec (shuffle/codec.py) needs to exist
on every executor — codec negotiation is only useful when the fast codec is
actually available to negotiate — so this module implements the standard
LZ4 *block* format (token / literals / little-endian u16 offset / 4+ match
length, spec: lz4_Block_format.md) in pure Python and transparently uses
the C ``lz4.block`` implementation when the package is installed. The two
interoperate: both read and write the same block format (the pure
decompressor accepts C-compressed frames and vice versa), so mixed
deployments negotiate "lz4" safely.

The pure compressor is a greedy single-probe hash-chain matcher with the
reference implementation's skip acceleration on miss streaks — spec-valid
output, not bit-identical to the C encoder (LZ4 only fixes the DEcoder).
Throughput is Python-speed; fine for the shuffle's request-sized buffers in
tests and small clusters, and the C path takes over wherever it exists.
"""
from __future__ import annotations

from typing import Optional

try:                                     # C implementation when available
    import lz4.block as _c_lz4
except ImportError:                      # pure-Python fallback below
    _c_lz4 = None

_MIN_MATCH = 4
#: spec: the last 5 bytes are always literals, and a match may not start
#: within the last 12 bytes of the input
_LAST_LITERALS = 5
_MFLIMIT = 12
_MAX_OFFSET = 0xFFFF


def _write_len(out: bytearray, n: int) -> None:
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def _compress_pure(src: bytes) -> bytes:
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"                   # one empty-literal token
    anchor = 0
    if n >= _MFLIMIT + 1:
        table: dict = {}
        i = 0
        limit = n - _MFLIMIT
        misses = 0
        while i <= limit:
            seq = src[i:i + _MIN_MATCH]
            j = table.get(seq)
            table[seq] = i
            if j is not None and i - j <= _MAX_OFFSET:
                # extend the match forward (must leave 5 literal bytes)
                m = i + _MIN_MATCH
                p = j + _MIN_MATCH
                max_m = n - _LAST_LITERALS
                while m < max_m and src[m] == src[p]:
                    m += 1
                    p += 1
                lit_len = i - anchor
                match_len = m - i - _MIN_MATCH
                token = ((15 if lit_len >= 15 else lit_len) << 4) | \
                    (15 if match_len >= 15 else match_len)
                out.append(token)
                if lit_len >= 15:
                    _write_len(out, lit_len - 15)
                out += src[anchor:i]
                out += (i - j).to_bytes(2, "little")
                if match_len >= 15:
                    _write_len(out, match_len - 15)
                anchor = i = m
                misses = 0
                continue
            # reference-style acceleration: long miss streaks skip ahead
            misses += 1
            i += 1 + (misses >> 6)
    lit_len = n - anchor
    out.append((15 if lit_len >= 15 else lit_len) << 4)
    if lit_len >= 15:
        _write_len(out, lit_len - 15)
    out += src[anchor:]
    return bytes(out)


def _decompress_pure(src: bytes, out_size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    if out_size == 0:
        return b""
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break                        # final sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError(f"lz4: invalid match offset {offset} at "
                             f"output position {len(out)}")
        ml = token & 0x0F
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += _MIN_MATCH
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            # overlapping match: the copy source grows as we write
            # (RLE-style); double the copied span instead of per-byte
            remaining = ml
            while remaining > 0:
                span = out[start:start + min(remaining, len(out) - start)]
                out += span
                remaining -= len(span)
    if len(out) != out_size:
        raise ValueError(f"lz4: decompressed to {len(out)} bytes, "
                         f"expected {out_size}")
    return bytes(out)


def compress(buf: bytes) -> bytes:
    """LZ4 block-compress ``buf`` (no size header; the shuffle meta carries
    uncompressed_size)."""
    if _c_lz4 is not None:
        return _c_lz4.compress(bytes(buf), store_size=False)
    return _compress_pure(bytes(buf))


def decompress(buf: bytes, out_size: int) -> bytes:
    if _c_lz4 is not None:
        return _c_lz4.decompress(bytes(buf), uncompressed_size=out_size)
    return _decompress_pure(bytes(buf), out_size)


def backend() -> str:
    return "c" if _c_lz4 is not None else "pure-python"
