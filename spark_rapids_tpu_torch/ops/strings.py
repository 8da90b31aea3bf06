"""Kernels over the device string layout: a ``uint8[n, W]`` byte matrix,
zero padded, plus ``int32[n]`` lengths (the part of the JAX package's
``ops/strings.py`` that comparisons, joins, range bounds, the constant
pattern predicates, ``substring``, ``substring_index``, the split of a
string at regex matches, case mapping, trims, pads, ``locate``,
``replace`` and ``concat`` need).

A string scalar (a literal) is a ``uint8[W]`` vector with a 0-d length and
broadcasts against a column. Spark orders strings by their unsigned UTF-8
bytes, so byte-lexicographic order here is Spark's order.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import string_width_bucket


def pad_width(data: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad a byte matrix (or a scalar's byte vector) to ``width``."""
    cur = data.shape[-1]
    if cur >= width:
        return data
    return torch.nn.functional.pad(data, (0, width - cur))


def align_widths(ld: torch.Tensor, rd: torch.Tensor):
    """Pad the narrower of two string payloads to the wider one's width (the
    padding bytes are zero by invariant)."""
    width = max(ld.shape[-1], rd.shape[-1])
    return pad_width(ld, width), pad_width(rd, width)


def string_eq(ld, ll, rd, rl) -> torch.Tensor:
    """Equal lengths and equal payload bytes."""
    ld, rd = align_widths(ld, rd)
    return (ll == rl) & (ld == rd).all(dim=-1)


def string_lt(ld, ll, rd, rl) -> torch.Tensor:
    """Byte-lexicographic less-than; equal payloads order by length."""
    ld, rd = align_widths(ld, rd)
    ld, rd = torch.broadcast_tensors(ld, rd)
    diff = ld != rd
    first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)
    lb = ld.gather(-1, first).squeeze(-1)
    rb = rd.gather(-1, first).squeeze(-1)
    return torch.where(diff.any(dim=-1), lb < rb, ll < rl)


def string_compare(op: str, ld, ll, rd, rl) -> torch.Tensor:
    if op == "eq":
        return string_eq(ld, ll, rd, rl)
    if op == "ne":
        return ~string_eq(ld, ll, rd, rl)
    if op == "lt":
        return string_lt(ld, ll, rd, rl)
    if op == "gt":
        return string_lt(rd, rl, ld, ll)
    if op == "le":
        return ~string_lt(rd, rl, ld, ll)
    if op == "ge":
        return ~string_lt(ld, ll, rd, rl)
    raise ValueError(op)


def _positions(width: int, device) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int32, device=device)


def _const_bytes(raw: bytes, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(device)


def char_lengths(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """UTF-8 character count: the bytes within the length that are not
    continuation bytes (10xxxxxx)."""
    in_range = _positions(data.shape[-1], data.device) < lengths[..., None]
    return (in_range & ((data & 0xC0) != 0x80)).sum(dim=-1, dtype=torch.int32)


def starts_with(data: torch.Tensor, lengths: torch.Tensor,
                prefix: bytes) -> torch.Tensor:
    """The row starts with the constant ``prefix``."""
    k = len(prefix)
    if k > data.shape[-1]:
        # longer than the column's width bucket: no row can match
        return torch.zeros(data.shape[0], dtype=torch.bool,
                           device=data.device)
    match = (data[:, :k] == _const_bytes(prefix, data.device)).all(dim=-1)
    return match & (lengths >= k)


def ends_with(data: torch.Tensor, lengths: torch.Tensor,
              suffix: bytes) -> torch.Tensor:
    """The row ends with the constant ``suffix``: its last ``k`` bytes,
    gathered at ``length - k ..``."""
    k = len(suffix)
    n, width = data.shape
    if k == 0:
        return torch.ones(n, dtype=torch.bool, device=data.device)
    idx = (lengths[:, None].to(torch.int64) - k
           + torch.arange(k, device=data.device)[None, :]).clamp(0, width - 1)
    tail = data.gather(1, idx)
    return (lengths >= k) & (tail == _const_bytes(suffix, data.device)) \
        .all(dim=-1)


def _needle_hits(data: torch.Tensor, lengths: torch.Tensor,
                 needle: bytes) -> torch.Tensor:
    """``[n, S]``: a whole in-bounds occurrence of the constant needle
    starts at byte s (S = W - k + 1). The JAX package compares one
    ``[n, S, k]`` window tensor; here the k shifted ``[n, S]`` compares are
    ANDed, which is the same test without the k-fold tensor."""
    k = len(needle)
    n, width = data.shape
    S = width - k + 1
    hit = None
    for j, b in enumerate(needle):
        eq = data[:, j:j + S] == b
        hit = eq if hit is None else hit & eq
    start_ok = _positions(S, data.device)[None, :] <= (lengths[:, None] - k)
    return hit & start_ok


def contains(data: torch.Tensor, lengths: torch.Tensor,
             needle: bytes) -> torch.Tensor:
    """Constant-needle substring search."""
    k = len(needle)
    n = data.shape[0]
    if k == 0:
        return torch.ones(n, dtype=torch.bool, device=data.device)
    if k > data.shape[-1]:
        return torch.zeros(n, dtype=torch.bool, device=data.device)
    return _needle_hits(data, lengths, needle).any(dim=-1)


def substring(data: torch.Tensor, lengths: torch.Tensor,
              start0: torch.Tensor, slice_len: torch.Tensor):
    """Byte substring: ``slice_len`` bytes from the 0-based byte
    ``start0`` of each row, at the input's width -> (data, lengths)."""
    width = data.shape[-1]
    pos = _positions(width, data.device)
    idx = (start0[:, None] + pos[None, :]).clamp(0, width - 1)
    moved = data.gather(1, idx.to(torch.int64))
    new_len = torch.minimum(slice_len, lengths - start0).clamp(0, width) \
        .to(torch.int32)
    keep = pos[None, :] < new_len[:, None]
    return torch.where(keep, moved, 0).to(torch.uint8), new_len


def char_starts(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``[n, W]``: the byte begins a UTF-8 character within the length."""
    in_range = _positions(data.shape[-1], data.device)[None, :] \
        < lengths[:, None]
    return ((data & 0xC0) != 0x80) & in_range


def char_to_byte_offset(data: torch.Tensor, lengths: torch.Tensor,
                        char_count: torch.Tensor) -> torch.Tensor:
    """The bytes spanned by each row's first ``char_count`` characters."""
    char_idx = torch.cumsum(char_starts(data, lengths).to(torch.int32),
                            dim=-1)                      # 1-based char no.
    in_range = _positions(data.shape[-1], data.device)[None, :] \
        < lengths[:, None]
    return (in_range & (char_idx <= char_count[:, None])).sum(
        dim=-1, dtype=torch.int32)


def greedy_matches(data: torch.Tensor, lengths: torch.Tensor, needle: bytes):
    """Non-overlapping left-to-right occurrences of a constant needle (the
    scan order of Spark's indexOf-based substring_index) -> (sel, plain):
    ``sel[n, W]`` marks the chosen occurrences' starts, ``plain[n, W]``
    (int32) is 1 for a byte outside every chosen occurrence and within the
    length. The choice is sequential in W: one step per byte column, each
    over all rows (the JAX package's ``lax.scan``)."""
    n, width = data.shape
    k = len(needle)
    in_range = _positions(width, data.device)[None, :] < lengths[:, None]
    sel = torch.zeros((n, width), dtype=torch.bool, device=data.device)
    if k == 0 or k > width:
        return sel, in_range.to(torch.int32)
    ok = torch.nn.functional.pad(_needle_hits(data, lengths, needle),
                                 (0, k - 1))
    inside = torch.zeros_like(sel)
    nxt = torch.zeros(n, dtype=torch.int32, device=data.device)
    for i in range(width):
        can = ok[:, i] & (nxt <= i)
        inside[:, i] = nxt > i
        sel[:, i] = can
        nxt = torch.where(can, i + k, nxt)
    return sel, (in_range & ~(sel | inside)).to(torch.int32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """The first True column of each row (0 where there is none), int32."""
    return mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)


def substring_index(data: torch.Tensor, lengths: torch.Tensor, delim: bytes,
                    count: int):
    """substring_index(str, delim, count): the text before the count-th
    delimiter (count > 0) or after the |count|-th from the last (count <
    0); the whole string when it has fewer delimiters, the empty string
    for count 0 -> (data, lengths)."""
    n = data.shape[0]
    if count == 0 or len(delim) == 0:
        return (torch.zeros_like(data),
                torch.zeros(n, dtype=torch.int32, device=data.device))
    sel, _ = greedy_matches(data, lengths, delim)
    occ = torch.cumsum(sel.to(torch.int32), dim=-1)
    total = occ[:, -1]
    if count > 0:
        has = total >= count
        cut = _first_true(sel & (occ == count))
        start = torch.zeros_like(lengths)
        new_len = torch.where(has, cut, lengths)
    else:
        want = total + count + 1
        has = total >= -count
        cut = _first_true(sel & (occ == want[:, None]))
        start = torch.where(has, cut + len(delim), 0).to(torch.int32)
        new_len = torch.where(has, lengths - start, lengths)
    return substring(data, lengths, start, new_len)


def spans_inside(sel: torch.Tensor, span_len: torch.Tensor) -> torch.Tensor:
    """The bytes inside a span but not at its start, from the span starts
    and their lengths (the regex counterpart of ``greedy_matches``'
    inside): +1 at each start, -1 at its end, a running sum."""
    n, width = sel.shape
    starts = sel.to(torch.int32)
    ends = torch.where(sel, _positions(width, sel.device)[None, :] + span_len,
                       width).clamp(0, width).to(torch.int64)
    delta = torch.zeros((n, width + 1), dtype=torch.int32, device=sel.device)
    delta.scatter_add_(1, ends, -starts)
    covered = torch.cumsum(delta[:, :width] + starts, dim=-1) > 0
    return covered & ~sel


def split_field(data: torch.Tensor, lengths: torch.Tensor, sel: torch.Tensor,
                span_len: torch.Tensor, k: int):
    """Field k (0-based) of each row split at the chosen delimiter spans
    (Spark's split(str, regex)[k]): the bytes between the end of span k-1
    and the start of span k -> (data, lengths, exists); a row with fewer
    than k spans has no field k."""
    occ = torch.cumsum(sel.to(torch.int32), dim=-1)
    total = occ[:, -1]
    if k == 0:
        start = torch.zeros_like(lengths)
    else:
        p = _first_true(sel & (occ == k))
        slen = span_len.gather(1, p[:, None].to(torch.int64))[:, 0]
        start = torch.where(total >= k, p + slen.clamp(min=0), lengths)
    endp = torch.where(total >= k + 1, _first_true(sel & (occ == k + 1)),
                       lengths)
    d, l = substring(data, lengths, start.to(torch.int32),
                     (endp - start).clamp(min=0))
    return d, l, total >= k


def upper_ascii(data: torch.Tensor) -> torch.Tensor:
    """ASCII a-z to A-Z; every other byte (multibyte UTF-8 too) unchanged."""
    return torch.where((data >= 97) & (data <= 122), data - 32, data)


def lower_ascii(data: torch.Tensor) -> torch.Tensor:
    return torch.where((data >= 65) & (data <= 90), data + 32, data)


def initcap(data: torch.Tensor) -> torch.Tensor:
    """Spark's initcap (``toLowerCase().toTitleCase()``, ASCII letters
    only): every letter lower case, then the first byte and every byte
    after a space upper case."""
    low = lower_ascii(data)
    after_space = torch.cat([torch.ones_like(data[..., :1], dtype=torch.bool),
                             data[..., :-1] == 32], dim=-1)
    return torch.where(after_space, upper_ascii(low), low)


#: the most decimal digits of an int64 (Long.MIN has 19 and a sign)
_MAX_DIGITS = 19


def int_to_string(v: torch.Tensor, width: int):
    """Integral values -> their decimal strings ``(data, lengths)``, as
    wide as the width bucket of Long.MIN's 20 characters, at most
    ``width``.
    Digits come from the non-positive magnitude (``-|v|``, which every
    int64 has, Long.MIN too) by truncating division by powers of ten."""
    v = v.to(torch.int64)
    n = v.shape[0]
    neg = v < 0
    m = torch.where(neg, v, -v)                          # -|v|
    powers = torch.tensor([10 ** (_MAX_DIGITS - 1 - i)
                           for i in range(_MAX_DIGITS)], dtype=torch.int64,
                          device=v.device)
    digits = -torch.fmod(torch.div(m[:, None], powers, rounding_mode="trunc"),
                         10)                              # [n, 19], MSD first
    nonzero = digits != 0
    ndigits = torch.where(nonzero.any(dim=-1),
                          _MAX_DIGITS - nonzero.to(torch.uint8)
                          .argmax(dim=-1), 1).to(torch.int32)
    nlen = ndigits + neg.to(torch.int32)
    out_w = string_width_bucket(_MAX_DIGITS + 1, width)
    j = _positions(out_w, v.device)[None, :]
    src = (_MAX_DIGITS - ndigits[:, None] + j - neg.to(torch.int32)[:, None])
    out = digits.gather(1, src.clamp(0, _MAX_DIGITS - 1).to(torch.int64)) + 48
    out = torch.where(neg[:, None] & (j == 0), 45, out)
    keep = j < nlen[:, None]
    return torch.where(keep, out, 0).to(torch.uint8).reshape(n, out_w), nlen


def bool_to_string(v: torch.Tensor, width: int):
    """Booleans -> ``true``/``false`` ``(data, lengths)``, 8 bytes wide
    (``width``, the session's cap, is at least that)."""
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    rows[0, :5] = torch.tensor(list(b"false"), dtype=torch.uint8)
    rows[1, :4] = torch.tensor(list(b"true"), dtype=torch.uint8)
    rows = rows.to(v.device)
    return rows[v.to(torch.int64)], torch.where(v, 4, 5).to(torch.int32)


def locate(data: torch.Tensor, lengths: torch.Tensor, needle: bytes,
           start1: int) -> torch.Tensor:
    """The 1-based character position of the first occurrence of the
    constant needle at or after the 1-based character ``start1``; 0 when
    there is none (Spark's StringLocate counts characters)."""
    n, width = data.shape
    k = len(needle)
    if k == 0 or k > width:
        return torch.zeros(n, dtype=torch.int32, device=data.device)
    start = torch.full((n,), start1 - 1, dtype=torch.int32,
                       device=data.device)
    byte_start = char_to_byte_offset(data, lengths, start)
    ok = _needle_hits(data, lengths, needle)
    ok = ok & (_positions(ok.shape[1], data.device)[None, :]
               >= byte_start[:, None])
    any_ok = ok.any(dim=-1)
    first = _first_true(ok)
    # the byte offset as a character position: the characters before it
    before = (char_starts(data, lengths)
              & (_positions(width, data.device)[None, :] < first[:, None])) \
        .sum(dim=-1, dtype=torch.int32)
    return torch.where(any_ok, before + 1, 0).to(torch.int32)


def trim_bounds(data: torch.Tensor, lengths: torch.Tensor, left: bool,
                right: bool, chars: bytes = b" "):
    """(start, new length) after stripping any byte of ``chars`` from the
    chosen ends (Spark's trim family; ASCII space by default)."""
    width = data.shape[-1]
    in_range = _positions(width, data.device)[None, :] < lengths[:, None]
    member = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for ch in bytearray(chars):
        member |= data == ch
    keepable = ~member & in_range
    any_keep = keepable.any(dim=-1)
    first = _first_true(keepable)
    last = (width - 1 - _first_true(keepable.flip(-1))).to(torch.int32)
    start = torch.where(any_keep & left, first, 0)
    end = torch.where(any_keep, last + 1 if right else lengths, 0)
    return start.to(torch.int32), (end - start).clamp(min=0).to(torch.int32)


def _utf8_chars(b: bytes):
    """``b`` cut at its UTF-8 character starts."""
    starts = [i for i, c in enumerate(b) if (c & 0xC0) != 0x80]
    return [b[s:e] for s, e in zip(starts, starts[1:] + [len(b)])]


def pad_fill_total_bytes(pad_bytes: bytes, target: int) -> int:
    """The bytes of ``target`` characters of the cyclic pad."""
    chars = _utf8_chars(pad_bytes)
    if not chars or target <= 0:
        return 0
    q, r = divmod(target, len(chars))
    return q * sum(len(c) for c in chars) + sum(len(c) for c in chars[:r])


def pad(data: torch.Tensor, lengths: torch.Tensor, target: int,
        pad_bytes: bytes, side: str, width: int):
    """lpad/rpad to ``target`` characters with the cyclic constant pad, at
    ``width`` bytes; a longer string is cut to ``target`` characters and an
    empty pad can only cut. A cut at the width ends on a character
    boundary -> (data, lengths)."""
    device = data.device
    data = pad_width(data, width)
    j = _positions(width, device)[None, :]
    charcnt = char_lengths(data, lengths)
    keep_bytes = char_to_byte_offset(
        data, lengths, torch.clamp(charcnt, max=target))
    pchars = _utf8_chars(pad_bytes)
    if not pchars:
        keep = j < keep_bytes[:, None]
        return torch.where(keep, data, 0).to(torch.uint8), keep_bytes
    # the first T fill characters (a literal, so built on the host) and the
    # bytes of the first m of them; T stops at the width, past which every
    # fill byte is cut
    T = min(target, width)
    fill = b"".join(pchars[i % len(pchars)] for i in range(T))
    fill_len = np.zeros(T + 1, dtype=np.int32)
    acc = 0
    for m in range(T):
        acc += len(pchars[m % len(pchars)])
        fill_len[m + 1] = acc
    farr = (_const_bytes(fill, device) if fill
            else torch.zeros(1, dtype=torch.uint8, device=device))
    pad_chars = (target - charcnt.to(torch.int64)).clamp(0, T)
    fill_bytes = torch.from_numpy(fill_len).to(device)[pad_chars]
    new_len = torch.clamp(keep_bytes + fill_bytes, max=width).to(torch.int32)
    fcap = max(len(fill), 1)
    if side == "right":
        from_fill = j >= keep_bytes[:, None]
        fidx = (j - keep_bytes[:, None]).clamp(0, fcap - 1)
        out = torch.where(from_fill, farr[fidx.to(torch.int64)], data)
    else:
        from_fill = j < fill_bytes[:, None]
        fidx = j.clamp(0, fcap - 1).expand_as(data)
        src = (j - fill_bytes[:, None]).clamp(0, width - 1)
        moved = data.gather(1, src.to(torch.int64))
        out = torch.where(from_fill, farr[fidx.to(torch.int64)], moved)
    # round a cut at the width down to a character boundary: the last
    # character start within the kept bytes and its lead byte's length
    # decide whether that character survives whole
    start_keep = ((out & 0xC0) != 0x80) & (j < new_len[:, None])
    s = (width - 1 - _first_true(start_keep.flip(-1))).to(torch.int64)
    lead = out.gather(1, s[:, None])[:, 0]
    clen = torch.where(lead < 0xC0, 1, torch.where(
        lead < 0xE0, 2, torch.where(lead < 0xF0, 3, 4)))
    new_len = torch.where(new_len > 0,
                          torch.where(s + clen <= new_len, new_len, s),
                          new_len).to(torch.int32)
    keep = j < new_len[:, None]
    return torch.where(keep, out, 0).to(torch.uint8), new_len


def replace_const(data: torch.Tensor, lengths: torch.Tensor, search: bytes,
                  repl: bytes, width_out: int):
    """replace(str, search, repl) with constant operands: the greedy
    left-to-right occurrences, each emitting the whole replacement, the
    other bytes passing through, cut at ``width_out`` bytes."""
    sel, plain = greedy_matches(data, lengths, search)
    return reassemble_spans(data, sel, plain, repl, width_out)


def reassemble_spans(data: torch.Tensor, sel: torch.Tensor,
                     plain: torch.Tensor, repl: bytes, width_out: int):
    """Rank-gather reassembly: ``sel`` marks span starts (each emits
    ``repl``), ``plain`` is 1 where a byte passes through. Each emitting
    byte goes to its exclusive running offset; every output position reads
    the last emitting byte at or before it (a scatter of maxima, then a
    running max) -> (data, lengths)."""
    n, width = data.shape
    device = data.device
    r = len(repl)
    emit = torch.where(sel, r, plain).to(torch.int32)
    csum = torch.cumsum(emit, dim=-1, dtype=torch.int32)
    dst = csum - emit
    new_len = torch.clamp(csum[:, -1], max=width_out).to(torch.int32)
    o = _positions(width_out, device)
    emitting = (emit > 0) & (dst < width_out)
    d = torch.where(emitting, dst, width_out - 1).to(torch.int64)
    vals = torch.where(emitting, _positions(width, device)[None, :], -1) \
        .to(torch.int32)
    head = torch.full((n, width_out), -1, dtype=torch.int32, device=device)
    head.scatter_reduce_(1, d, vals, reduce="amax", include_self=True)
    inv = torch.cummax(head, dim=1).values.clamp(0, width - 1) \
        .to(torch.int64)
    src_char = data.gather(1, inv)
    is_repl = sel.gather(1, inv)
    kk = o[None, :] - dst.gather(1, inv)
    if r > 0:
        repl_char = _const_bytes(repl, device)[
            kk.clamp(0, r - 1).to(torch.int64)]
    else:
        repl_char = torch.zeros_like(src_char)
    out = torch.where(is_repl, repl_char, src_char)
    keep = o[None, :] < new_len[:, None]
    return torch.where(keep, out, 0).to(torch.uint8), new_len


def concat2(ld: torch.Tensor, ll: torch.Tensor, rd: torch.Tensor,
            rl: torch.Tensor, width: int):
    """Two string columns end to end, cut at ``width`` bytes."""
    ld, rd = pad_width(ld, width), pad_width(rd, width)
    pos = _positions(width, ld.device)[None, :]
    from_right = pos >= ll[:, None]
    ridx = (pos - ll[:, None]).clamp(0, width - 1).to(torch.int64)
    out = torch.where(from_right, rd.gather(1, ridx), ld)
    new_len = torch.clamp(ll + rl, max=width).to(torch.int32)
    keep = pos < new_len[:, None]
    return torch.where(keep, out, 0).to(torch.uint8), new_len
