"""Kernels over the device string layout: a ``uint8[n, W]`` byte matrix,
zero padded, plus ``int32[n]`` lengths (the part of the JAX package's
``ops/strings.py`` that comparisons, joins, range bounds, the constant
pattern predicates and ``substring`` need).

A string scalar (a literal) is a ``uint8[W]`` vector with a 0-d length and
broadcasts against a column. Spark orders strings by their unsigned UTF-8
bytes, so byte-lexicographic order here is Spark's order.
"""
from __future__ import annotations

import numpy as np
import torch


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
