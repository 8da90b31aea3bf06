"""Kernels over the device string layout: a ``uint8[n, W]`` byte matrix,
zero padded, plus ``int32[n]`` lengths (the part of the JAX package's
``ops/strings.py`` that comparisons, joins and range bounds need).

A string scalar (a literal) is a ``uint8[W]`` vector with a 0-d length and
broadcasts against a column. Spark orders strings by their unsigned UTF-8
bytes, so byte-lexicographic order here is Spark's order.
"""
from __future__ import annotations

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
