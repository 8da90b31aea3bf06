"""Batch-level tensor operations: row hashing, key encodings, compaction,
sorting and segment reduction.

The JAX package computes its 64-bit hashes in uint64. Torch has little
unsigned support (no uint64 ``>>`` or ``<`` on the CPU), so every uint64
value here lives in an int64 tensor holding the same bits:

- multiplication and addition wrap the same in both;
- a logical right shift is ``(x >> k) & (2**(64-k) - 1)`` (``_srl``);
- an unsigned compare, sort or search flips the sign bit first
  (``unsigned_order``), which maps unsigned order onto signed order.

Hashes computed this way are bit-identical to the JAX package's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType, bucket_capacity
from spark_rapids_tpu_torch.exprs.core import ColV

_MASK64 = (1 << 64) - 1


def s64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= (1 << 63) else c


_SIGN = s64(1 << 63)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def unsigned_order(x: torch.Tensor) -> torch.Tensor:
    """int64-held uint64 bits -> int64 values whose signed order is the
    unsigned order of the bits."""
    return x ^ _SIGN


# ---------------------------------------------------------------------------
# 64-bit row hashing (the one-hot grouping's key)
# ---------------------------------------------------------------------------
_HSEED = s64(0x243F6A8885A308D3)
_HNULL = s64(0x452821E638D01377)
_HGOLD = s64(0x9E3779B97F4A7C15)
_M1 = s64(0xBF58476D1CE4E5B9)
_M2 = s64(0x94D049BB133111EB)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (wrapping 64-bit arithmetic)."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def _string_words(data: torch.Tensor) -> torch.Tensor:
    """[n, W] uint8 -> [n, ceil(W/8)] big-endian 64-bit words (int64-held)."""
    n, width = data.shape
    pad = (-width) % 8
    if pad:
        data = torch.cat([data, data.new_zeros((n, pad))], dim=1)
    # byte-reverse each 8-byte chunk, then read it as a little-endian word
    return data.reshape(n, -1, 8).flip(-1).contiguous().view(torch.int64) \
        .view(n, -1)


def _float_canon(d: torch.Tensor):
    """Canonical decomposition of float64 data: (sign, e, mi, zero, inf, nan)
    with |d| = (mi / 2**52) * 2**e and mi in [2**52, 2**53) for every finite
    nonzero value. ``frexp`` gives the decomposition exactly, as the JAX
    package's numpy engine computes it (its jax path estimates it with
    ``log2``/``exp2``, which XLA evaluates inexactly for most exponents)."""
    sign = d < 0
    ax = d.abs()
    nan = torch.isnan(d)
    inf = torch.isinf(d)
    zero = ax == 0
    finite = ~(nan | inf | zero)
    m, ex = torch.frexp(torch.where(finite, ax, torch.ones_like(ax)))
    e = ex.to(torch.int64) - 1
    mi = (m * 2.0 ** 53).to(torch.int64)
    return sign, e, mi, zero, inf, nan


def _hash64_col(v: ColV) -> torch.Tensor:
    """Per-row 64-bit hash of one column; equal keys under Spark grouping
    semantics (null == null, NaN == NaN, -0.0 == 0.0) hash equal."""
    if v.dtype is DType.STRING:
        words = _string_words(v.data)
        bits = v.lengths.to(torch.int64)
        for i in range(words.shape[1]):
            off = s64((i + 1) * (_HGOLD & _MASK64))
            bits = _mix64(bits ^ _mix64(words[:, i] + off))
    elif v.dtype.is_floating:
        sign, e, mi, zero, inf, nan = _float_canon(v.data.to(torch.float64))
        sbit = sign.to(torch.int64) << 63
        bits = mi ^ _mix64(e + _HGOLD) ^ sbit
        bits = torch.where(zero, 0, bits)
        bits = torch.where(inf, s64(0x7FF0000000000000) ^ sbit, bits)
        bits = torch.where(nan, s64(0x7FF8000000000000), bits)
    else:
        bits = v.data.to(torch.int64)
    return torch.where(v.validity, _mix64(bits + _HGOLD), _HNULL)


def hash64_cols(cols: Sequence[ColV]) -> torch.Tensor:
    """Combined 64-bit row hash over the key columns (int64-held uint64)."""
    h = torch.full_like(cols[0].validity, _HSEED, dtype=torch.int64)
    for v in cols:
        h = _mix64((h ^ _hash64_col(v)) * _HGOLD + _HGOLD)
    return h


def key_words(v: ColV) -> List[torch.Tensor]:
    """Injective 64-bit encoding of one grouping-key column: two rows are
    grouping-equal iff all their words are equal. Invalid rows encode as 0
    everywhere; ``validity_word`` separates them from zero-encoded values."""
    if v.dtype is DType.STRING:
        words = _string_words(v.data)
        out = [words[:, i] for i in range(words.shape[1])]
        out.append(v.lengths.to(torch.int64))
    elif v.dtype.is_floating:
        sign, e, mi, zero, inf, nan = _float_canon(v.data.to(torch.float64))
        w0 = torch.where(zero, 1, mi)
        w0 = torch.where(inf, 2, w0)
        w0 = torch.where(nan, 3, w0)
        w1 = (e + 1074) | (sign.to(torch.int64) << 13)
        w1 = torch.where(zero | nan, 0, w1)
        w1 = torch.where(inf, sign.to(torch.int64), w1)
        out = [w0, w1]
    else:
        out = [v.data.to(torch.int64)]
    return [torch.where(v.validity, w, 0) for w in out]


def validity_word(keys: Sequence[ColV]) -> torch.Tensor:
    """One 64-bit word packing every key column's validity bit (<= 64)."""
    w = None
    for i, v in enumerate(keys[:64]):
        piece = v.validity.to(torch.int64) << i
        w = piece if w is None else w | piece
    return w


# ---------------------------------------------------------------------------
# rows: liveness, gathers, compaction
# ---------------------------------------------------------------------------
def alive_mask(capacity: int, num_rows: int, device) -> torch.Tensor:
    return torch.arange(capacity, device=device) < num_rows


def as_column(v: ColV, capacity: int) -> ColV:
    """Broadcast a scalar ColV (a literal) to a full column."""
    if not v.is_scalar:
        return v
    data = (v.data.expand(capacity, -1) if v.dtype is DType.STRING
            else v.data.expand(capacity))
    lengths = v.lengths.expand(capacity) if v.lengths is not None else None
    return ColV(v.dtype, data, v.validity.expand(capacity), lengths)


def take_colv(v: ColV, indices: torch.Tensor) -> ColV:
    """Gather rows of a column."""
    return ColV(v.dtype, v.data[indices], v.validity[indices],
                v.lengths[indices] if v.lengths is not None else None)


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    if t.shape[0] == cap:
        return t
    out = t.new_zeros((cap,) + tuple(t.shape[1:]))
    out[:t.shape[0]] = t
    return out


def take_padded(v: ColV, indices: torch.Tensor, cap: int) -> ColV:
    """Gather rows into a fresh column of ``cap`` rows, the rest padding
    (invalid, zeroed)."""
    g = take_colv(v, indices)
    return ColV(v.dtype, _pad(g.data, cap), _pad(g.validity, cap),
                _pad(g.lengths, cap) if g.lengths is not None else None)


def compact(mask: torch.Tensor, columns: Sequence[ColV]
            ) -> Tuple[List[ColV], int]:
    """Keep the rows where ``mask`` is true, in order, in a batch of the kept
    count's capacity bucket. ``mask`` must be false on padding rows."""
    idx = torch.nonzero(mask).squeeze(1)
    n = int(idx.numel())
    cap = bucket_capacity(n)
    return [take_padded(v, idx, cap) for v in columns], n


# ---------------------------------------------------------------------------
# sorting
# ---------------------------------------------------------------------------
def _null_rank(v: ColV, nulls_first: bool) -> torch.Tensor:
    return torch.where(v.validity, 0, -1 if nulls_first else 1).to(torch.int8)


def _key_passes(v: ColV, ascending: bool, nulls_first: bool
                ) -> List[torch.Tensor]:
    """One sort key -> sort passes, most significant first."""
    def flip_i(k):
        return k if ascending else ~k

    passes: List[torch.Tensor] = []
    if v.dtype is DType.STRING:
        words = _string_words(v.data)
        for i in range(words.shape[1]):
            passes.append(flip_i(unsigned_order(words[:, i])))
        passes.append(flip_i(v.lengths.to(torch.int64)))
    elif v.dtype.is_floating:
        d = v.data.to(torch.float64)
        nan = torch.isnan(d)
        val = torch.where(nan, float("inf"), d)
        val = torch.where(val == 0, 0.0, val)      # -0.0 == 0.0
        passes = [flip_i(nan.to(torch.int8)), val if ascending else -val]
    else:
        passes.append(flip_i(v.data.to(torch.int64)))
    return [_null_rank(v, nulls_first)] + passes


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def lexsort(passes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order by ``passes`` (most significant first),
    composed least-significant first from stable sorts."""
    order = torch.arange(passes[0].shape[0], device=passes[0].device)
    for k in reversed(passes):
        order = order[_stable_argsort(k[order])]
    return order


def sort_indices(keys: Sequence[Tuple[ColV, bool, bool]],
                 alive: torch.Tensor) -> torch.Tensor:
    """Row permutation for (column, ascending, nulls_first) keys, most
    significant first; dead (padding) rows go last."""
    passes = [(~alive).to(torch.int8)]
    for v, asc, nf in keys:
        passes.extend(_key_passes(v, asc, nf))
    return lexsort(passes)


def hash_group_order(keys: Sequence[ColV], alive: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash grouping's row order: live rows by ``h >> 1`` (the 64-bit
    key hash shifted right once), stable, then the dead rows in row order.
    Returns (order, h). Equal keys land contiguous; only two different keys
    sharing a shifted hash can split a group, which
    ``detect_hash_collision_sorted`` flags.

    The JAX package sorts the uint64 ``h >> 1`` with dead rows at the
    uint64 maximum, which no shifted hash reaches. Held in int64, ``h >> 1``
    is non-negative and may be ``INT64_MAX`` itself, so the dead rows get a
    second, more significant sort key instead of a sentinel."""
    h = hash64_cols(keys)
    hs = torch.where(alive, _srl(h, 1), 0)
    return lexsort([(~alive).to(torch.int8), hs]), h


def detect_hash_collision_sorted(hs_sorted: torch.Tensor,
                                 starts: torch.Tensor,
                                 sorted_alive: torch.Tensor) -> bool:
    """Collision flag over hash-ordered rows: a group boundary between two
    live rows with the same shifted hash means two distinct keys collided."""
    prev_h = torch.cat([hs_sorted[:1], hs_sorted[:-1]])
    prev_a = torch.cat([sorted_alive.new_zeros(1), sorted_alive[:-1]])
    return bool((starts & (hs_sorted == prev_h) & sorted_alive
                 & prev_a).any())


def rows_equal_adjacent(keys: Sequence[ColV], order: torch.Tensor,
                        alive: torch.Tensor) -> torch.Tensor:
    """Group-start marks of the rows taken in ``order`` (null == null, NaN
    == NaN); dead rows never start a group."""
    return starts_from_sorted([take_colv(v, order) for v in keys],
                              alive[order])


def sort_colvs(passes: Sequence[torch.Tensor], colvs: Sequence[ColV]
               ) -> List[ColV]:
    """Reorder whole columns by the key passes."""
    order = lexsort(passes)
    return [take_colv(v, order) for v in colvs]


def starts_from_sorted(sorted_keys: Sequence[ColV],
                       sorted_alive: torch.Tensor) -> torch.Tensor:
    """Group-start marks over key columns already in key order (null ==
    null, NaN == NaN)."""
    cap = sorted_alive.shape[0]
    new_group = torch.arange(cap, device=sorted_alive.device) == 0

    def prev(a):
        return torch.cat([a[:1], a[:-1]])

    for v in sorted_keys:
        if v.dtype is DType.STRING:
            same_data = ((v.data == prev(v.data)).all(dim=1)
                         & (v.lengths == prev(v.lengths)))
        elif v.dtype.is_floating:
            a, b = v.data, prev(v.data)
            same_data = (a == b) | (torch.isnan(a) & torch.isnan(b))
        else:
            same_data = v.data == prev(v.data)
        pv = prev(v.validity)
        same = torch.where(v.validity & pv, same_data, v.validity == pv)
        new_group = new_group | ~same
    return new_group & sorted_alive


def segment_sum(contrib: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, ids_sorted: bool = False) -> torch.Tensor:
    """Per-segment sum. Integer sums come out the same in any order, and
    the CPU's ``index_add_`` adds in row order; on the GPU its atomic adds
    make a float sum's last bits vary from run to run, so there a float
    sum reduces each segment in a fixed order instead
    (``torch.segment_reduce`` over the rows sorted by segment). The same
    rows then give the same bits every time, which Q15's equality of a sum
    with the max of the same sums computed in another pass needs.
    ``ids_sorted`` says the ids are already non-decreasing."""
    if not contrib.is_floating_point() or contrib.device.type == "cpu":
        return contrib.new_zeros(num_segments).index_add_(0, seg_ids, contrib)
    if not ids_sorted:
        order = torch.sort(seg_ids, stable=True).indices
        seg_ids, contrib = seg_ids[order], contrib[order]
    lengths = torch.bincount(seg_ids, minlength=num_segments)
    return torch.segment_reduce(contrib, "sum", lengths=lengths, unsafe=True)


def segment_reduce(data: torch.Tensor, validity: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int, kind: str,
                   ids_sorted: bool = False):
    """Per-segment ``sum``, ``min`` or ``max`` -> (seg_data, seg_validity);
    a segment is valid when any of its rows was. min and max follow
    Spark's order (NaN above every other value) and leave a segment with
    no valid row at the reduction's neutral value."""
    counts = torch.zeros(num_segments, dtype=torch.int64,
                         device=data.device).index_add_(
        0, seg_ids, validity.to(torch.int64))
    if kind == "sum":
        contrib = torch.where(validity, data, 0).to(data.dtype)
        return segment_sum(contrib, seg_ids, num_segments, ids_sorted), \
            counts > 0
    if kind in ("min", "max"):
        res, nan_count = minmax_parts(data, validity, seg_ids, num_segments,
                                      kind)
        return minmax_finish(res, counts, nan_count, kind), counts > 0
    raise ValueError(f"unknown segment reduction {kind!r}")


def minmax_parts(data: torch.Tensor, validity: torch.Tensor,
                 seg_ids: torch.Tensor, num_segments: int, kind: str):
    """The raw pieces of a segment min/max -> (reduced, nan_count): NaN is
    replaced by +inf before the reduction and counted (None for
    non-floats), since ``scatter_reduce``'s amin/amax have no defined NaN
    order. Every segment starts at the neutral value (``iinfo`` bounds for
    integers, the infinities for floats), so an empty segment keeps it."""
    op = "amin" if kind == "min" else "amax"
    nan_count = None
    if data.dtype == torch.bool:
        d = torch.where(validity, data.to(torch.int8), int(kind == "min"))
        init = int(kind == "min")
    elif data.dtype.is_floating_point:
        nan = torch.isnan(data)
        init = float("inf") if kind == "min" else float("-inf")
        d = torch.where(validity, torch.where(nan, float("inf"), data), init)
        nan_count = torch.zeros(num_segments, dtype=torch.int64,
                                device=data.device).index_add_(
            0, seg_ids, (nan & validity).to(torch.int64))
    else:
        info = torch.iinfo(data.dtype)
        init = info.max if kind == "min" else info.min
        d = torch.where(validity, data, init)
    d = d.to(torch.int8 if data.dtype == torch.bool else data.dtype)
    out = torch.full((num_segments,), init, dtype=d.dtype,
                     device=data.device).scatter_reduce_(0, seg_ids, d, op)
    return (out.to(torch.bool) if data.dtype == torch.bool else out), \
        nan_count


def minmax_finish(res: torch.Tensor, valid_count: torch.Tensor, nan_count,
                  kind: str) -> torch.Tensor:
    """Spark's NaN rule on a reduced min/max: a max that saw a NaN is NaN;
    a min is NaN only when every valid value was."""
    if nan_count is None:
        return res
    if kind == "max":
        return torch.where(nan_count > 0, float("nan"), res)
    return torch.where((valid_count > 0) & (nan_count == valid_count),
                       float("nan"), res)
