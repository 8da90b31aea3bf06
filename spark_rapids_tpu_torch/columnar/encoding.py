"""Encoded columnar forms that cross the host link instead of decoded bytes
(the JAX package's ``columnar/encoding.py``).

- **Run-end-encoded staging** (``ree_staged``, ``expand_ree_device``): a
  parquet column chunk whose index stream is RLE-dominant uploads as
  (run_ends, per-run values) pairs and expands on the device with a
  searchsorted gather; the host never materializes the decoded column.
- **DictEncoding**: a device column that arrived dictionary-encoded keeps
  its index vector and its dictionary beside the decoded data, so filters,
  group-by keys and equi-join keys can run on the index domain
  (exprs/encoded.py).
- **DictionaryUnifier**: per scan, each row group's dictionary is remapped
  into one growing, prefix-compatible dictionary per column, so the batches
  of one scan share a dictionary identity (``token``) and
  ``concat_device_batches`` carries the encoding across batches.

The JAX package pads each dictionary to a power-of-two bucket to keep its
jit cache keys stable (and carries the live count ``k_real`` to mask the
pad slots); the port evaluates eagerly and keeps every dictionary at its
real size, so no pad slot exists. EncViews are passed to the evaluation
directly, with no flatten/unflatten pair.

pyarrow is imported inside the host functions only: the device upload of
an in-memory table never needs it.
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType

#: pa.Field metadata key carrying the DictionaryUnifier token of a column
DICT_TOKEN_META = b"spark_rapids_tpu.dict_token"


# ---------------------------------------------------------------------------
# counters (the JAX package's transfer metrics of the encoded path)
# ---------------------------------------------------------------------------
#: bytes staged for the link by the arrow upload, the bytes the decoded
#: forms would have staged, operators that ran on dictionary indices, and
#: exchange splits that carried indices
COUNTERS = {"encoded_bytes": 0, "decoded_equivalent_bytes": 0,
            "encoded_domain_ops": 0, "exchange_encoded_ops": 0}
_COUNTERS_LOCK = threading.Lock()


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        for k in COUNTERS:
            COUNTERS[k] = 0


def counters() -> dict:
    with _COUNTERS_LOCK:
        return dict(COUNTERS)


def count(key: str, value: int = 1) -> None:
    with _COUNTERS_LOCK:
        COUNTERS[key] += value


# ---------------------------------------------------------------------------
# run-end-encoded host staging + device expansion
# ---------------------------------------------------------------------------
def ree_staged(arr) -> Tuple[np.ndarray, Any]:
    """Normalize a (possibly sliced) REE array to slice-relative
    ``(run_ends int32, values)``: run_ends are clipped to the slice and the
    values array keeps only the runs the slice touches. O(runs), not
    O(rows)."""
    ends = np.asarray(arr.run_ends, dtype=np.int64)
    off, n = arr.offset, len(arr)
    if n == 0:
        return np.zeros(0, np.int32), arr.values.slice(0, 0)
    first = int(np.searchsorted(ends, off, side="right"))
    last = int(np.searchsorted(ends, off + n - 1, side="right"))
    rel = np.clip(ends[first:last + 1] - off, 0, n).astype(np.int32)
    rel[-1] = n
    return rel, arr.values.slice(first, last + 1 - first)


def ree_to_plain(arr):
    """Expand an REE array on the host (an in-memory table's decode and the
    type-drift fallback; the scan's upload expands on the device)."""
    import pyarrow as pa
    ends, vals = ree_staged(arr)
    if len(ends) == 0:
        return vals
    counts = np.diff(np.concatenate([[0], ends.astype(np.int64)]))
    take = np.repeat(np.arange(len(ends), dtype=np.int64), counts)
    return vals.take(pa.array(take))


def expand_ree_device(run_ends: torch.Tensor, values: torch.Tensor,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row i takes values[j] for the first run end > i (a searchsorted
    gather). Rows past the last run end (capacity padding) clamp to the
    final run; the caller zeroes them. Returns (data, run index per row)."""
    rows = torch.arange(capacity, dtype=run_ends.dtype,
                        device=run_ends.device)
    idx = torch.searchsorted(run_ends, rows, right=True)
    idx = torch.clamp(idx, max=values.shape[0] - 1)
    return values.index_select(0, idx), idx


# ---------------------------------------------------------------------------
# device-side dictionary encoding (late materialization)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DictEncoding:
    """The encoded form of a device column, kept beside the decoded data:
    ``data == values[indices]`` row by row (strings: byte-matrix rows and
    lengths). ``token`` names the dictionary stream a batch came from
    (DictionaryUnifier): the same token means prefix-compatible
    dictionaries, so concatenation and joins need no remap."""

    indices: torch.Tensor              # int32[capacity], padding rows 0
    values: torch.Tensor               # [k] or [k, width]
    lengths: Optional[torch.Tensor] = None   # int32[k], strings only
    token: Optional[str] = None

    @property
    def k(self) -> int:
        return int(self.values.shape[0])


@dataclass(frozen=True)
class EncSpec:
    """The shape of one column's DictEncoding that the rewrites key on."""
    ordinal: int
    dtype: DType
    k: int
    width: int = 0                    # string matrix width; 0 otherwise


class EncView:
    """One encoding as the evaluation sees it: the index vector plus the
    dictionary as a ColV over ``k`` all-valid rows (dictionaries hold no
    nulls; a null row is a null index)."""

    def __init__(self, spec: EncSpec, enc: DictEncoding):
        from spark_rapids_tpu_torch.exprs.core import ColV
        self.spec = spec
        self.indices = enc.indices
        self.values = ColV(spec.dtype, enc.values,
                           torch.ones(spec.k, dtype=torch.bool,
                                      device=enc.values.device),
                           enc.lengths)


def enc_specs_of(batch) -> Tuple[EncSpec, ...]:
    """EncSpecs of every column of ``batch`` that still carries its
    dictionary encoding (only useful ones: k below the row capacity)."""
    specs = []
    for i, c in enumerate(batch.columns):
        e = c.encoding
        if e is None or e.k >= batch.capacity:
            continue
        width = int(e.values.shape[1]) if e.values.dim() > 1 else 0
        specs.append(EncSpec(i, c.dtype, e.k, width))
    return tuple(specs)


def enc_views(batch, specs) -> Dict[int, EncView]:
    """The EncViews of the named encodings, by column ordinal."""
    return {s.ordinal: EncView(s, batch.columns[s.ordinal].encoding)
            for s in specs}


def dictionary_is_unique(values: np.ndarray,
                         lengths: Optional[np.ndarray] = None) -> bool:
    """The encoded domain equates rows by dictionary INDEX, which is sound
    only when the dictionary's values are pairwise distinct. Parquet and
    unifier dictionaries are; a user's DictionaryArray may not be."""
    if values.ndim > 1:
        rows = np.concatenate(
            [values, np.zeros((len(values), 1), values.dtype)
             if lengths is None else lengths[:, None].astype(values.dtype)],
            axis=1)
        return len(np.unique(rows, axis=0)) == len(rows)
    return len(np.unique(values)) == len(values)


def field_token(schema, i: int) -> Optional[str]:
    meta = schema.field(i).metadata
    if meta and DICT_TOKEN_META in meta:
        return meta[DICT_TOKEN_META].decode()
    return None


# ---------------------------------------------------------------------------
# host-side dictionary unification (per scan)
# ---------------------------------------------------------------------------
class DictionaryUnifier:
    """Grow one dictionary per column across a scan's row groups and files.

    Each row group's local dictionary is remapped into the column's global
    dictionary (append-only, so earlier batches' indices stay valid: the
    dictionaries of two batches with the same token are prefix-compatible).
    The remap is a small lookup table and one integer gather per chunk.

    Float dictionaries dedupe by BIT PATTERN, not ``==``: -0.0 and 0.0 are
    distinct entries and equal-bit NaNs share one; values are stored as
    numpy scalars so the rebuilt dictionary is bit-exact."""

    def __init__(self):
        self._cols: Dict[str, Tuple[str, Dict[Any, int], List[Any]]] = {}

    def _state(self, name: str):
        st = self._cols.get(name)
        if st is None:
            st = (uuid.uuid4().hex, {}, [])
            self._cols[name] = st
        return st

    def token_of(self, name: str) -> Optional[str]:
        st = self._cols.get(name)
        return st[0] if st else None

    def unify(self, name: str, arr):
        """Remap one chunk's dictionary into the column's global
        dictionary; returns the remapped array and the column token."""
        import pyarrow as pa
        token, index_of, values = self._state(name)
        dict_type = arr.dictionary.type
        bitwise = pa.types.is_floating(dict_type)
        np_t = dict_type.to_pandas_dtype() if bitwise else None
        if bitwise and arr.dictionary.null_count == 0:
            local = list(np.asarray(arr.dictionary))
            keys = [v.tobytes() for v in local]
        elif bitwise:
            # null dictionary entries (the page reader makes none): keep
            # the byte-key domain so one column never mixes key kinds
            local = [None if v is None else np.dtype(np_t).type(v)
                     for v in arr.dictionary.to_pylist()]
            keys = [None if v is None else v.tobytes() for v in local]
        else:
            local = arr.dictionary.to_pylist()
            keys = local
        lut = np.empty(len(local), dtype=np.int32)
        for j, (key, v) in enumerate(zip(keys, local)):
            gi = index_of.get(key)
            if gi is None:
                gi = len(values)
                index_of[key] = gi
                values.append(v)
            lut[j] = gi
        k = len(values)
        idx_t = (pa.int8() if k <= 127 else
                 pa.int16() if k <= 0x7FFF else pa.int32())
        local_idx = np.asarray(arr.indices.fill_null(0)).astype(np.int64)
        remapped = lut[local_idx].astype(idx_t.to_pandas_dtype())
        mask = (None if arr.indices.null_count == 0
                else np.asarray(arr.indices.is_null()))
        indices = pa.array(remapped, type=idx_t, mask=mask)
        if bitwise and all(v is not None for v in values):
            global_vals = pa.array(np.array(values, dtype=np_t))
        else:
            global_vals = pa.array(values, type=dict_type)
        return pa.DictionaryArray.from_arrays(indices, global_vals), token


def with_dict_tokens(table, tokens: Dict[str, str]):
    """Stamp dictionary tokens into the table's field metadata so they
    survive slicing and reach the upload without a side channel."""
    import pyarrow as pa
    if not tokens:
        return table
    fields = []
    for f in table.schema:
        if f.name in tokens:
            meta = dict(f.metadata or {})
            meta[DICT_TOKEN_META] = tokens[f.name].encode()
            fields.append(f.with_metadata(meta))
        else:
            fields.append(f)
    return pa.table(list(table.columns), schema=pa.schema(fields))
