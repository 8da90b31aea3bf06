"""String predicates with a constant pattern, ``substring``,
``substring_index`` and ``split(str, regex)[i]`` (the part of the JAX
package's ``exprs/strings.py`` the TPC-H and TPCx-BB queries use), over
the byte-matrix layout through ``ops/strings.py``. A literal operand
broadcasts to a column with ``bk.as_column`` (the JAX package's
``_as_column``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops import regex as rk
from spark_rapids_tpu_torch.ops import strings as sk


class _ConstPatternPredicate(Expression):
    """StartsWith, EndsWith, Contains and Like: the pattern must be a
    non-null literal."""

    def dtype(self) -> DType:
        return DType.BOOLEAN

    @property
    def pattern(self) -> bytes:
        lit = self.children[1]
        if not isinstance(lit, Literal) or lit.value is None:
            raise TypeError(f"{type(self).__name__} requires a non-null "
                            f"literal pattern")
        return str(lit.value).encode("utf-8")

    def eval(self, ctx: EvalCtx) -> ColV:
        col = bk.as_column(self.children[0].eval(ctx), ctx.capacity)
        return ColV(DType.BOOLEAN, self.do_match(col), col.validity)

    def do_match(self, col: ColV) -> torch.Tensor:
        raise NotImplementedError


@dataclass(frozen=True)
class StartsWith(_ConstPatternPredicate):
    c: Expression
    p: Expression

    def do_match(self, col):
        return sk.starts_with(col.data, col.lengths, self.pattern)


@dataclass(frozen=True)
class EndsWith(_ConstPatternPredicate):
    c: Expression
    p: Expression

    def do_match(self, col):
        return sk.ends_with(col.data, col.lengths, self.pattern)


@dataclass(frozen=True)
class Contains(_ConstPatternPredicate):
    c: Expression
    p: Expression

    def do_match(self, col):
        return sk.contains(col.data, col.lengths, self.pattern)


@dataclass(frozen=True)
class Like(_ConstPatternPredicate):
    """SQL LIKE with a literal pattern. 'abc', 'abc%', '%abc' and '%abc%'
    (no '_', no inner '%') reduce to the equality, prefix, suffix and
    substring kernels; any other pattern runs the byte DFA (the JAX
    package's device path, byte semantics: '_' consumes one byte)."""
    c: Expression
    p: Expression
    escape: str = "\\"

    @staticmethod
    def classify(pattern: str) -> Optional[Tuple[str, str]]:
        """(kind, needle), kind one of exact, prefix, suffix, contains; or
        None when the pattern needs the DFA."""
        if "_" in pattern:
            return None
        body = pattern.strip("%")
        if "%" in body or "\\" in body:
            return None
        starts, ends = pattern.startswith("%"), pattern.endswith("%")
        if starts and ends:
            return ("contains", body)
        if ends:
            return ("prefix", body)
        if starts:
            return ("suffix", body)
        return ("exact", body)

    def do_match(self, col):
        pat = self.pattern.decode("utf-8")
        kind_needle = Like.classify(pat)
        if kind_needle is None:
            dfa = rk.compile_dfa(rk.like_to_regex(pat, self.escape))
            return rk.dfa_match(dfa, col.data, col.lengths)
        kind, needle = kind_needle
        nb = needle.encode("utf-8")
        if kind == "contains":
            return sk.contains(col.data, col.lengths, nb)
        if kind == "prefix":
            return sk.starts_with(col.data, col.lengths, nb)
        if kind == "suffix":
            return sk.ends_with(col.data, col.lengths, nb)
        return sk.starts_with(col.data, col.lengths, nb) \
            & (col.lengths == len(nb))


@dataclass(frozen=True)
class Substring(Expression):
    """substring(str, pos, len) on character positions, Spark's rules: pos
    is 1-based, 0 acts as 1, a negative pos counts from the end; byte
    offsets come from the characters' UTF-8 starts."""
    c: Expression
    pos: Expression
    length: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        pos, ln = self.pos.eval(ctx), self.length.eval(ctx)
        nchars = sk.char_lengths(v.data, v.lengths)
        p = pos.data.to(torch.int32)
        n = ln.data.to(torch.int32).clamp(min=0)
        start_char = torch.where(p > 0, p - 1,
                                 torch.where(p == 0, 0,
                                             (nchars + p).clamp(min=0)))
        start_char = torch.minimum(start_char, nchars)
        end_char = torch.minimum(start_char + n, nchars)
        start_b = sk.char_to_byte_offset(v.data, v.lengths, start_char)
        end_b = sk.char_to_byte_offset(v.data, v.lengths, end_char)
        data, lengths = sk.substring(v.data, v.lengths, start_b,
                                     end_b - start_b)
        return ColV(DType.STRING, data,
                    v.validity & pos.validity & ln.validity, lengths)


def _literal_utf8(e: Expression, what: str) -> Optional[bytes]:
    """A string literal operand's bytes (None for a null literal)."""
    if not isinstance(e, Literal):
        raise TypeError(f"{what} must be a literal")
    return None if e.value is None else str(e.value).encode("utf-8")


def all_null(dtype: DType, ctx: EvalCtx, width: int) -> ColV:
    """A column of ``ctx.capacity`` nulls (strings ``width`` bytes wide)."""
    cap, device = ctx.capacity, ctx.device
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    if dtype is DType.STRING:
        return ColV(dtype, torch.zeros((cap, width), dtype=torch.uint8,
                                       device=device), valid,
                    torch.zeros(cap, dtype=torch.int32, device=device))
    return ColV(dtype, torch.zeros(cap, dtype=dtype.torch_dtype(),
                                   device=device), valid)


@dataclass(frozen=True)
class SubstringIndex(Expression):
    """substring_index(str, delim, count) with a literal delimiter and
    count."""
    c: Expression
    delim: Expression
    count: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        if not isinstance(self.count, Literal):
            raise TypeError("substring_index count must be a literal")
        delim = _literal_utf8(self.delim, "substring_index delimiter")
        if self.count.value is None or delim is None:
            return all_null(DType.STRING, ctx, v.data.shape[-1])
        data, lengths = sk.substring_index(v.data, v.lengths, delim,
                                           int(self.count.value))
        return ColV(DType.STRING, data, v.validity, lengths)


def regex_spans(pattern: str, data: torch.Tensor, lengths: torch.Tensor):
    """The leftmost non-overlapping matches of ``pattern`` -> (sel,
    span_len): their starts and lengths."""
    dfa = rk.compile_dfa(pattern)
    if dfa.accept[dfa.start]:
        raise TypeError(f"pattern {pattern!r} can match the empty string; "
                        f"zero-length matches are not supported")
    match_len = rk.dfa_find_spans(dfa, data, lengths)
    sel = rk.regex_greedy_spans(match_len, lengths)
    return sel, torch.where(sel, match_len.clamp(min=0), 0).to(torch.int32)


@dataclass(frozen=True)
class StringSplit(Expression):
    """split(str, regex): an array, which only ``GetArrayItem`` reads
    (split(x, d)[i]); ARRAY is not a column type."""
    c: Expression
    pattern_e: Expression
    limit: int = -1

    def dtype(self) -> DType:
        raise TypeError("split() produces an array; index it with [i] / "
                        "getItem(i) (ARRAY is not a column type)")

    def element_type(self) -> DType:
        return DType.STRING


@dataclass(frozen=True)
class GetArrayItem(Expression):
    """array[i] with a literal ordinal, over a created array (the item
    itself) or a split (field i of the split, cut at the regex matches by
    the byte DFA; the array never exists). An ordinal past the end is
    null."""
    child: Expression
    ordinal: int

    def dtype(self) -> DType:
        from spark_rapids_tpu_torch.exprs.generators import CreateArray
        if isinstance(self.child, CreateArray):
            return self.child.element_type()
        if isinstance(self.child, StringSplit):
            return DType.STRING
        raise TypeError("GetArrayItem supports created arrays and split() "
                        "results only")

    def nullable(self) -> bool:
        return True

    def eval(self, ctx: EvalCtx) -> ColV:
        from spark_rapids_tpu_torch.exprs.generators import CreateArray
        if isinstance(self.child, CreateArray):
            items = self.child.items
            if not 0 <= self.ordinal < len(items):
                return all_null(self.child.element_type(), ctx,
                                ctx.string_max_bytes)
            return items[self.ordinal].eval(ctx)
        split: StringSplit = self.child
        v = bk.as_column(split.c.eval(ctx), ctx.capacity)
        pat = _literal_utf8(split.pattern_e, "split pattern")
        if pat is None or self.ordinal < 0:
            return all_null(DType.STRING, ctx, v.data.shape[-1])
        sel, span_len = regex_spans(pat.decode(), v.data, v.lengths)
        data, lengths, exists = sk.split_field(v.data, v.lengths, sel,
                                               span_len, self.ordinal)
        return ColV(DType.STRING, data, v.validity & exists, lengths)
