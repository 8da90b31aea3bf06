"""String predicates with a constant pattern (``rlike`` among them),
``substring``, ``substring_index``, ``split(str, regex)[i]``,
``regexp_replace``, ``upper``/``lower``/``initcap`` (ASCII letters only,
as the JAX package's device path), ``length`` (characters), the trims,
``concat``, the pads, ``locate``/``instr`` and ``replace`` (the JAX
package's ``exprs/strings.py``), over the byte-matrix layout through
``ops/strings.py``. A literal operand
broadcasts to a column with ``bk.as_column`` (the JAX package's
``_as_column``). On the CPU engine (``EvalCtx.host_engine``) a general
LIKE, ``rlike``, ``regexp_replace`` and ``split`` run Python's ``re`` row
at a time over the decoded strings, as the JAX package's numpy engine
does; everything else runs the same kernels on both engines."""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType, string_width_bucket
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
        match = self.host_match(col) if ctx.host_engine else None
        if match is None:
            match = self.do_match(col)
        return ColV(DType.BOOLEAN, match, col.validity)

    def do_match(self, col: ColV) -> torch.Tensor:
        raise NotImplementedError

    def host_match(self, col: ColV) -> Optional[torch.Tensor]:
        """The CPU engine's match where it differs from ``do_match``."""
        return None


def _host_strings(col: ColV) -> Iterator[str]:
    """Each row of a CPU string column, decoded (the JAX numpy engine's
    ``errors="replace"`` decode)."""
    data, lengths = col.data.numpy(), col.lengths.numpy()
    for i in range(data.shape[0]):
        yield bytes(data[i, :lengths[i]]).decode("utf-8", errors="replace")


def _host_bools(col: ColV, fn) -> torch.Tensor:
    return torch.from_numpy(np.fromiter((fn(s) for s in _host_strings(col)),
                                        dtype=np.bool_,
                                        count=col.data.shape[0]))


def _host_string_column(values, width: int, validity) -> ColV:
    """Python strings (cut at ``width`` bytes) -> a CPU string ColV of
    that width."""
    n = len(values)
    out = np.zeros((n, width), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, v in enumerate(values):
        b = v.encode()[:width]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return ColV(DType.STRING, torch.from_numpy(out), validity,
                torch.from_numpy(lens))


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
    def to_regex(pattern: str) -> str:
        """The Python regex of a LIKE pattern (the JAX package's CPU
        engine's): '%' -> '.*', '_' -> '.', a backslash escapes the next
        character, anchored at both ends (``\\Z``: '$' would also match
        before a trailing newline)."""
        out = []
        i = 0
        while i < len(pattern):
            ch = pattern[i]
            if ch == "\\" and i + 1 < len(pattern):
                out.append(re.escape(pattern[i + 1]))
                i += 2
                continue
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(re.escape(ch))
            i += 1
        return "^" + "".join(out) + r"\Z"

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

    def host_match(self, col):
        pat = self.pattern.decode("utf-8")
        if Like.classify(pat) is not None:
            return None
        rx = re.compile(Like.to_regex(pat), re.DOTALL)
        return _host_bools(col, lambda s: rx.match(s) is not None)

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
        if ctx.host_engine:
            # Java's Pattern.split ignores capture groups; Python's
            # interleaves them: (x) becomes (?:x)
            rx = re.compile(re.sub(r"(?<!\\)\((?!\?)", "(?:", pat.decode()))
            parts = [rx.split(s) for s in _host_strings(v)]
            exists = torch.tensor([self.ordinal < len(p) for p in parts],
                                  dtype=torch.bool)
            field = _host_string_column(
                [p[self.ordinal] if self.ordinal < len(p) else ""
                 for p in parts], v.data.shape[-1], v.validity & exists)
            return field
        sel, span_len = regex_spans(pat.decode(), v.data, v.lengths)
        data, lengths, exists = sk.split_field(v.data, v.lengths, sel,
                                               span_len, self.ordinal)
        return ColV(DType.STRING, data, v.validity & exists, lengths)


@dataclass(frozen=True)
class Upper(Expression):
    c: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(DType.STRING, sk.upper_ascii(v.data), v.validity,
                    v.lengths, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Lower(Expression):
    c: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(DType.STRING, sk.lower_ascii(v.data), v.validity,
                    v.lengths, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Length(Expression):
    """The length in characters (UTF-8 starts), as Spark's length()."""
    c: Expression

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(DType.INT, sk.char_lengths(v.data, v.lengths), v.validity,
                    is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Concat(Expression):
    """concat(...): null where any input is; as wide as the inputs
    together (their width bucket), cut at the session's string width in
    bytes."""
    exprs: Tuple

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        vals = [bk.as_column(e.eval(ctx), ctx.capacity) for e in self.exprs]
        out = vals[0]
        for v in vals[1:]:
            width = string_width_bucket(out.data.shape[-1] + v.data.shape[-1],
                                        ctx.string_max_bytes)
            data, lengths = sk.concat2(out.data, out.lengths, v.data,
                                       v.lengths, width)
            out = ColV(DType.STRING, data, out.validity & v.validity, lengths)
        return out


class _TrimBase(Expression):
    """trim/ltrim/rtrim with an optional literal set of ASCII trim
    characters (a space by default)."""
    left = True
    right = True

    def dtype(self) -> DType:
        return DType.STRING

    def _trim_chars(self) -> bytes:
        if self.trim is None:
            return b" "
        if not isinstance(self.trim, Literal) or self.trim.value is None:
            raise TypeError(f"{type(self).__name__} requires a literal "
                            f"trim-character set")
        chars = str(self.trim.value).encode("utf-8")
        if any(b > 127 for b in chars):
            raise TypeError(f"{type(self).__name__} trim-character set must "
                            f"be ASCII (got {self.trim.value!r})")
        return chars

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        start, new_len = sk.trim_bounds(v.data, v.lengths, self.left,
                                        self.right, self._trim_chars())
        data, lengths = sk.substring(v.data, v.lengths, start, new_len)
        return ColV(DType.STRING, data, v.validity, lengths)


@dataclass(frozen=True)
class StringTrim(_TrimBase):
    c: Expression
    trim: Optional[Expression] = None


@dataclass(frozen=True)
class StringTrimLeft(_TrimBase):
    c: Expression
    trim: Optional[Expression] = None
    right = False


@dataclass(frozen=True)
class StringTrimRight(_TrimBase):
    c: Expression
    trim: Optional[Expression] = None
    left = False


@dataclass(frozen=True)
class StringLocate(Expression):
    """locate(substr, str, start) with a literal substring and start: the
    1-based character position of the first occurrence at or after
    ``start``, 0 where there is none. A null start gives 0, a null
    substring null, a start below 1 gives 0 and an empty substring 1."""
    sub: Expression
    c: Expression
    start: Expression

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        if not isinstance(self.start, Literal):
            raise TypeError("locate requires a literal start position")
        needle = _literal_utf8(self.sub, "locate substring")
        cap, device = ctx.capacity, ctx.device
        if self.start.value is None:
            return ColV(DType.INT, torch.zeros(cap, dtype=torch.int32,
                                               device=device),
                        torch.ones(cap, dtype=torch.bool, device=device))
        if needle is None:
            return all_null(DType.INT, ctx, 0)
        start1 = int(self.start.value)
        if start1 < 1:
            data = torch.zeros(cap, dtype=torch.int32, device=device)
        elif len(needle) == 0:
            data = torch.ones(cap, dtype=torch.int32, device=device)
        else:
            data = sk.locate(v.data, v.lengths, needle, start1)
        return ColV(DType.INT, data, v.validity)


@dataclass(frozen=True)
class StringReplace(Expression):
    """replace(str, search, replace) with literal operands: a null operand
    gives nulls, an empty search the input; the result is cut at the
    session's string width."""
    c: Expression
    search: Expression
    replace: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        search = _literal_utf8(self.search, "replace search")
        repl = _literal_utf8(self.replace, "replace replacement")
        if search is None or repl is None:
            return all_null(DType.STRING, ctx, v.data.shape[-1])
        if len(search) == 0:
            return v
        data, lengths = sk.replace_const(v.data, v.lengths, search, repl,
                                         ctx.string_max_bytes)
        return ColV(DType.STRING, data, v.validity, lengths)


class _PadBase(Expression):
    """lpad/rpad(str, len, pad) with a literal length and pad, in
    characters. The output is as wide as the input, or as the surviving
    prefix and the worst-case fill need, up to the session's string
    width."""
    side = ""

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        if not isinstance(self.length, Literal):
            raise TypeError("pad length must be a literal")
        pad_bytes = _literal_utf8(self.pad, "pad string")
        width = v.data.shape[-1]
        if self.length.value is None or pad_bytes is None:
            return all_null(DType.STRING, ctx, width)
        target = max(int(self.length.value), 0)
        bound = (min(width, 4 * target)
                 + sk.pad_fill_total_bytes(pad_bytes, target))
        width_out = max(width, min(bound, ctx.string_max_bytes))
        data, lengths = sk.pad(v.data, v.lengths, target, pad_bytes,
                               self.side, width_out)
        return ColV(DType.STRING, data, v.validity, lengths)


@dataclass(frozen=True)
class StringLPad(_PadBase):
    c: Expression
    length: Expression
    pad: Expression
    side = "left"


@dataclass(frozen=True)
class StringRPad(_PadBase):
    c: Expression
    length: Expression
    pad: Expression
    side = "right"


@dataclass(frozen=True)
class InitCap(Expression):
    """initcap: the letter after each space upper case, every other letter
    lower case (Spark's ``toLowerCase().toTitleCase()``; ASCII letters
    only, as ``upper``/``lower``)."""
    c: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(DType.STRING, sk.initcap(v.data), v.validity, v.lengths,
                    is_scalar=v.is_scalar)


@dataclass(frozen=True)
class RLike(_ConstPatternPredicate):
    """str RLIKE pattern: Java's ``Pattern.find``, a match anywhere, by the
    byte DFA with a leading any-byte loop (the JAX package's device path:
    '.' consumes one byte)."""
    c: Expression
    p: Expression

    def host_match(self, col):
        rx = re.compile(self.pattern.decode("utf-8"))
        return _host_bools(col, lambda s: rx.search(s) is not None)

    def do_match(self, col):
        dfa = rk.compile_dfa(self.pattern.decode("utf-8"), search=True)
        return rk.dfa_match(dfa, col.data, col.lengths, search=True)


@dataclass(frozen=True)
class RegExpReplace(Expression):
    """regexp_replace(str, pattern, replacement) with a literal pattern and
    replacement (no group references): the leftmost non-overlapping
    matches, each the longest from its start (the byte DFA's span search,
    as the JAX device path finds them), each replaced whole; the result is
    cut at the session's string width. A null pattern or replacement gives
    nulls; a pattern that can match the empty string is refused."""
    c: Expression
    pattern_e: Expression
    replacement: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        pat = _literal_utf8(self.pattern_e, "regexp pattern")
        repl = _literal_utf8(self.replacement, "regexp replacement")
        if pat is None or repl is None:
            return all_null(DType.STRING, ctx, v.data.shape[-1])
        if ctx.host_engine:
            rx = re.compile(pat.decode())
            return _host_string_column(
                [rx.sub(repl.decode(), s) for s in _host_strings(v)],
                ctx.string_max_bytes, v.validity)
        sel, span_len = regex_spans(pat.decode(), v.data, v.lengths)
        inside = sk.spans_inside(sel, span_len)
        pos = torch.arange(v.data.shape[-1], device=v.data.device)
        plain = ((pos[None, :] < v.lengths[:, None]) & ~(sel | inside)) \
            .to(torch.int32)
        data, lengths = sk.reassemble_spans(v.data, sel, plain, repl,
                                            ctx.string_max_bytes)
        return ColV(DType.STRING, data, v.validity, lengths)
