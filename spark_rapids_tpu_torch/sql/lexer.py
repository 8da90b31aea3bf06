"""SQL tokenizer.

Reference role: the front end of the path the reference gets for free from
Spark's Catalyst parser (its benchmark suites feed raw SQL,
integration_tests/.../tpcds/TpcdsLikeSpark.scala:30). Hand-written: the
environment ships no SQL parser dependency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class Token:
    kind: str          # KEYWORD | IDENT | NUMBER | STRING | OP | EOF
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "case", "when", "then", "else", "end", "join", "inner", "left",
    "right", "full", "outer", "cross", "semi", "anti", "on", "distinct",
    "asc", "desc", "union", "all", "date", "interval", "extract", "cast",
    "substring", "true", "false", "for", "over", "partition", "rows",
    "unbounded", "preceding", "following", "current", "row", "rollup",
    "cube", "range", "with", "intersect", "except",
}

#: window/grouping words are NON-reserved (Spark keeps them usable as
#: identifiers): the parser falls back to identifier where one is expected
SOFT_KEYWORDS = {"over", "partition", "rows", "unbounded", "preceding",
                 "following", "current", "row", "rollup", "cube", "range"}

_OPS = ["<>", "!=", ">=", "<=", "||", "=", "<", ">", "(", ")", ",", "+",
        "-", "*", "/", ".", "%"]


class SqlError(ValueError):
    pass


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and text[i + 1] == "-":  # line comment
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":  # escaped quote
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            if j >= n:
                raise SqlError(f"unterminated string literal at {i}")
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (text[j].isdigit() or (text[j] == "." and not seen_dot)):
                seen_dot |= text[j] == "."
                j += 1
            # only treat '.' as part of the number when followed by a digit
            # (9. is valid SQL but 9.x is a qualified ref — not for numbers)
            out.append(Token("NUMBER", text[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            low = word.lower()
            out.append(Token("KEYWORD" if low in KEYWORDS else "IDENT",
                             low if low in KEYWORDS else word, i))
            i = j
            continue
        for op in _OPS:
            if text.startswith(op, i):
                out.append(Token("OP", op, i))
                i += len(op)
                break
        else:
            raise SqlError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", "", n))
    return out
