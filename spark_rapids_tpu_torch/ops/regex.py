"""Regex matching as a DFA over the byte matrix (the JAX package's
``ops/regex.py``: its pattern compiler, copied, ``dfa_match`` anchored
and in search mode, and the span search ``dfa_find_spans`` /
``regex_greedy_spans`` that split() and regexp_replace() cut at).

Patterns are plan-time literals, so compilation runs on the host: the regex
subset parses to a Thompson NFA, subset construction gives a dense DFA
transition table ``[n_states, 256]``, and matching is one table gather per
byte column of the ``[n, W]`` byte matrix, W dependent steps with no
data-dependent control flow.

Supported syntax: literals, ``.``, classes ``[a-z0-9_]`` with ranges and
negation, the ``*`` ``+`` ``?`` quantifiers, alternation ``|`` and groups
``()``; a match is anchored at the start. Matching is byte by byte: ``.``
consumes one byte, so a multibyte UTF-8 character under ``.`` or LIKE's
``_`` differs from Spark (ASCII scope, as in the JAX package).
"""
from __future__ import annotations

import functools
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

_EPS = -1


class RegexError(ValueError):
    pass


class _Nfa:
    def __init__(self):
        self.edges: List[List[Tuple[int, Optional[Set[int]]]]] = []

    def state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, a: int, b: int, chars: Optional[Set[int]]) -> None:
        self.edges[a].append((b, chars))


def _parse(pattern: str):
    """pattern -> (nfa, start, accept) via recursive descent."""
    nfa = _Nfa()
    pos = [0]
    data = pattern

    def peek():
        return data[pos[0]] if pos[0] < len(data) else None

    def take():
        c = data[pos[0]]
        pos[0] += 1
        return c

    def parse_alt():
        s, e = parse_seq()
        while peek() == "|":
            take()
            s2, e2 = parse_seq()
            ns, ne = nfa.state(), nfa.state()
            nfa.add(ns, s, None)
            nfa.add(ns, s2, None)
            nfa.add(e, ne, None)
            nfa.add(e2, ne, None)
            s, e = ns, ne
        return s, e

    def parse_seq():
        s = nfa.state()
        e = s
        while peek() is not None and peek() not in "|)":
            s2, e2 = parse_piece()
            nfa.add(e, s2, None)
            e = e2
        return s, e

    def parse_piece():
        s, e = parse_atom()
        while peek() in ("*", "+", "?"):
            q = take()
            ns, ne = nfa.state(), nfa.state()
            nfa.add(ns, s, None)
            nfa.add(e, ne, None)
            if q in ("*", "?"):
                nfa.add(ns, ne, None)
            if q in ("*", "+"):
                nfa.add(e, s, None)
            s, e = ns, ne
        return s, e

    def parse_atom():
        c = peek()
        if c is None:
            raise RegexError(f"unexpected end of pattern {data!r}")
        if c == "(":
            take()
            s, e = parse_alt()
            if peek() != ")":
                raise RegexError(f"unbalanced '(' in {data!r}")
            take()
            return s, e
        if c == "[":
            take()
            chars = _parse_class(take, peek)
            return _char_edge(chars)
        if c == ".":
            take()
            return _char_edge(set(range(256)))
        if c == "\\":
            take()
            nxt = take() if peek() is not None else None
            if nxt is None:
                raise RegexError(f"dangling escape in {data!r}")
            cls = _ESCAPES.get(nxt)
            return _char_edge(cls if cls is not None
                              else {ord(nxt) & 0xFF})
        if c in ")|*+?":
            raise RegexError(f"unexpected {c!r} in {data!r}")
        if c in "{}^$":
            # syntax Java regex gives meaning to but this subset does not
            # implement — reject rather than silently matching literally
            raise RegexError(f"unsupported regex syntax {c!r} in {data!r} "
                             f"(escape it to match literally)")
        take()
        bs = c.encode("utf-8")
        # multibyte literal: its bytes match in SEQUENCE (chained edges)
        s = nfa.state()
        e = s
        for b in bs:
            s2, e2 = _char_edge({b})
            nfa.add(e, s2, None)
            e = e2
        return s, e

    def _char_edge(chars: Set[int]):
        s, e = nfa.state(), nfa.state()
        nfa.add(s, e, chars)
        return s, e

    def _parse_class(take, peek):
        neg = False
        if peek() == "^":
            take()
            neg = True
        chars: Set[int] = set()
        prev: Optional[int] = None
        while peek() is not None and peek() != "]":
            c = take()
            if c == "\\" and peek() is not None:
                c2 = take()
                cls = _ESCAPES.get(c2)
                if cls is not None:
                    chars |= cls
                    prev = None
                    continue
                c = c2
            if c == "-" and prev is not None and peek() not in (None, "]"):
                hi = ord(take())
                chars |= set(range(prev, hi + 1))
                prev = None
                continue
            b = ord(c)
            if b > 0xFF:
                raise RegexError("non-ASCII literal in character class")
            chars.add(b)
            prev = b
        if peek() != "]":
            raise RegexError(f"unbalanced '[' in {data!r}")
        take()
        return set(range(256)) - chars if neg else chars

    s, e = parse_alt()
    if pos[0] != len(data):
        raise RegexError(f"trailing input at {pos[0]} in {data!r}")
    return nfa, s, e


_ESCAPES: Dict[str, Set[int]] = {
    "d": set(range(ord("0"), ord("9") + 1)),
    "w": (set(range(ord("a"), ord("z") + 1))
          | set(range(ord("A"), ord("Z") + 1))
          | set(range(ord("0"), ord("9") + 1)) | {ord("_")}),
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C},
}
_ESCAPES["D"] = set(range(256)) - _ESCAPES["d"]
_ESCAPES["W"] = set(range(256)) - _ESCAPES["w"]
_ESCAPES["S"] = set(range(256)) - _ESCAPES["s"]


class Dfa:
    """Dense DFA: trans [n_states, 256] int32 (state 0 = dead sink),
    accept [n_states] bool, start state index."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray, start: int):
        self.trans = trans
        self.accept = accept
        self.start = start

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


@functools.lru_cache(maxsize=256)
def compile_dfa(pattern: str, search: bool = False,
                max_states: int = 512) -> Dfa:
    """Regex subset -> DFA. ``search=True`` allows a match to start anywhere
    (prepends an any-byte loop — RLike semantics); otherwise the match is
    anchored at the start (LIKE lowering adds its own .* where needed).
    Kept per pattern: the plan layer's tagging and every batch's match
    read the same DFA, which no caller changes."""
    nfa, start, accept = _parse(pattern)
    if search:
        ns = nfa.state()
        nfa.add(ns, ns, set(range(256)))
        nfa.add(ns, start, None)
        start = ns

    def eps_closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for dst, chars in nfa.edges[s]:
                if chars is None and dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return frozenset(out)

    start_set = eps_closure(frozenset([start]))
    # state 0 is the dead sink
    ids: Dict[FrozenSet[int], int] = {frozenset(): 0, start_set: 1}
    acc: List[bool] = [False, accept in start_set]
    row_of: Dict[int, np.ndarray] = {0: np.zeros(256, np.int32)}
    work = [start_set]
    while work:
        cur = work.pop()
        row = np.zeros(256, np.int32)
        by_byte: Dict[int, Set[int]] = {}
        for s in cur:
            for dst, chars in nfa.edges[s]:
                if chars is None:
                    continue
                for b in chars:
                    by_byte.setdefault(b, set()).add(dst)
        for b, dsts in by_byte.items():
            t = eps_closure(frozenset(dsts))
            if t not in ids:
                if len(ids) >= max_states:
                    raise RegexError(
                        f"pattern {pattern!r} exceeds {max_states} DFA "
                        f"states")
                ids[t] = len(ids)
                acc.append(accept in t)
                work.append(t)
            row[b] = ids[t]
        row_of[ids[cur]] = row
    table = np.stack([row_of[i] for i in range(len(ids))])
    return Dfa(table, np.asarray(acc, bool), 1)


def like_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE pattern -> this engine's regex (anchored by construction)."""
    out = []
    i = 0
    special = set(".[]()*+?|\\^${}")
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            out.append("\\" + nxt if nxt in special else nxt)
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif c in special:
            out.append("\\" + c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------
def dfa_match(dfa: Dfa, data, lengths, search: bool = False):
    """bool[n]: each row (its first ``length`` bytes) matches the DFA.
    Anchored, the state reached at the row's length is accepting (a match
    of the whole row). With ``search`` any state within the row that is
    accepting counts: with a DFA compiled with ``search=True`` that is a
    match anywhere (RLIKE)."""
    n, width = data.shape
    device = data.device
    flat = torch.from_numpy(dfa.trans.reshape(-1).astype(np.int64)) \
        .to(device)
    accept = torch.from_numpy(dfa.accept).to(device)
    state = torch.full((n,), dfa.start, dtype=torch.int64, device=device)
    hit = accept[state] & (True if search else lengths == 0)
    for j in range(width):
        state = flat[state * 256 + data[:, j].to(torch.int64)]
        hit |= accept[state] & ((lengths >= j + 1) if search
                                else (lengths == j + 1))
    return hit


class _LiveCycle(Exception):
    pass


def max_match_steps(dfa: Dfa, width: int) -> int:
    """How many bytes one anchored run can consume before it dies: the
    longest path from the start through live states (not the dead sink
    0), or ``width`` when a live cycle is reachable (or the path is too
    deep to walk). A run past that many bytes is in the dead state, so
    scanning further changes nothing."""
    live = [np.unique(row[row != 0]) for row in dfa.trans]
    depth: Dict[int, int] = {}
    on_path: Set[int] = set()

    def longest(s: int) -> int:
        if s in on_path:
            raise _LiveCycle
        if s not in depth:
            on_path.add(s)
            depth[s] = 1 + max((longest(int(t)) for t in live[s]),
                               default=-1)
            on_path.discard(s)
        return depth[s]

    try:
        return min(width, longest(dfa.start))
    except (_LiveCycle, RecursionError):
        return width


def dfa_find_spans(dfa: Dfa, data, lengths):
    """The longest match of the anchored DFA starting at every byte
    position -> ``match_len[n, W]`` int32 (-1: no match there). One DFA
    run per start position: step j moves every run one byte (the run at p
    reads byte p + j), so a step is one table gather over the
    ``[n, W - j]`` runs still inside the row width; steps stop after
    ``max_match_steps``."""
    n, width = data.shape
    device = data.device
    flat = torch.from_numpy(dfa.trans.reshape(-1).astype(np.int64)) \
        .to(device)
    accept = torch.from_numpy(dfa.accept).to(device)
    pos = torch.arange(width, device=device)
    valid_start = pos[None, :] <= lengths[:, None]
    state = torch.where(valid_start, dfa.start, 0)
    best = torch.where(valid_start & bool(dfa.accept[dfa.start]), 0, -1) \
        .to(torch.int32)
    for j in range(max_match_steps(dfa, width)):
        live = width - j
        byte = data[:, j:].to(torch.int64)
        in_range = (pos[None, :live] + j) < lengths[:, None]
        state = torch.where(in_range, flat[state[:, :live] * 256 + byte], 0)
        best[:, :live] = torch.where(accept[state] & in_range, j + 1,
                                     best[:, :live])
    return best


def regex_greedy_spans(match_len, lengths):
    """Leftmost non-overlapping spans over the per-position match lengths
    (Java's Matcher.find() order) -> ``sel[n, W]``, the span starts; a
    zero-length match advances by one byte."""
    n, width = match_len.shape
    sel = torch.zeros((n, width), dtype=torch.bool, device=match_len.device)
    nxt = torch.zeros(n, dtype=torch.int32, device=match_len.device)
    for i in range(width):
        m = match_len[:, i]
        can = (m >= 0) & (nxt <= i) & (lengths >= i)
        sel[:, i] = can
        nxt = torch.where(can, torch.clamp(m + i, min=i + 1), nxt)
    return sel
