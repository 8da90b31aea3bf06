"""Recursive-descent SQL parser with Pratt expression parsing.

Covers the surface the reference exercises through Catalyst for its benchmark
SQL (TpcdsLikeSpark.scala query texts): SELECT lists with aliases and
aggregates, FROM with comma joins / JOIN..ON / derived tables, WHERE with
AND/OR/NOT/BETWEEN/IN/LIKE/IS NULL, EXISTS / IN / scalar subqueries,
GROUP BY / HAVING / ORDER BY / LIMIT, CASE WHEN, EXTRACT, CAST, date and
interval literals with constant folding at plan time.
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.sql import ast as A
from spark_rapids_tpu_torch.sql.lexer import SqlError, Token, tokenize

# binding powers (higher binds tighter)
_BP = {"or": 10, "and": 20,
       "=": 40, "<>": 40, "!=": 40, "<": 40, "<=": 40, ">": 40, ">=": 40,
       "||": 45,
       "+": 50, "-": 50,
       "*": 60, "/": 60, "%": 60}

_AGG_FUNCS = {"sum", "avg", "count", "min", "max", "stddev", "stddev_pop",
              "variance", "var_pop", "first", "last"}


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # ---- token plumbing ----------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in words

    def eat_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.eat_kw(word):
            raise SqlError(f"expected {word.upper()}, got "
                           f"{self.peek().value!r} at {self.peek().pos}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise SqlError(f"expected {op!r}, got {self.peek().value!r} "
                           f"at {self.peek().pos}")

    # ---- statement ---------------------------------------------------------
    def parse_query(self) -> A.Node:
        """SELECT ((UNION [ALL] | INTERSECT | EXCEPT) SELECT)* — the
        set-op chain derived tables and CTE bodies accept
        (TpcdsLikeSpark's multi-channel unions; q14/q38/q87-style
        INTERSECT/EXCEPT). Chains fold LEFT uniformly (standard SQL gives
        INTERSECT higher precedence than UNION/EXCEPT — parenthesize
        mixed chains that rely on it)."""
        q: A.Node = self.parse_select()
        ops_seen = set()
        while self.at_kw("union", "intersect", "except"):
            kw = self.next().value.lower()
            if kw == "union":
                all_ = self.eat_kw("all")
                op = "union_all" if all_ else "union"
            else:
                op = kw
            ops_seen.add("intersect" if op == "intersect" else "other")
            if len(ops_seen) > 1:
                # left-folding would silently violate INTERSECT's higher
                # standard-SQL precedence: refuse rather than misparse
                raise SqlError(
                    "mixing INTERSECT with UNION/EXCEPT in one chain is "
                    "ambiguous here (INTERSECT binds tighter in SQL); "
                    "parenthesize via derived tables")
            r = self.parse_select()
            q = A.SetOp(op, q, r)
        return q

    def parse_select(self) -> A.Select:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        self.eat_kw("all")
        items: List[A.SelectItem] = []
        select_star = False
        if self.at_op("*"):
            self.next()
            select_star = True
        else:
            while True:
                e = self.expr()
                alias = None
                if self.eat_kw("as"):
                    alias = self._ident()
                elif self.peek().kind == "IDENT":
                    alias = self._ident()
                items.append(A.SelectItem(e, alias))
                if not self.eat_op(","):
                    break
        relations: List[A.Node] = []
        if self.eat_kw("from"):
            relations.append(self._relation())
            while True:
                if self.eat_op(","):
                    relations.append(self._relation())
                    continue
                how = self._join_kind()
                if how is None:
                    break
                rel = self._relation()
                cond = self.expr() if self.eat_kw("on") else None
                relations.append(A.JoinItem(how, rel, cond))
        where = self.expr() if self.eat_kw("where") else None
        group_by: List[A.Node] = []
        group_mode = "groupby"
        if self.eat_kw("group"):
            self.expect_kw("by")
            if self.at_kw("rollup", "cube"):
                group_mode = self.next().value
                self.expect_op("(")
                group_by.extend(self._expr_list())
                self.expect_op(")")
            else:
                group_by.extend(self._expr_list())
        having = self.expr() if self.eat_kw("having") else None
        order_by: List[A.OrderItem] = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            order_by = self._order_items()
        limit = None
        if self.eat_kw("limit"):
            t = self.next()
            if t.kind != "NUMBER":
                raise SqlError(f"expected LIMIT count at {t.pos}")
            limit = int(t.value)
        return A.Select(tuple(items), tuple(relations), where,
                        tuple(group_by), having, tuple(order_by), limit,
                        distinct, select_star, group_mode)

    def _window_spec(self) -> A.WindowSpecNode:
        """OVER ( [PARTITION BY e,...] [ORDER BY e [ASC|DESC],...]
        [ROWS|RANGE [BETWEEN bound AND bound | bound]] )"""
        self.expect_kw("over")
        self.expect_op("(")
        part: List[A.Node] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            part = self._expr_list()
        orders: List[A.OrderItem] = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            orders = self._order_items()
        ftype = None
        lower = upper = None
        if self.at_kw("rows", "range"):
            ftype = self.next().value
            pos = self.peek().pos
            if self.eat_kw("between"):
                lo = self._frame_bound()
                self.expect_kw("and")
                hi = self._frame_bound()
            else:
                lo = self._frame_bound()
                hi = 0          # single-bound form: .. AND CURRENT ROW
                if lo == "ub_fol" or (isinstance(lo, (int, float))
                                      and lo > 0):
                    raise SqlError(
                        f"a single frame bound must be PRECEDING or "
                        f"CURRENT ROW (at {pos})")
            if lo == "ub_fol" or hi == "ub_pre":
                raise SqlError(f"inverted frame direction at {pos}")
            lower = None if lo == "ub_pre" else lo
            upper = None if hi == "ub_fol" else hi
            if isinstance(lower, (int, float)) and \
                    isinstance(upper, (int, float)) and lower > upper:
                raise SqlError(f"frame lower bound exceeds upper at {pos}")
        self.expect_op(")")
        return A.WindowSpecNode(tuple(part), tuple(orders), ftype, lower,
                                upper)

    def _frame_bound(self):
        """'ub_pre'/'ub_fol' for unbounded; 0 = current row; negative =
        preceding, positive = following (floats allowed for RANGE)."""
        if self.eat_kw("unbounded"):
            if self.eat_kw("preceding"):
                return "ub_pre"
            self.expect_kw("following")
            return "ub_fol"
        if self.eat_kw("current"):
            self.expect_kw("row")
            return 0
        t = self.next()
        if t.kind != "NUMBER":
            raise SqlError(f"expected frame bound at {t.pos}")
        n = float(t.value) if "." in t.value else int(t.value)
        if self.eat_kw("preceding"):
            return -n
        self.expect_kw("following")
        return n

    def _join_kind(self) -> Optional[str]:
        if self.at_kw("join"):
            self.next()
            return "inner"
        for lead, how in (("inner", "inner"), ("cross", "cross"),
                          ("left", "left"), ("right", "right"),
                          ("full", "full")):
            if self.at_kw(lead):
                save = self.i
                self.next()
                if lead == "left" and self.at_kw("semi"):
                    self.next()
                    how = "left_semi"
                elif lead == "left" and self.at_kw("anti"):
                    self.next()
                    how = "left_anti"
                else:
                    self.eat_kw("outer")
                if self.eat_kw("join"):
                    return how
                self.i = save
                return None
        return None

    def _relation(self) -> A.Node:
        if self.at_op("("):
            self.next()
            q = self.parse_query()
            self.expect_op(")")
            alias = None
            if self.eat_kw("as"):
                alias = self._ident()
            elif self.peek().kind == "IDENT" and \
                    self.peek().value.lower() != "pivot":
                # 'pivot' is a soft keyword: FROM (subquery) PIVOT (...)
                # carries no derived-table alias (Spark accepts this form)
                alias = self._ident()
            if alias is None:
                alias = "__auto_generated_subquery_name"
            return self._maybe_pivot(A.SubqueryRef(q, alias))
        name = self._ident()
        alias = None
        if self.eat_kw("as"):
            alias = self._ident()
        elif self.peek().kind == "IDENT" and \
                self.peek().value.lower() != "pivot":
            alias = self._ident()
        ref: A.Node = A.TableRef(name, alias)
        return self._maybe_pivot(ref)

    def _maybe_pivot(self, ref: A.Node) -> A.Node:
        """rel PIVOT (agg [AS a][, ...] FOR col IN (lit [AS a], ...))
        [[AS] alias] — 'pivot' stays a soft keyword (usable as an
        identifier everywhere else)."""
        t = self.peek()
        if not (t.kind == "IDENT" and t.value.lower() == "pivot"):
            return ref
        save = self.i
        self.next()
        if not self.at_op("("):
            self.i = save
            return ref
        self.next()
        aggs = []
        while True:
            e = self.expr()
            al = self._ident() if self.eat_kw("as") else None
            aggs.append((e, al))
            if not self.eat_op(","):
                break
        self.expect_kw("for")
        pcol = A.ColRef(self._ident())
        self.expect_kw("in")
        self.expect_op("(")
        values = []
        while True:
            v = self.expr()
            if isinstance(v, A.UnaryOp) and v.op == "neg" \
                    and isinstance(v.child, A.Lit):
                v = A.Lit(-v.child.value)
            if not isinstance(v, A.Lit):
                raise SqlError("PIVOT IN values must be literals")
            val_alias = self._ident() if self.eat_kw("as") else None
            values.append((v.value, val_alias))
            if not self.eat_op(","):
                break
        self.expect_op(")")
        self.expect_op(")")
        alias = None
        if self.eat_kw("as"):
            alias = self._ident()
        elif self.peek().kind == "IDENT":
            alias = self._ident()
        return A.PivotRef(ref, tuple(aggs), pcol, tuple(values), alias)

    def _order_items(self) -> List["A.OrderItem"]:
        """expr [ASC|DESC] [NULLS FIRST|LAST] {, ...} — shared by the
        statement-level ORDER BY and window specs."""
        out: List[A.OrderItem] = []
        while True:
            e = self.expr()
            asc = True
            if self.eat_kw("desc"):
                asc = False
            else:
                self.eat_kw("asc")
            nulls_first = None
            t = self.peek()
            if t.kind == "IDENT" and t.value.lower() == "nulls":
                self.next()
                w = self._ident().lower()
                if w not in ("first", "last"):
                    raise SqlError(
                        f"expected FIRST or LAST after NULLS, got {w!r}")
                nulls_first = (w == "first")
            out.append(A.OrderItem(e, asc, nulls_first))
            if not self.eat_op(","):
                break
        return out

    def _expr_list(self) -> list:
        out = [self.expr()]
        while self.eat_op(","):
            out.append(self.expr())
        return out

    def _ident(self) -> str:
        from spark_rapids_tpu_torch.sql.lexer import SOFT_KEYWORDS
        t = self.next()
        if t.kind == "KEYWORD" and t.value in SOFT_KEYWORDS:
            return t.value  # non-reserved word used as an identifier
        if t.kind != "IDENT":
            raise SqlError(f"expected identifier, got {t.value!r} at {t.pos}")
        return t.value

    # ---- expressions (Pratt) ----------------------------------------------
    def expr(self, min_bp: int = 0) -> A.Node:
        left = self._prefix()
        while True:
            left2 = self._postfix(left, min_bp)
            if left2 is not left:
                left = left2
                continue
            t = self.peek()
            op = None
            if t.kind == "OP" and t.value in _BP:
                op = t.value
            elif t.kind == "KEYWORD" and t.value in ("and", "or"):
                op = t.value
            if op is None or _BP[op] < min_bp:
                return left
            self.next()
            right = self.expr(_BP[op] + 1)
            if op == "!=":
                op = "<>"
            left = A.BinOp(op, left, right)

    #: binding power of the predicate postfixes (BETWEEN/IN/LIKE/IS NULL):
    #: looser than arithmetic/comparison, tighter than NOT/AND
    _POSTFIX_BP = 30

    def _postfix(self, left: A.Node, min_bp: int) -> A.Node:
        """BETWEEN / IN / LIKE / IS [NOT] NULL — bind looser than arithmetic
        (a + 1 BETWEEN x AND y predicates over a + 1), tighter than AND."""
        if min_bp <= self._POSTFIX_BP:
            negated = False
            save = self.i
            if self.at_kw("not"):
                if self.peek(1).kind == "KEYWORD" and \
                        self.peek(1).value in ("between", "in", "like"):
                    self.next()
                    negated = True
                else:
                    return left
            if self.eat_kw("between"):
                low = self.expr(_BP["and"] + 1)
                self.expect_kw("and")
                high = self.expr(_BP["and"] + 1)
                return A.Between(left, low, high, negated)
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self.parse_select()
                    self.expect_op(")")
                    return A.InSubquery(left, q, negated)
                opts = [self.expr()]
                while self.eat_op(","):
                    opts.append(self.expr())
                self.expect_op(")")
                return A.InList(left, tuple(opts), negated)
            if self.eat_kw("like"):
                t = self.next()
                if t.kind != "STRING":
                    raise SqlError(f"LIKE needs a string pattern at {t.pos}")
                return A.LikeOp(left, t.value, negated)
            if self.eat_kw("is"):
                neg = self.eat_kw("not")
                self.expect_kw("null")
                return A.IsNull(left, neg)
            self.i = save
        return left

    def _prefix(self) -> A.Node:
        t = self.peek()
        if t.kind == "OP" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                q = self.parse_select()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "OP" and t.value == "-":
            self.next()
            return A.UnaryOp("neg", self.expr(70))
        if t.kind == "OP" and t.value == "+":
            self.next()
            return self.expr(70)
        if t.kind == "KEYWORD":
            if t.value == "not":
                self.next()
                return A.UnaryOp("not", self.expr(25))
            if t.value == "exists":
                self.next()
                self.expect_op("(")
                q = self.parse_select()
                self.expect_op(")")
                return A.ExistsSubquery(q)
            if t.value == "case":
                return self._case()
            if t.value == "date":
                self.next()
                s = self.next()
                if s.kind != "STRING":
                    raise SqlError(f"DATE needs a string at {s.pos}")
                return A.Lit(datetime.date.fromisoformat(s.value))
            if t.value == "interval":
                self.next()
                s = self.next()
                if s.kind == "STRING":
                    n = int(s.value)
                elif s.kind == "NUMBER":
                    n = int(s.value)
                else:
                    raise SqlError(f"INTERVAL needs a count at {s.pos}")
                unit = self._ident().lower().rstrip("s")
                if unit not in ("day", "month", "year"):
                    raise SqlError(f"unsupported interval unit {unit!r}")
                return A.Interval(n, unit)
            if t.value == "extract":
                self.next()
                self.expect_op("(")
                part = self._ident().lower()
                # FROM here is a keyword separator, not a clause
                self.expect_kw("from")
                v = self.expr()
                self.expect_op(")")
                return A.ExtractExpr(part, v)
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                v = self.expr()
                self.expect_kw("as")
                to = self._type_name()
                self.expect_op(")")
                return A.CastExpr(v, to)
            if t.value == "substring":
                self.next()
                self.expect_op("(")
                v = self.expr()
                if self.eat_kw("from"):
                    start = self.expr()
                    self.expect_kw("for")
                    length = self.expr()
                else:
                    self.expect_op(",")
                    start = self.expr()
                    self.expect_op(",")
                    length = self.expr()
                self.expect_op(")")
                return A.FuncCall("substring", (v, start, length))
            if t.value == "case":
                return self._case()
            if t.value == "null":
                self.next()
                return A.Lit(None)
            if t.value == "true":
                self.next()
                return A.Lit(True)
            if t.value == "false":
                self.next()
                return A.Lit(False)
        if t.kind == "NUMBER":
            self.next()
            return A.Lit(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "STRING":
            self.next()
            return A.Lit(t.value)
        if t.kind == "IDENT":
            self.next()
            name = t.value
            # function call
            if self.at_op("("):
                self.next()
                distinct = self.eat_kw("distinct")
                if self.at_op("*"):
                    self.next()
                    self.expect_op(")")
                    call = A.FuncCall(name.lower(), (), distinct, star=True)
                elif self.at_op(")"):
                    self.next()
                    call = A.FuncCall(name.lower(), (), distinct)
                else:
                    args = [self.expr()]
                    while self.eat_op(","):
                        args.append(self.expr())
                    self.expect_op(")")
                    call = A.FuncCall(name.lower(), tuple(args), distinct)
                if self.at_kw("over"):
                    return A.WindowFuncCall(call, self._window_spec())
                return call
            # qualified column a.b
            if self.at_op(".") and self.peek(1).kind == "IDENT":
                self.next()
                col = self._ident()
                return A.ColRef(col, qualifier=name)
            return A.ColRef(name)
        from spark_rapids_tpu_torch.sql.lexer import SOFT_KEYWORDS
        if t.kind == "KEYWORD" and t.value in SOFT_KEYWORDS:
            self.next()
            return A.ColRef(t.value)
        raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

    def _case(self) -> A.Node:
        self.expect_kw("case")
        branches: List[Tuple[A.Node, A.Node]] = []
        while self.eat_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            val = self.expr()
            branches.append((cond, val))
        otherwise = self.expr() if self.eat_kw("else") else None
        self.expect_kw("end")
        return A.CaseWhen(tuple(branches), otherwise)

    def _type_name(self) -> str:
        t = self.next()
        if t.kind not in ("IDENT", "KEYWORD"):
            raise SqlError(f"expected type name at {t.pos}")
        name = t.value.lower()
        if self.at_op("("):  # e.g. decimal(12, 2) — precision ignored
            self.next()
            while not self.at_op(")"):
                self.next()
            self.next()
        return name


def parse_sql(text: str) -> A.Node:
    import dataclasses
    p = Parser(text)
    ctes = []
    if p.eat_kw("with"):
        while True:
            name = p._ident().lower()
            p.eat_kw("as")
            p.expect_op("(")
            q = p.parse_query()
            p.expect_op(")")
            ctes.append((name, q))
            if not p.eat_op(","):
                break
    stmt = p.parse_query()
    if p.peek().kind != "EOF":
        t = p.peek()
        raise SqlError(f"trailing input at {t.pos}: {t.value!r}")
    if ctes:
        stmt = dataclasses.replace(stmt, ctes=tuple(ctes))
    return stmt
