"""SQL AST -> DataFrame planning, with Catalyst-style subquery decorrelation.

The reference consumes SQL through Spark's analyzer/optimizer; this planner
fills that role for the TPU engine:

- name resolution over qualified scopes (every base relation's columns are
  prefixed ``alias.col`` so self-joins — TPC-H Q21's three lineitem scans —
  resolve unambiguously);
- WHERE conjunct classification: single-relation conjuncts push below the
  joins, two-relation equalities become join keys (greedy connected-order
  join folding), the rest filter post-join;
- subquery decorrelation exactly as Catalyst's RewritePredicateSubquery /
  RewriteCorrelatedScalarSubquery do it: EXISTS -> left-semi join,
  NOT EXISTS / NOT IN -> left-anti join, IN -> left-semi join, correlated
  scalar aggregates -> grouped-by-correlation-key equi-join, uncorrelated
  scalars -> single-row cross join; non-equality correlation (Q21's
  ``l2.l_suppkey <> l1.l_suppkey``) goes through a row-id semi-join;
- aggregation planning: GROUP BY expressions and aggregate calls are lifted
  to hidden columns and structurally substituted back into SELECT / HAVING /
  ORDER BY (semantic-equality matching, like Catalyst).

Constant folding: date +/- interval arithmetic folds at plan time; interval
day arithmetic over columns lowers to date_add/date_sub.

The JAX package's planner onto the port's ``api`` and ``exprs``: the plan
runs on the session's device, and every function, operator, set operation
and clause the JAX planner takes is planned; nothing falls back to another
engine.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.sql import ast as A
from spark_rapids_tpu_torch.sql.lexer import SqlError

col = F.col


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------
class Scope:
    """Resolves ColRefs to dataframe column names. Base-relation columns are
    stored prefixed (``alias.col``); extras map hidden/post-agg names."""

    def __init__(self, relations: Sequence[Tuple[str, Sequence[str]]],
                 extras: Sequence[str] = ()):
        self.relations = list(relations)   # (alias, [raw col names])
        self.extras = list(extras)         # directly resolvable names

    def resolve(self, ref: A.ColRef) -> str:
        if ref.qualifier is not None:
            for alias, cols in self.relations:
                if alias == ref.qualifier and ref.name in cols:
                    return f"{alias}.{ref.name}"
            raise KeyError(f"{ref.qualifier}.{ref.name}")
        if ref.name in self.extras:
            return ref.name
        hits = [f"{alias}.{ref.name}" for alias, cols in self.relations
                if ref.name in cols]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SqlError(f"ambiguous column {ref.name!r}: {hits}")
        raise KeyError(ref.name)

    def merged(self, other: "Scope") -> "Scope":
        return Scope(self.relations + other.relations,
                     self.extras + other.extras)


def _refs(node: A.Node) -> List[A.ColRef]:
    out: List[A.ColRef] = []

    def walk(n):
        if isinstance(n, A.ColRef):
            out.append(n)
            return
        if isinstance(n, (A.ScalarSubquery, A.ExistsSubquery, A.InSubquery)):
            return  # inner query refs resolved separately
        for f in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, f)
            if isinstance(v, A.Node):
                walk(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, A.Node):
                        walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, A.Node):
                                walk(y)
    walk(node)
    if isinstance(node, A.InSubquery):
        out.extend(_refs(node.value))
    return out


def _has_subquery(node: A.Node) -> bool:
    if isinstance(node, (A.ScalarSubquery, A.ExistsSubquery, A.InSubquery)):
        return True
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, A.Node) and not isinstance(v, A.Select) \
                and _has_subquery(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, A.Node) and not isinstance(x, A.Select) \
                        and _has_subquery(x):
                    return True
                if isinstance(x, tuple) and any(
                        isinstance(y, A.Node) and _has_subquery(y)
                        for y in x):
                    return True
    return False


def _has_agg(node: A.Node) -> bool:
    if isinstance(node, A.FuncCall) and node.name in _AGGS:
        return True
    if isinstance(node, A.WindowFuncCall):
        # the window's own function is not a query aggregate, but aggregates
        # in its ARGS or SPEC are (rank() OVER (ORDER BY sum(v)) without
        # GROUP BY is a global aggregate) — mirror collect()
        return any(_has_agg(a) for a in node.func.args) or \
            _has_agg(node.spec)
    if isinstance(node, (A.ScalarSubquery, A.ExistsSubquery, A.InSubquery)):
        return False
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, A.Node) and _has_agg(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, A.Node) and _has_agg(x):
                    return True
                if isinstance(x, tuple) and any(
                        isinstance(y, A.Node) and _has_agg(y) for y in x):
                    return True
    return False


def _conjuncts(node: Optional[A.Node]) -> List[A.Node]:
    if node is None:
        return []
    if isinstance(node, A.BinOp) and node.op == "and":
        return _conjuncts(node.left) + _conjuncts(node.right)
    return [node]


def _substitute(node: A.Node, table: Dict[A.Node, A.Node]) -> A.Node:
    """Structural substitution (bottom-up) — hidden-column replacement for
    group keys / aggregate calls / scalar subqueries."""
    if node in table:
        return table[node]

    def sub(v):
        if isinstance(v, A.Select):
            return v
        if isinstance(v, A.Node):
            return _substitute(v, table)
        if isinstance(v, tuple):
            return tuple(sub(x) for x in v)
        return v

    fields = getattr(node, "__dataclass_fields__", None)
    if not fields:
        return node
    kwargs = {f: sub(getattr(node, f)) for f in fields}
    new = type(node)(**kwargs)
    return table.get(new, new)


_AGGS = {"sum", "avg", "count", "min", "max", "stddev", "stddev_pop",
         "variance", "var_pop", "first", "last", "corr", "covar_samp",
         "covar_pop"}

_FUNCS = {
    "substring": lambda a: F.substring(a[0], _int(a[1]), _int(a[2])),
    "year": lambda a: F.year(a[0]),
    "month": lambda a: F.month(a[0]),
    "upper": lambda a: F.upper(a[0]),
    "lower": lambda a: F.lower(a[0]),
    "length": lambda a: F.length(a[0]),
    "abs": lambda a: F.abs(a[0]),
    "sqrt": lambda a: F.sqrt(a[0]),
    "floor": lambda a: F.floor(a[0]),
    "ceil": lambda a: F.ceil(a[0]),
    "round": lambda a: F.round(a[0], _int(a[1]) if len(a) > 1 else 0),
    "coalesce": lambda a: F.coalesce(*a),
    "concat": lambda a: F.concat(*a),
    "trim": lambda a: F.trim(a[0]),
    "date_add": lambda a: F.date_add(a[0], _int(a[1])),
    "date_sub": lambda a: F.date_sub(a[0], _int(a[1])),
    "datediff": lambda a: F.datediff(a[0], a[1]),
    "greatest": lambda a: F.greatest(*a),
    "least": lambda a: F.least(*a),
    "pow": lambda a: F.pow(a[0], a[1]),
    "power": lambda a: F.pow(a[0], a[1]),
    "substr": lambda a: F.substring(a[0], _int(a[1]),
                                    _int(a[2]) if len(a) > 2
                                    else (1 << 30)),   # 2-arg: to end
    "lpad": lambda a: F.lpad(a[0], _int(a[1]), _str(a[2])),
    "rpad": lambda a: F.rpad(a[0], _int(a[1]), _str(a[2])),
    "ltrim": lambda a: (F.ltrim(a[0]) if len(a) == 1
                        else F.ltrim(a[1], _str(a[0]))),  # 2-arg: chars, s
    "rtrim": lambda a: (F.rtrim(a[0]) if len(a) == 1
                        else F.rtrim(a[1], _str(a[0]))),
    "instr": lambda a: F.instr(a[0], _str(a[1])),
    "locate": lambda a: F.locate(_str(a[0]), a[1], _int(a[2]) if len(a) > 2
                                 else 1),
    "replace": lambda a: F.replace(a[0], _str(a[1]),
                                   _str(a[2]) if len(a) > 2 else ""),
    "regexp_replace": lambda a: F.regexp_replace(a[0], _str(a[1]),
                                                 _str(a[2])),
    "nvl": lambda a: (F.coalesce(*a) if len(a) == 2
                      else _arity_error("nvl", 2, len(a))),
    "nanvl": lambda a: F.nanvl(a[0], a[1]),
    "pmod": lambda a: F.pmod(a[0], a[1]),
    "char_length": lambda a: F.length(a[0]),
    "weekday": lambda a: F.weekday(a[0]),
    "from_unixtime": lambda a: (F.from_unixtime(a[0]) if len(a) == 1
                                else _arity_error("from_unixtime with a "
                                                  "format", 1, len(a))),
    "unix_timestamp": lambda a: (F.unix_timestamp(a[0]) if len(a) == 1
                                 else _arity_error("unix_timestamp with a "
                                                   "format", 1, len(a))),
    "substring_index": lambda a: F.substring_index(a[0], _str(a[1]),
                                                   _int(a[2])),
}


def _one_row():
    """Spark's OneRowRelation: one int64 column ``__one`` holding 1."""
    import numpy as np
    from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    return HostBatch(Schema([Field("__one", DType.LONG, False)]),
                     (HostColumn(DType.LONG, np.ones(1, np.int64),
                                 np.ones(1, bool)),), 1)


def _arity_error(name: str, want: int, got: int):
    raise SqlError(f"{name} is not supported with {got} arguments "
                   f"(expected {want})")


def _int(c: Column) -> int:
    from spark_rapids_tpu_torch.exprs import Literal
    if isinstance(c.expr, Literal):
        return int(c.expr.value)
    raise SqlError("expected an integer literal argument")


def _str(c: Column) -> str:
    from spark_rapids_tpu_torch.exprs import Literal
    if isinstance(c.expr, Literal) and isinstance(c.expr.value, str):
        return c.expr.value
    raise SqlError("expected a string literal argument")


# ---------------------------------------------------------------------------
# expression lowering
# ---------------------------------------------------------------------------
def to_column(node: A.Node, scope: Scope) -> Column:
    if isinstance(node, A.ColRef):
        try:
            return col(scope.resolve(node))
        except KeyError as e:
            raise SqlError(f"cannot resolve column {e.args[0]!r}") from None
    if isinstance(node, A.Lit):
        return F.lit(node.value)
    if isinstance(node, A.Interval):
        raise SqlError("interval literal outside +/- arithmetic")
    if isinstance(node, A.BinOp):
        return _binop(node, scope)
    if isinstance(node, A.UnaryOp):
        c = to_column(node.child, scope)
        return ~c if node.op == "not" else -c
    if isinstance(node, A.FuncCall):
        return _func(node, scope)
    if isinstance(node, A.WindowFuncCall):
        return _window_func(node, scope)
    if isinstance(node, A.CaseWhen):
        w = None
        for cond, val in node.branches:
            cc, vc = to_column(cond, scope), to_column(val, scope)
            w = F.when(cc, vc) if w is None else w.when(cc, vc)
        if node.otherwise is not None:
            return w.otherwise(to_column(node.otherwise, scope))
        return w  # no ELSE: _WhenColumn already carries the null default
    if isinstance(node, A.Between):
        v = to_column(node.value, scope)
        out = (v >= to_column(node.low, scope)) & \
              (v <= to_column(node.high, scope))
        return ~out if node.negated else out
    if isinstance(node, A.InList):
        v = to_column(node.value, scope)
        vals = []
        for o in node.options:
            if not isinstance(o, A.Lit):
                # general IN decomposes into OR of equalities
                out = None
                for o2 in node.options:
                    eq = v == to_column(o2, scope)
                    out = eq if out is None else (out | eq)
                return ~out if node.negated else out
            vals.append(o.value)
        out = v.isin(*vals)
        return ~out if node.negated else out
    if isinstance(node, A.LikeOp):
        out = to_column(node.value, scope).like(node.pattern)
        return ~out if node.negated else out
    if isinstance(node, A.IsNull):
        v = to_column(node.value, scope)
        return v.isNotNull() if node.negated else v.isNull()
    if isinstance(node, A.CastExpr):
        return to_column(node.value, scope).cast(_sql_type(node.to))
    if isinstance(node, A.ExtractExpr):
        v = to_column(node.value, scope)
        fn = {"year": F.year, "month": F.month, "day": F.dayofmonth}.get(
            node.part)
        if fn is None:
            raise SqlError(f"unsupported EXTRACT part {node.part!r}")
        return fn(v)
    if isinstance(node, (A.ScalarSubquery, A.ExistsSubquery, A.InSubquery)):
        raise SqlError("subquery must be decorrelated before lowering "
                       "(planner bug)")
    raise SqlError(f"cannot lower {type(node).__name__}")


def _sql_type(name: str) -> str:
    m = {"integer": "int", "int": "int", "bigint": "long", "long": "long",
         "double": "double", "float": "float", "varchar": "string",
         "char": "string", "string": "string", "date": "date",
         "boolean": "boolean", "decimal": "double", "numeric": "double",
         "smallint": "int"}
    if name not in m:
        raise SqlError(f"unsupported cast type {name!r}")
    return m[name]


def _fold_interval(op: str, left: A.Node, right: A.Node, scope: Scope):
    """date +/- interval: fold when the date side is a literal; otherwise
    lower day intervals to date_add/date_sub."""
    assert isinstance(right, A.Interval)
    n, unit = right.n, right.unit
    if isinstance(left, A.Lit) and isinstance(left.value, datetime.date):
        d = left.value
        sign = 1 if op == "+" else -1
        if unit == "day":
            return F.lit(d + datetime.timedelta(days=sign * n))
        months = d.year * 12 + (d.month - 1) + sign * n * (
            12 if unit == "year" else 1)
        y, m = divmod(months, 12)
        day = min(d.day, _days_in_month(y, m + 1))
        return F.lit(datetime.date(y, m + 1, day))
    if unit == "day":
        c = to_column(left, scope)
        return F.date_add(c, n) if op == "+" else F.date_sub(c, n)
    raise SqlError("month/year intervals require a literal date operand")


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return (datetime.date(y, m + 1, 1) - datetime.timedelta(days=1)).day


def _binop(node: A.BinOp, scope: Scope) -> Column:
    op = node.op
    if isinstance(node.right, A.Interval):
        return _fold_interval(op, node.left, node.right, scope)
    if isinstance(node.left, A.Interval):
        if op == "+":
            return _fold_interval(op, node.right, node.left, scope)
        raise SqlError("interval on the left of '-' is not valid SQL")
    l = to_column(node.left, scope)
    r = to_column(node.right, scope)
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "/":
        return l / r
    if op == "%":
        return l % r
    if op == "=":
        return l == r
    if op == "<>":
        return l != r
    if op == "<":
        return l < r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == ">=":
        return l >= r
    if op == "and":
        return l & r
    if op == "or":
        return l | r
    if op == "||":
        return F.concat(l, r)
    raise SqlError(f"unsupported operator {op!r}")


def _func(node: A.FuncCall, scope: Scope) -> Column:
    name = node.name
    if name in _AGGS:
        if name == "count":
            if node.star or not node.args:
                return F.count()
            inner = to_column(node.args[0], scope)
            return F.countDistinct(inner) if node.distinct else F.count(inner)
        if name in ("corr", "covar_samp", "covar_pop"):
            two = {"corr": F.corr, "covar_samp": F.covar_samp,
                   "covar_pop": F.covar_pop}[name]
            return two(to_column(node.args[0], scope),
                       to_column(node.args[1], scope))
        fn = {"sum": F.sum, "avg": F.avg, "min": F.min, "max": F.max,
              "stddev": F.stddev, "stddev_pop": F.stddev_pop,
              "variance": F.variance, "var_pop": F.var_pop,
              "first": F.first, "last": F.last}[name]
        arg = to_column(node.args[0], scope)
        if node.distinct:
            if name != "sum":
                raise SqlError(f"DISTINCT not supported for {name}")
            return F.sumDistinct(arg)
        return fn(arg)
    if name in _FUNCS:
        return _FUNCS[name]([to_column(a, scope) for a in node.args])
    raise SqlError(f"unknown function {name!r}")


_WINDOW_FUNCS = {"row_number": "row_number", "rank": "rank",
                 "dense_rank": "dense_rank", "percent_rank": "percent_rank",
                 "cume_dist": "cume_dist"}


def _window_func(node: A.WindowFuncCall, scope: Scope) -> Column:
    """fn(...) OVER (...) -> the api window machinery (WindowExpression is
    then extracted into an lp.Window by DataFrame.select, Catalyst's
    ExtractWindowExpressions shape)."""
    from spark_rapids_tpu_torch.api.window import WindowSpec
    from spark_rapids_tpu_torch.exprs.misc import SortOrder
    from spark_rapids_tpu_torch.exprs.windows import WindowFrame

    sp = node.spec
    part = tuple(to_column(e, scope).expr for e in sp.partition_by)
    orders = tuple(
        SortOrder(to_column(o.expr, scope).expr, o.ascending,
                  o.ascending if o.nulls_first is None else o.nulls_first)
        for o in sp.order_by)
    frame = (WindowFrame(sp.frame_type, sp.frame_lower, sp.frame_upper)
             if sp.frame_type is not None else None)
    spec = WindowSpec(part, orders, frame)

    f = node.func
    if not isinstance(f, A.FuncCall):
        raise SqlError(
            "the aggregate under OVER also appears as a plain aggregate; "
            "alias the plain aggregate and window over the alias instead")
    if f.name in _WINDOW_FUNCS:
        fn = getattr(F, _WINDOW_FUNCS[f.name])()
    elif f.name == "ntile":
        if len(f.args) != 1 or not isinstance(f.args[0], A.Lit):
            raise SqlError("ntile(n) needs an integer literal")
        fn = F.ntile(int(f.args[0].value))
    elif f.name in ("lead", "lag"):
        arg = to_column(f.args[0], scope)
        offset = 1
        default = None
        if len(f.args) > 1:
            if not isinstance(f.args[1], A.Lit):
                raise SqlError(f"{f.name} offset must be a literal")
            offset = int(f.args[1].value)
        if len(f.args) > 2:
            if not isinstance(f.args[2], A.Lit):
                raise SqlError(f"{f.name} default must be a literal")
            default = f.args[2].value
        fn = (F.lead if f.name == "lead" else F.lag)(arg, offset, default)
    elif f.name in _AGGS:
        fn = _func(f, scope)
    else:
        raise SqlError(f"unknown window function {f.name!r}")
    return fn.over(spec)


# ---------------------------------------------------------------------------
# statement planning
# ---------------------------------------------------------------------------
class _Rel:
    """One FROM item: its prefixed DataFrame + scope entry."""

    def __init__(self, alias: str, df, raw_cols: List[str]):
        self.alias = alias
        self.df = df
        self.raw_cols = raw_cols



def _rel_alias(rel: A.Node) -> str:
    """Display/scope alias of a FROM item (PIVOT inherits its child's
    alias unless it has its own)."""
    if isinstance(rel, A.SubqueryRef):
        return rel.alias
    if isinstance(rel, A.PivotRef):
        return rel.alias or _rel_alias(rel.child)
    return rel.alias or rel.name


class SqlPlanner:
    def __init__(self, session):
        self.session = session
        self._hidden = 0
        #: WITH-clause bindings: name -> (planned DataFrame, output names);
        #: planned lazily on first reference, shared across references
        self._ctes: Dict[str, A.Select] = {}
        self._cte_plans: Dict[str, tuple] = {}

    def _name(self, stem: str) -> str:
        self._hidden += 1
        return f"__{stem}{self._hidden}"

    # ---- entry -------------------------------------------------------------
    def plan(self, stmt: A.Node, outer: Optional[Scope] = None):
        """Plan one SELECT or UNION chain. Returns (DataFrame, names)."""
        for name, q in stmt.ctes:
            self._ctes[name] = q     # later CTEs may reference earlier ones
        if isinstance(stmt, A.SetOp):
            ldf, lnames = self.plan(stmt.left, outer)
            rdf, rnames = self.plan(stmt.right, outer)
            if len(lnames) != len(rnames):
                raise SqlError(
                    f"{stmt.op.split('_')[0].upper()} arms have "
                    f"{len(lnames)} vs {len(rnames)} columns")
            # positional set op (SQL semantics): right arm renamed to the
            # left arm's output names
            rdf = rdf.select(*[col(rn).alias(ln)
                               for rn, ln in zip(rnames, lnames)])
            if stmt.op == "intersect":
                return ldf.intersect(rdf), lnames
            if stmt.op == "except":
                return ldf.subtract(rdf), lnames
            df = ldf.union(rdf)
            if stmt.op == "union":      # UNION (distinct)
                df = df.distinct()
            return df, lnames
        if not stmt.relations:
            # FROM-less SELECT (constants): plan over a one-row dummy
            # relation (Spark's OneRowRelation)
            one = self.session.create_dataframe(_one_row())
            rels = [_Rel("__one_row", one, ["__one"])]
            scope = Scope([])
            return self._project_phase(stmt, one, scope, outer)
        rels = self._relations(stmt)
        scope = Scope([(r.alias, r.raw_cols) for r in rels])

        conjs: List[A.Node] = []
        sub_preds: List[A.Node] = []
        join_conds: List[A.Node] = []
        for c in _conjuncts(stmt.where):
            if _has_subquery(c):
                sub_preds.append(c)
            else:
                conjs.append(c)

        # push single-relation conjuncts below the joins — except into the
        # null-producing side of an outer join, where a WHERE filter must run
        # post-join (it sees the null-extended rows; standard SQL semantics)
        nullable = self._nullable_aliases(stmt)
        remaining: List[A.Node] = []
        for c in conjs:
            aliases = self._aliases_of(c, scope, outer)
            if aliases == "outer":
                remaining.append(c)
                continue
            if len(aliases) == 1 and next(iter(aliases)) not in nullable:
                a = next(iter(aliases))
                r = next(r for r in rels if r.alias == a)
                sub_scope = Scope([(r.alias, r.raw_cols)])
                r.df = r.df.filter(to_column(c, sub_scope))
            elif self._is_equi(c, scope):
                join_conds.append(c)
            else:
                remaining.append(c)

        df, scope = self._fold_joins(stmt, rels, join_conds, scope, outer)

        for c in remaining:
            df = df.filter(to_column(c, scope if outer is None
                                     else scope.merged(outer)))

        for c in sub_preds:
            df, scope = self._apply_subquery_pred(df, scope, c, outer)

        return self._project_phase(stmt, df, scope, outer)

    # ---- FROM --------------------------------------------------------------
    def _relations(self, stmt: A.Select) -> List[_Rel]:
        rels: List[_Rel] = []
        for item in stmt.relations:
            rel = item.relation if isinstance(item, A.JoinItem) else item
            rels.append(self._load_relation(rel))
        return rels

    def _cte(self, name: str):
        """Planned (df, names) of a WITH binding, cached per statement so
        every reference shares one logical subtree (exchange reuse)."""
        key = name.lower()
        if key not in self._cte_plans:
            q = self._ctes[key]
            self._cte_plans[key] = self.plan(q)
        return self._cte_plans[key]

    def _load_relation(self, rel: A.Node) -> _Rel:
        if isinstance(rel, A.TableRef) and rel.name.lower() in self._ctes:
            sub, out_names = self._cte(rel.name)
            alias = rel.alias or rel.name
            pref = sub.select(*[col(c).alias(f"{alias}.{c}")
                                for c in out_names])
            return _Rel(alias, pref, out_names)
        if isinstance(rel, A.TableRef):
            df = self.session.table(rel.name)
            alias = rel.alias or rel.name
            raw = list(df.columns)
            pref = df.select(*[col(c).alias(f"{alias}.{c}") for c in raw])
            return _Rel(alias, pref, raw)
        if isinstance(rel, A.SubqueryRef):
            sub, out_names = self.plan(rel.query)
            pref = sub.select(*[col(c).alias(f"{rel.alias}.{c}")
                                for c in out_names])
            return _Rel(rel.alias, pref, out_names)
        if isinstance(rel, A.PivotRef):
            return self._load_pivot(rel)
        raise SqlError(f"unsupported FROM item {type(rel).__name__}")

    def _load_pivot(self, rel: "A.PivotRef") -> _Rel:
        """Spark SQL PIVOT: implicit group-by over every column not
        consumed by the pivot column or the aggregates, then
        GroupedData.pivot."""
        from spark_rapids_tpu_torch.exprs import Alias as EAlias
        base = self._load_relation(rel.child)
        scope = Scope([(base.alias, base.raw_cols)])
        pivot_pref = scope.resolve(rel.pivot_col)
        consumed = {pivot_pref}
        agg_cols = []
        multi = len(rel.aggs) > 1
        for e, al in rel.aggs:
            for ref in _refs(e):
                consumed.add(scope.resolve(ref))
            c = to_column(e, scope)
            if al is not None:
                c = Column(EAlias(c.expr, al))
            elif multi:
                raise SqlError(
                    "PIVOT with multiple aggregates needs an alias on "
                    "each (agg AS name)")
            agg_cols.append(c)
        group_pref = [f"{base.alias}.{c}" for c in base.raw_cols
                      if f"{base.alias}.{c}" not in consumed]
        values = [v for v, _ in rel.values]
        out = (base.df.groupBy(*[col(g) for g in group_pref])
               .pivot(pivot_pref, values).agg(*agg_cols))
        # value aliases rename the generated columns (IN (1 AS one)).
        # GroupedData names plain '{value}' ONLY for a single unaliased
        # aggregate; any alias (or multiple aggs) appends '_{aggAlias}'
        suffixes = ([al for _, al in rel.aggs]
                    if (multi or rel.aggs[0][1] is not None) else None)
        renames = {}
        for v, val_alias in rel.values:
            if val_alias is None:
                continue
            vbase = "null" if v is None else str(v)
            if suffixes is None:
                renames[vbase] = val_alias
            else:
                for al in suffixes:
                    renames[f"{vbase}_{al}"] = f"{val_alias}_{al}"
        if renames:
            out = out.withColumnsRenamed(renames)
        alias = rel.alias or base.alias
        raw = ([c.split(".", 1)[1] for c in group_pref]
               + [c for c in out.columns if c not in group_pref])
        pref = out.select(
            *[col(c).alias(f"{alias}.{c.split('.', 1)[1]}")
              if c in group_pref else col(c).alias(f"{alias}.{c}")
              for c in out.columns])
        return _Rel(alias, pref, raw)

    def _nullable_aliases(self, stmt: A.Select):
        """Aliases whose columns may be null-extended by an outer join (the
        right side of LEFT, everything before a RIGHT, everyone under FULL)."""
        out = set()
        seen = []
        for item in stmt.relations:
            rel = item.relation if isinstance(item, A.JoinItem) else item
            alias = _rel_alias(rel)
            if isinstance(item, A.JoinItem):
                if item.how == "left":
                    out.add(alias)
                elif item.how == "right":
                    out.update(seen)
                elif item.how == "full":
                    out.update(seen)
                    out.add(alias)
            seen.append(alias)
        return out

    def _aliases_of(self, c: A.Node, scope: Scope, outer: Optional[Scope]):
        aliases = set()
        for ref in _refs(c):
            try:
                name = scope.resolve(ref)
            except KeyError:
                if outer is not None:
                    return "outer"
                raise SqlError(f"cannot resolve column {ref}")
            aliases.add(name.split(".", 1)[0])
        return aliases

    def _is_equi(self, c: A.Node, scope: Scope) -> bool:
        if not (isinstance(c, A.BinOp) and c.op == "="):
            return False
        try:
            la = {scope.resolve(r).split(".", 1)[0] for r in _refs(c.left)}
            ra = {scope.resolve(r).split(".", 1)[0] for r in _refs(c.right)}
        except (KeyError, SqlError):
            return False
        return len(la) == 1 and len(ra) == 1 and la != ra

    def _fold_joins(self, stmt, rels, join_conds, scope, outer):
        """Greedy connected-order fold: join the next relation that shares an
        equi-condition with the accumulated set; cross join as a last resort."""
        explicit = {}
        for item in stmt.relations:
            if isinstance(item, A.JoinItem):
                rel = item.relation
                alias = _rel_alias(rel)
                explicit[alias] = item

        done = [rels[0]]
        df = rels[0].df
        pending = list(rels[1:])
        conds = list(join_conds)
        while pending:
            progressed = False
            for r in list(pending):
                item = explicit.get(r.alias)
                if item is not None:
                    df = self._explicit_join(df, done, r, item, scope, outer)
                    done.append(r)
                    pending.remove(r)
                    progressed = True
                    continue
                mine = [c for c in conds
                        if self._connects(c, scope, done, r)]
                if mine:
                    df = self._equi_join(df, r, mine, scope)
                    for c in mine:
                        conds.remove(c)
                    done.append(r)
                    pending.remove(r)
                    progressed = True
            if not progressed:
                r = pending.pop(0)
                df = df.crossJoin(r.df)
                done.append(r)
        # any join conds not consumed become filters
        for c in conds:
            df = df.filter(to_column(c, scope))
        return df, scope

    def _connects(self, c, scope, done, r) -> bool:
        done_aliases = {d.alias for d in done}
        la = {scope.resolve(x).split(".", 1)[0] for x in _refs(c.left)}
        ra = {scope.resolve(x).split(".", 1)[0] for x in _refs(c.right)}
        return (la <= done_aliases and ra == {r.alias}) or \
               (ra <= done_aliases and la == {r.alias})

    def _equi_join(self, df, r, conds, scope):
        pairs = []
        for c in conds:
            left, right = c.left, c.right
            la = {scope.resolve(x).split(".", 1)[0] for x in _refs(left)}
            if la == {r.alias}:
                left, right = right, left
            lc, df = self._key_col(df, left, scope)
            rc, r.df = self._key_col(r.df, right, scope)
            pairs.append((lc, rc))
        return df.join(r.df, pairs)

    def _key_col(self, df, node: A.Node, scope: Scope):
        """Column name usable as a join key; non-ColRef keys materialize as a
        hidden column."""
        if isinstance(node, A.ColRef):
            return scope.resolve(node), df
        name = self._name("jk")
        return name, df.withColumn(name, to_column(node, scope))

    def _explicit_join(self, df, done, r, item: A.JoinItem, scope, outer):
        how = item.how
        pairs = []
        residual = []
        for c in _conjuncts(item.condition):
            aliases = self._aliases_of(c, scope, outer)
            if aliases == {r.alias} and how in ("inner", "left", "cross",
                                                "left_semi", "left_anti"):
                # a right-side-only ON conjunct filters the right input
                # before a left/inner join (same join semantics)
                r.df = r.df.filter(to_column(
                    c, Scope([(r.alias, r.raw_cols)])))
                continue
            if self._is_equi(c, scope) and self._connects(c, scope, done, r):
                left, right = c.left, c.right
                la = {scope.resolve(x).split(".", 1)[0] for x in _refs(left)}
                if la == {r.alias}:
                    left, right = right, left
                lc, df = self._key_col(df, left, scope)
                rc, r.df = self._key_col(r.df, right, scope)
                pairs.append((lc, rc))
            else:
                residual.append(c)
        cond = None
        if residual:
            merged = scope if outer is None else scope.merged(outer)
            cond = to_column(residual[0], merged)
            for c in residual[1:]:
                cond = cond & to_column(c, merged)
        if how == "cross" and not pairs:
            out = df.crossJoin(r.df)
            return out.filter(cond) if cond is not None else out
        if cond is not None and how == "inner":
            return df.join(r.df, pairs).filter(cond)
        if cond is not None:
            raise SqlError(f"non-equi conditions on {how} joins are not "
                           f"supported")
        return df.join(r.df, pairs, how)

    # ---- subquery predicates ----------------------------------------------
    def _apply_subquery_pred(self, df, scope, pred: A.Node, outer):
        # normalize NOT EXISTS / NOT IN
        if isinstance(pred, A.UnaryOp) and pred.op == "not":
            inner = pred.child
            if isinstance(inner, A.ExistsSubquery):
                pred = A.ExistsSubquery(inner.query, not inner.negated)
            elif isinstance(inner, A.InSubquery):
                pred = A.InSubquery(inner.value, inner.query,
                                    not inner.negated)
        if isinstance(pred, A.ExistsSubquery):
            return self._exists(df, scope, pred), scope
        if isinstance(pred, A.InSubquery):
            return self._in_subquery(df, scope, pred), scope
        # IN subqueries embedded in a larger predicate (e.g. under OR —
        # q45's zip-or-item-subset shape): existence join — left join a
        # distinct flag and substitute `flag IS NOT NULL` (Catalyst's
        # ExistenceJoin role)
        df, scope, pred = self._existence_flags(df, scope, pred)
        # comparison containing scalar subqueries
        df, scope, pred = self._lift_scalars(df, scope, pred)
        return df.filter(to_column(pred, scope)), scope

    def _existence_flags(self, df, scope, pred: A.Node):
        """Replace each embedded UNCORRELATED `x IN (subquery)` with a
        left-join existence flag reference. Null probe values produce a
        null flag, which reads as FALSE — the same contract as the
        DataFrame translations' `m_flag.isNotNull()`."""
        import dataclasses

        def walk(node):
            nonlocal df, scope
            if isinstance(node, A.InSubquery):
                if node.negated:
                    raise SqlError("NOT IN subqueries inside OR are not "
                                   "supported (three-valued semantics)")
                eq_pairs, other = self._correlation(node.query, scope)
                if eq_pairs or other:
                    raise SqlError("correlated IN subqueries inside OR are "
                                   "not supported")
                sub_df, names = self.plan(node.query)
                if len(names) != 1:
                    raise SqlError(
                        "IN subquery must select exactly one column")
                flag = self._name("exists")
                key = self._name("ek")
                sub_df = (sub_df.select(col(names[0]).alias(key))
                          .dropDuplicates()
                          .withColumn(flag, F.lit(1)))
                oc, df = self._key_col(df, node.value, scope)
                df = df.join(sub_df, [(oc, key)], "left")
                scope.extras.append(flag)
                return A.IsNull(A.ColRef(flag), True)
            if not isinstance(node, A.Node) or \
                    isinstance(node, (A.Select, A.SetOp, A.ScalarSubquery,
                                      A.ExistsSubquery)):
                return node
            changes = {}
            for f in node.__dataclass_fields__:
                v = getattr(node, f)
                if isinstance(v, A.Node):
                    nv = walk(v)
                    if nv is not v:
                        changes[f] = nv
                elif isinstance(v, tuple):
                    nv = tuple(walk(x) if isinstance(x, A.Node) else x
                               for x in v)
                    if any(a is not b for a, b in zip(nv, v)):
                        changes[f] = nv
            return dataclasses.replace(node, **changes) if changes else node

        new_pred = walk(pred)       # mutates df/scope via nonlocal FIRST
        return df, scope, new_pred

    def _split_correlation(self, stmt: A.Select, inner_scope: Scope,
                           outer_scope: Scope):
        """Partition the subquery's WHERE into (inner conjs, correlated
        equality pairs [(outer ast, inner ast)], other correlated conjs)."""
        inner_conjs, eq_pairs, other = [], [], []
        for c in _conjuncts(stmt.where):
            refs = _refs(c)
            sides = []
            for ref in refs:
                try:
                    inner_scope.resolve(ref)
                    sides.append("inner")
                except (KeyError, SqlError):
                    outer_scope.resolve(ref)   # raises if truly unknown
                    sides.append("outer")
            if "outer" not in sides:
                inner_conjs.append(c)
                continue
            if isinstance(c, A.BinOp) and c.op == "=" and not _has_subquery(c):
                def side(node):
                    ss = set()
                    for ref in _refs(node):
                        try:
                            inner_scope.resolve(ref)
                            ss.add("inner")
                        except (KeyError, SqlError):
                            ss.add("outer")
                    return ss
                ls, rs = side(c.left), side(c.right)
                if ls == {"outer"} and rs == {"inner"}:
                    eq_pairs.append((c.left, c.right))
                    continue
                if ls == {"inner"} and rs == {"outer"}:
                    eq_pairs.append((c.right, c.left))
                    continue
            other.append(c)
        return inner_conjs, eq_pairs, other

    def _plan_inner(self, stmt: A.Select, outer_scope: Scope):
        """Plan a subquery's FROM + inner-only filters; returns
        (df, inner scope, eq_pairs, other correlated conjs). The caller
        grafts any grouping on top (correlated aggregate subqueries group by
        their correlation keys, never their own GROUP BY)."""
        rels = self._relations(stmt)
        inner_scope = Scope([(r.alias, r.raw_cols) for r in rels])
        inner_conjs, eq_pairs, other = self._split_correlation(
            stmt, inner_scope, outer_scope)
        inner_stmt = A.Select(
            stmt.items, stmt.relations, _and_all(inner_conjs), stmt.group_by,
            stmt.having, (), None, stmt.distinct, stmt.select_star,
            stmt.group_mode)
        sub_df, scope2 = self._plan_from_where(inner_stmt)
        return sub_df, scope2, eq_pairs, other

    def _correlation(self, stmt: A.Select, outer_scope: Scope):
        """(eq_pairs, other) without planning — correlation probe."""
        rels_scope = Scope([
            (_rel_alias(r),
             self._relation_cols(r))
            for item in stmt.relations
            for r in [item.relation if isinstance(item, A.JoinItem) else item]])
        _, eq_pairs, other = self._split_correlation(stmt, rels_scope,
                                                     outer_scope)
        return eq_pairs, other

    def _relation_cols(self, rel: A.Node) -> List[str]:
        if isinstance(rel, A.TableRef):
            if rel.name.lower() in self._ctes:
                return list(self._cte(rel.name)[1])
            return list(self.session.table(rel.name).columns)
        if isinstance(rel, A.SubqueryRef):
            # output names of the derived table (plan-time only, no exec)
            _, names = self.plan(rel.query)
            return names
        if isinstance(rel, A.PivotRef):
            return self._load_pivot(rel).raw_cols
        raise SqlError(f"unsupported FROM item {type(rel).__name__}")

    def _plan_from_where(self, stmt: A.Select):
        """FROM + WHERE only (no projection/agg) — shared by the
        decorrelators, which need the raw join tree."""
        rels = self._relations(stmt)
        scope = Scope([(r.alias, r.raw_cols) for r in rels])
        conjs, join_conds, remaining, sub_preds = [], [], [], []
        nullable = self._nullable_aliases(stmt)
        for c in _conjuncts(stmt.where):
            if _has_subquery(c):
                sub_preds.append(c)
                continue
            aliases = self._aliases_of(c, scope, None)
            if len(aliases) == 1 and next(iter(aliases)) not in nullable:
                a = next(iter(aliases))
                r = next(r for r in rels if r.alias == a)
                r.df = r.df.filter(to_column(
                    c, Scope([(r.alias, r.raw_cols)])))
            elif self._is_equi(c, scope):
                join_conds.append(c)
            else:
                remaining.append(c)
        df, scope = self._fold_joins(stmt, rels, join_conds, scope, None)
        for c in remaining:
            df = df.filter(to_column(c, scope))
        for c in sub_preds:
            df, scope = self._apply_subquery_pred(df, scope, c, None)
        return df, scope

    def _exists(self, df, scope, pred: A.ExistsSubquery):
        if pred.query.group_by or pred.query.having:
            raise SqlError("GROUP BY inside EXISTS is not supported")
        sub_df, in_scope, eq_pairs, other = self._plan_inner(pred.query,
                                                             scope)
        how = "left_anti" if pred.negated else "left_semi"
        if not other:
            pairs = []
            for outer_ast, inner_ast in eq_pairs:
                oc, df = self._key_col(df, outer_ast, scope)
                ic, sub_df = self._key_col(sub_df, inner_ast, in_scope)
                pairs.append((oc, ic))
            if not pairs:
                raise SqlError("uncorrelated EXISTS is not supported")
            return df.join(sub_df, pairs, how)
        # non-equality correlation (Q21 shape): row-id semi/anti join
        rid = self._name("rid")
        df2 = df.withColumn(rid, F.monotonically_increasing_id())
        pairs = []
        for outer_ast, inner_ast in eq_pairs:
            oc, df2 = self._key_col(df2, outer_ast, scope)
            ic, sub_df = self._key_col(sub_df, inner_ast, in_scope)
            pairs.append((oc, ic))
        joined = df2.join(sub_df, pairs) if pairs else df2.crossJoin(sub_df)
        merged = scope.merged(in_scope)
        for c in other:
            joined = joined.filter(to_column(c, merged))
        mrid = self._name("mrid")
        matched = (joined.select(col(rid).alias(mrid)).dropDuplicates())
        out = df2.join(matched, [(rid, mrid)], how)
        keep = [c for c in out.columns if c != rid]
        return out.select(*keep)

    def _in_subquery(self, df, scope, pred: A.InSubquery):
        q = pred.query
        if len(q.items) != 1:
            raise SqlError("IN subquery must select exactly one column")
        how = "left_anti" if pred.negated else "left_semi"
        eq_pairs, other = self._correlation(q, scope)
        if not eq_pairs and not other:
            # uncorrelated: the subquery plans in full (it may group/having/
            # distinct — Q18's HAVING sum(...) > 300 shape)
            sub_df, names = self.plan(q)
            oc, df = self._key_col(df, pred.value, scope)
            if pred.negated:
                # three-valued NOT IN (Catalyst's null-aware anti join): any
                # NULL in the subquery, or a NULL probe value, yields UNKNOWN
                # — the row is filtered unless the subquery is empty
                n, nn = self._name("cnt"), self._name("nulls")
                flags = sub_df.agg(
                    F.count().alias(n),
                    F.sum(F.when(col(names[0]).isNull(), 1).otherwise(0))
                    .alias(nn))
                df = df.crossJoin(flags)
                df = df.filter((col(n) == 0)
                               | (col(oc).isNotNull()
                                  & (F.coalesce(col(nn), F.lit(0)) == 0)))
                df = df.drop(n, nn)
            return df.join(sub_df, [(oc, names[0])], how)
        if q.group_by or q.having:
            raise SqlError("correlated IN subqueries with GROUP BY are not "
                           "supported")
        sub_df, in_scope, eq_pairs, other = self._plan_inner(q, scope)
        if other:
            raise SqlError("non-equality correlation in IN subqueries is "
                           "not supported")
        item = q.items[0].expr
        ic, sub_df = self._key_col(sub_df, item, in_scope)
        oc, df = self._key_col(df, pred.value, scope)
        pairs = [(oc, ic)]
        for outer_ast, inner_ast in eq_pairs:
            o2, df = self._key_col(df, outer_ast, scope)
            i2, sub_df = self._key_col(sub_df, inner_ast, in_scope)
            pairs.append((o2, i2))
        return df.join(sub_df, pairs, how)

    def _lift_scalars(self, df, scope, pred: A.Node):
        """Replace every ScalarSubquery in pred with a hidden column joined
        into df (grouped equi-join when correlated, cross join otherwise)."""
        subs: List[A.ScalarSubquery] = []

        def find(n):
            if isinstance(n, A.ScalarSubquery):
                subs.append(n)
                return
            for f in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, f)
                if isinstance(v, A.Node) and not isinstance(v, A.Select):
                    find(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, A.Node) and not isinstance(x, A.Select):
                            find(x)
        find(pred)
        table: Dict[A.Node, A.Node] = {}
        extras = list(scope.extras)
        for sub in subs:
            q = sub.query
            if len(q.items) != 1:
                raise SqlError("scalar subquery must select one column")
            item = q.items[0].expr
            if not _has_agg(item):
                raise SqlError("scalar subquery must be an aggregate")
            sc = self._name("sc")
            eq_pairs, other = self._correlation(q, scope)
            if other:
                raise SqlError("non-equality correlation in scalar "
                               "subqueries is not supported")
            if not eq_pairs:
                # uncorrelated: full plan (may be an agg over a derived
                # table, Q15's max(total_revenue) shape)
                one, names = self.plan(q)
                if len(names) != 1:
                    raise SqlError("scalar subquery must select one column")
                one = one.select(col(names[0]).alias(sc))
                df = df.crossJoin(one)
            else:
                sub_df, in_scope, eq_pairs, _ = self._plan_inner(q, scope)
                # decompose a compound item (0.2 * avg(x)) into pure
                # aggregates + a post-aggregation projection — the engine's
                # Aggregate takes pure aggregate expressions only
                pure: Dict[A.Node, str] = {}
                _collect_aggs(item, pure, self._name)
                keys = []
                for outer_ast, inner_ast in eq_pairs:
                    ic, sub_df = self._key_col(sub_df, inner_ast, in_scope)
                    keys.append(ic)
                gname = [self._name("ck") for _ in keys]
                grouped = (sub_df.groupBy(
                    *[col(k).alias(g) for k, g in zip(keys, gname)])
                    .agg(*[to_column(ast, in_scope).alias(n)
                           for ast, n in pure.items()]))
                sub_table = {ast: A.ColRef(n) for ast, n in pure.items()}
                post = _NameScope(gname + list(pure.values()))
                grouped = grouped.select(
                    *([col(g) for g in gname]
                      + [to_column(_substitute(item, sub_table), post)
                         .alias(sc)]))
                pairs = []
                for (outer_ast, _), g in zip(eq_pairs, gname):
                    oc, df = self._key_col(df, outer_ast, scope)
                    pairs.append((oc, g))
                df = df.join(grouped, pairs)
            table[sub] = A.ColRef(sc)
            extras.append(sc)
        new_scope = Scope(scope.relations, extras)
        return df, new_scope, _substitute(pred, table)

    # ---- projection / aggregation ------------------------------------------
    def _project_phase(self, stmt: A.Select, df, scope, outer):
        items = list(stmt.items)
        if stmt.select_star:
            out_cols = []
            for alias, cols_ in scope.relations:
                out_cols.extend((f"{alias}.{c}", c) for c in cols_)
            names = [n for _, n in out_cols]

            def star_final(d):
                f = d.select(*[col(q).alias(n) for q, n in out_cols])
                # DISTINCT before ORDER BY/LIMIT (SQL semantics; applying it
                # after would reorder rows and drop past-limit groups)
                return f.dropDuplicates() if stmt.distinct else f

            final = self._order_limit(stmt, df, star_final, names, scope)
            return final, names

        has_agg = bool(stmt.group_by) or any(_has_agg(i.expr) for i in items) \
            or (stmt.having is not None and _has_agg(stmt.having))
        if not has_agg:
            names = [self._out_name(i, k) for k, i in enumerate(items)]
            if stmt.having is not None:
                raise SqlError("HAVING without aggregation")
            sel_scope = scope if outer is None else scope.merged(outer)

            def plain_final(d):
                f = d.select(*[to_column(i.expr, sel_scope).alias(n)
                               for i, n in zip(items, names)])
                # DISTINCT before ORDER BY/LIMIT (SQL semantics; applying it
                # after would reorder rows and drop past-limit groups)
                return f.dropDuplicates() if stmt.distinct else f

            final = self._order_limit(stmt, df, plain_final, names, sel_scope)
            return final, names

        return self._aggregate_phase(stmt, df, scope, items)

    def _aggregate_phase(self, stmt: A.Select, df, scope, items):
        # 1. group keys -> hidden columns
        group_names: List[str] = []
        table: Dict[A.Node, A.Node] = {}
        key_cols = []
        for g in stmt.group_by:
            if isinstance(g, A.Lit) and isinstance(g.value, int) \
                    and not isinstance(g.value, bool):
                # GROUP BY <ordinal> (Spark's groupByOrdinal, on by default)
                v = g.value
                if not (1 <= v <= len(items)):
                    raise SqlError(
                        f"GROUP BY position {v} is not in the select "
                        f"list (1..{len(items)})")
                if _has_agg(items[v - 1].expr):
                    raise SqlError(
                        f"GROUP BY position {v} is an aggregate function")
                g = items[v - 1].expr
            if isinstance(g, A.ColRef):
                name = scope.resolve(g)
                key_cols.append(col(name))
                group_names.append(name)
                table[g] = A.ColRef(name)
            else:
                name = self._name("g")
                key_cols.append(to_column(g, scope).alias(name))
                group_names.append(name)
                table[g] = A.ColRef(name)

        # 2. aggregate calls -> hidden columns (dedup structurally)
        aggs: Dict[A.Node, str] = {}

        def collect(n):
            if isinstance(n, A.WindowFuncCall):
                # the window's own function is evaluated post-aggregation;
                # only aggregates INSIDE it (its args / its spec) are query
                # aggregates needing hidden columns
                for a in n.func.args:
                    collect(a)
                collect(n.spec)
                return
            if isinstance(n, A.FuncCall) and n.name in _AGGS:
                if n not in aggs:
                    aggs[n] = self._name("a")
                return
            if isinstance(n, (A.ScalarSubquery, A.ExistsSubquery,
                              A.InSubquery)):
                return
            for f in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, f)
                if isinstance(v, A.Node):
                    collect(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, A.Node):
                            collect(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, A.Node):
                                    collect(y)
        for i in items:
            collect(i.expr)
        if stmt.having is not None:
            collect(stmt.having)
        for o in stmt.order_by:
            collect(o.expr)

        agg_cols = [to_column(ast, scope).alias(name)
                    for ast, name in aggs.items()]
        if key_cols:
            by = {"groupby": df.groupBy, "rollup": df.rollup,
                  "cube": df.cube}[stmt.group_mode]
            grouped = by(*key_cols).agg(*agg_cols)
        else:
            grouped = df.agg(*agg_cols)

        # 3. post-agg scope: group columns stay addressable by qualified or
        # plain name, agg results by their hidden names
        for ast, name in aggs.items():
            table[ast] = A.ColRef(name)
        post_scope = _PostAggScope(group_names, list(aggs.values()))

        # 4. HAVING
        out = grouped
        if stmt.having is not None:
            having = _substitute(stmt.having, table)
            if _has_subquery(having):
                out, post_scope, having = self._lift_scalars(
                    out, post_scope, having)
            out = out.filter(to_column(having, post_scope))

        # 5. SELECT
        names = [self._out_name(i, k) for k, i in enumerate(items)]

        def make_final(d):
            sel = [to_column(_substitute(i.expr, table), post_scope).alias(n)
                   for i, n in zip(items, names)]
            f = d.select(*sel)
            return f.dropDuplicates() if stmt.distinct else f

        # ORDER BY resolves against output aliases first, then the
        # substituted post-agg scope (sorting before the projection)
        final = self._order_limit(stmt, out, make_final, names, post_scope,
                                  table)
        return final, names

    def _out_name(self, item: A.SelectItem, k: int) -> str:
        if item.alias:
            return item.alias
        if isinstance(item.expr, A.ColRef):
            return item.expr.name
        return f"_c{k}"

    def _order_limit(self, stmt: A.Select, pre_df, make_final, names,
                     pre_scope, table: Optional[Dict] = None):
        """Sort after the projection when every key names a select output;
        otherwise sort the pre-projection frame (projection preserves row
        order) so ORDER BY may reference non-selected columns."""
        if not stmt.order_by:
            final = make_final(pre_df)
        else:
            # ORDER BY <ordinal> names the select-list position (Spark's
            # orderByOrdinal, on by default): the output-name form serves
            # the post-projection sort, the underlying select expression
            # serves the pre-projection branch (where output aliases do
            # not exist yet)
            order_out, order_pre = [], []
            for o in stmt.order_by:
                if isinstance(o.expr, A.Lit) \
                        and isinstance(o.expr.value, int) \
                        and not isinstance(o.expr.value, bool):
                    v = o.expr.value
                    if not (1 <= v <= len(names)):
                        raise SqlError(
                            f"ORDER BY position {v} is not in the select "
                            f"list (1..{len(names)})")
                    order_out.append(A.OrderItem(A.ColRef(names[v - 1]),
                                                 o.ascending, o.nulls_first))
                    pre_expr = (stmt.items[v - 1].expr
                                if v - 1 < len(stmt.items) else o.expr)
                    order_pre.append(A.OrderItem(pre_expr, o.ascending,
                                                 o.nulls_first))
                else:
                    order_out.append(o)
                    order_pre.append(o)
            out_scope = _NameScope(names)
            orders = []
            resolved_out = True
            for o in order_out:
                try:
                    orders.append(self._order_col(o, o.expr, out_scope))
                except (KeyError, SqlError):
                    resolved_out = False
                    break
            if resolved_out:
                final = make_final(pre_df).sort(*orders)
            else:
                if stmt.distinct:
                    # the pre-projection sort would be destroyed by the
                    # dedup group-by; Spark rejects this shape too
                    raise SqlError(
                        "ORDER BY with SELECT DISTINCT must reference "
                        "columns in the select list")
                orders = []
                for o in order_pre:
                    e = _substitute(o.expr, table) if table else o.expr
                    orders.append(self._order_col(o, e, pre_scope))
                final = make_final(pre_df.sort(*orders))
        if stmt.limit is not None:
            final = final.limit(stmt.limit)
        return final

    def _order_col(self, o: A.OrderItem, expr: A.Node, scope) -> Column:
        c = to_column(expr, scope)
        if o.nulls_first is None:
            return c.asc() if o.ascending else c.desc()
        from spark_rapids_tpu_torch.exprs.misc import SortOrder as ESortOrder
        return Column(ESortOrder(c.expr, o.ascending, o.nulls_first))


class _NameScope(Scope):
    def __init__(self, names):
        super().__init__([], extras=list(names))

    def resolve(self, ref: A.ColRef) -> str:
        # a qualified ref resolves by its base name (the projection has
        # already stripped qualifiers from the output)
        if ref.name in self.extras:
            return ref.name
        raise KeyError(ref.name)


class _PostAggScope(Scope):
    """Scope over a grouped dataframe: group columns keep their pre-agg
    names (qualified 'alias.col' or hidden '__gN'), agg results are hidden
    '__aN' columns. A ColRef resolves if it names a group column in either
    qualified or unqualified form."""

    def __init__(self, group_names, agg_names):
        super().__init__([], extras=list(group_names) + list(agg_names))
        self.group_names = list(group_names)

    def resolve(self, ref: A.ColRef) -> str:
        if ref.qualifier is not None:
            q = f"{ref.qualifier}.{ref.name}"
            if q in self.extras:
                return q
            raise KeyError(q)
        if ref.name in self.extras:
            return ref.name
        hits = [g for g in self.group_names
                if g.split(".", 1)[-1] == ref.name]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SqlError(f"ambiguous column {ref.name!r}: {hits}")
        raise KeyError(ref.name)


def _and_all(conjs: List[A.Node]) -> Optional[A.Node]:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = A.BinOp("and", out, c)
    return out


def _collect_aggs(node: A.Node, out: Dict[A.Node, str], namer) -> None:
    """Collect aggregate FuncCalls (structurally deduped) into out."""
    if isinstance(node, A.FuncCall) and node.name in _AGGS:
        if node not in out:
            out[node] = namer("a")
        return
    if isinstance(node, (A.ScalarSubquery, A.ExistsSubquery, A.InSubquery)):
        return
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, A.Node):
            _collect_aggs(v, out, namer)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, A.Node):
                    _collect_aggs(x, out, namer)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, A.Node):
                            _collect_aggs(y, out, namer)
