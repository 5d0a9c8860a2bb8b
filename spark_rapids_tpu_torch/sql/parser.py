"""SQL parser + analyzer: SELECT text -> logical plan (via DataFrame).

Counterpart of spark_rapids_tpu/sql/parser.py, copied with its imports
re-pointed at this port. The parser (text -> neutral AST) is the JAX
package's unchanged. The analyzer is too, for what this port has: it
resolves names against the session catalog / FROM scope, plans
comma-joins from WHERE equi-conjuncts (left-deep, single-table filters
pushed below the joins), splits aggregates out of SELECT/HAVING/ORDER
BY, and lowers everything onto the Expression / LogicalPlan layer.

Subquery predicates lower onto joins as the JAX analyzer lowers them:
EXISTS / NOT EXISTS / IN onto semi and anti joins, NOT IN onto a
NULL-aware anti join, EXISTS with a non-equi correlation through row
ids, EXISTS / IN under OR and correlated scalar subqueries onto left
outer joins; uncorrelated EXISTS, NOT IN's counts and uncorrelated
scalar subqueries run while the text is analyzed, on the session's
device. GROUPING SETS / ROLLUP / CUBE lower onto an Expand and a
grouping on (keys, ``__grouping_id``); ``COUNT(DISTINCT x)`` onto
``size(collect_set(x))``.

Its function tables hold the JAX package's scalar library: string,
regex, date, time-zone, math, hash and integral-arithmetic functions,
LIKE, ``date +/- INTERVAL n DAY|WEEK|MONTH|YEAR``, ``div``, ``%``,
``||``, string ordering, TIMESTAMP literals and casts, ``first`` /
``last``, and the DECIMAL(p, s) / NUMERIC(p, s) type in CAST (numeric
literals keep the JAX parser's typing: ``0.05`` is DOUBLE, where Spark
types it DECIMAL(2,2); ROADMAP.md C14). A function, clause or type the
JAX package's analyzer refuses (INTERSECT / EXCEPT ALL) raises
``SqlError`` saying so, before any plan is built; so does a time zone
or cast the port cannot run. What the planner sends to the CPU engine
(a regex the device refuses, a DECIMAL(p>18) to or from STRING, stddev
/ variance over a window, ``from_json`` / ``to_json``) is lowered as
the JAX analyzer lowers it. The bitwise operators and functions, the
percentiles, ``uuid``, ``raise_error``, ``version`` and
``spark_partition_id`` are not in the JAX analyzer, so they stay in
the DataFrame API here too.
"""

from __future__ import annotations

import copy
import datetime
from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from ..expr import aggregates as Agg
from ..expr import arithmetic as A
from ..expr import bitwise as Bit
from ..expr import collections as Coll
from ..expr import conditional as Cond
from ..expr import datetime as D
from ..expr import hashing as H
from ..expr import mathfns as M
from ..expr import predicates as P
from ..expr import strings as S
from ..expr import window as W
from ..expr.cast import Cast
from ..expr.core import Alias, ColumnRef, Expression, Literal, col, lit, \
    output_name
from ..expr.misc import monotonically_increasing_id
from .lexer import Token, tokenize



class SqlError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Ast:
    pass


def _ast_repr(a) -> str:
    """Canonical structural repr for AST equality (GROUP BY dedupe,
    correlated-conjunct matching)."""
    if isinstance(a, Ast) or type(a).__name__ in (
            "TableRefA", "SubqueryA", "JoinA", "SelectA", "UnionA",
            "SetOpA"):
        items = sorted(vars(a).items())
        body = ", ".join(f"{k}={_ast_repr(v)}" for k, v in items)
        return f"{type(a).__name__}({body})"
    if isinstance(a, (list, tuple)):
        return "[" + ", ".join(_ast_repr(x) for x in a) + "]"
    return repr(a)


class ColA(Ast):
    def __init__(self, name, qualifier=None):
        self.name = name
        self.qualifier = qualifier


class StarA(Ast):
    def __init__(self, qualifier=None):
        self.qualifier = qualifier


class LitA(Ast):
    def __init__(self, value):
        self.value = value


class IntervalA(Ast):
    def __init__(self, n, unit):
        self.n = n
        self.unit = unit


class FnA(Ast):
    def __init__(self, name, args, star=False, distinct=False):
        self.name = name
        self.args = args
        self.star = star
        self.distinct = distinct


class BinA(Ast):
    def __init__(self, op, l, r):
        self.op = op
        self.l = l
        self.r = r


class UnA(Ast):
    def __init__(self, op, e):
        self.op = op
        self.e = e


class BetweenA(Ast):
    def __init__(self, e, lo, hi, neg):
        self.e, self.lo, self.hi, self.neg = e, lo, hi, neg


class InA(Ast):
    def __init__(self, e, items, neg):
        self.e, self.items, self.neg = e, items, neg


class LikeA(Ast):
    def __init__(self, e, pattern, neg):
        self.e, self.pattern, self.neg = e, pattern, neg


class IsNullA(Ast):
    def __init__(self, e, neg):
        self.e, self.neg = e, neg


class CaseA(Ast):
    def __init__(self, branches, els):
        self.branches, self.els = branches, els


class CastA(Ast):
    def __init__(self, e, to):
        self.e, self.to = e, to


class OverA(Ast):
    """fn OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE BETWEEN ...])"""

    def __init__(self, fn, partition, order, frame):
        self.fn = fn
        self.partition = partition    # [Ast]
        self.order = order            # [(Ast, asc, nulls_first)]
        self.frame = frame            # (row_based, lo, hi) | None


class ScalarSubqueryA(Ast):
    def __init__(self, stmt):
        self.stmt = stmt


class _PreLowered(Ast):
    """AST leaf carrying an already-lowered Expression (injected by the
    subquery rewrites); ``lower`` unwraps it."""

    def __init__(self, expr):
        self.expr = expr


def _and_all(conjs):
    out = None
    for c in conjs:
        out = c if out is None else BinA("and", out, c)
    return out


class _GroupingMarker(Expression):
    """GROUPING(key) placeholder; the aggregate-lowering replace() pass
    resolves it to a bit of __grouping_id (0 for plain GROUP BY)."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema) -> dt.DType:
        return dt.INT64


class ExistsA(Ast):
    """EXISTS (subquery) — possibly correlated."""

    def __init__(self, stmt):
        self.stmt = stmt


class InSubqueryA(Ast):
    """expr IN (subquery) — possibly correlated."""

    def __init__(self, e, stmt, neg):
        self.e = e
        self.stmt = stmt
        self.neg = neg


class TableRefA:
    def __init__(self, name, alias):
        self.name = name
        self.alias = alias or name


class SubqueryA:
    def __init__(self, stmt, alias):
        self.stmt = stmt
        self.alias = alias


class JoinA:
    def __init__(self, ref, how, on):
        self.ref = ref      # TableRefA | SubqueryA
        self.how = how      # None (comma) | inner|left|right|full|cross
        self.on = on


class SelectA:
    def __init__(self):
        self.distinct = False
        self.items: List[Tuple[Ast, Optional[str]]] = []
        self.from_: List[JoinA] = []
        self.where: Optional[Ast] = None
        self.group_by: List[Ast] = []
        #: GROUPING SETS / ROLLUP / CUBE: list of grouping sets, each a
        #: list of indexes into group_by; None = plain GROUP BY
        self.group_sets: Optional[List[List[int]]] = None
        self.having: Optional[Ast] = None
        self.order_by: List[Tuple[Ast, bool, Optional[bool]]] = []
        self.limit: Optional[int] = None
        #: WITH name AS (...) bindings visible to this statement
        self.ctes: List[Tuple[str, "Ast"]] = []


class UnionA:
    def __init__(self, left, right, all_):
        self.left, self.right, self.all = left, right, all_
        self.order_by: List = []
        self.limit = None
        self.ctes: List = []


class SetOpA:
    """INTERSECT / EXCEPT (set semantics follow ``all``)."""

    def __init__(self, op, left, right, all_):
        self.op = op            # "intersect" | "except"
        self.left, self.right, self.all = left, right, all_
        self.order_by: List = []
        self.limit = None
        self.ctes: List = []


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_JOIN_KINDS = {"inner": "inner", "left": "left", "right": "right",
               "full": "full", "cross": "cross"}


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # --- token helpers ---
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.value.lower() in kws

    def accept_kw(self, *kws: str) -> Optional[str]:
        if self.at_kw(*kws):
            return self.next().value.lower()
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlError(f"expected {kw.upper()} near "
                           f"{self.peek().value!r} @{self.peek().pos}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_op(self, *ops: str) -> Optional[str]:
        if self.at_op(*ops):
            return self.next().value
        return None

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r} near {self.peek().value!r} "
                           f"@{self.peek().pos}")

    # --- statements ---
    def parse_statement(self):
        stmt = self.parse_set_expr()
        self.accept_op(";")
        if self.peek().kind != "EOF":
            raise SqlError(f"unexpected trailing input "
                           f"{self.peek().value!r} @{self.peek().pos}")
        return stmt

    def parse_set_expr(self):
        """[WITH ...] select-term {UNION|EXCEPT [ALL] select-term}
        with INTERSECT binding tighter (SQL precedence), then trailing
        ORDER BY / LIMIT on the whole set expression."""
        ctes = []
        if self.accept_kw("with"):
            while True:
                name = self.next().value
                self.expect_kw("as")
                self.expect_op("(")
                sub = self.parse_set_expr()
                self.expect_op(")")
                ctes.append((name, sub))
                if not self.accept_op(","):
                    break
        stmt = self.parse_intersect_term()
        while self.at_kw("union", "except", "minus"):
            op = self.next().value.lower()
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self.parse_intersect_term()
            if op == "union":
                u = UnionA(stmt, right, all_)
            else:
                u = SetOpA("except", stmt, right, all_)
            self._hoist_order_limit(u, right)
            stmt = u
        # trailing ORDER BY / LIMIT apply to the whole set expression
        if self.at_kw("order"):
            stmt.order_by = self.parse_order_by()
        if self.accept_kw("limit"):
            stmt.limit = int(self.next().value)
        stmt.ctes = ctes + getattr(stmt, "ctes", [])
        return stmt

    # select-terms that came from "( ... )": their ORDER BY/LIMIT are
    # legitimately inner and must NOT hoist to the set expression
    _parenthesized: set = None

    def _hoist_order_limit(self, u, right) -> None:
        """A trailing ORDER BY/LIMIT greedily parsed into the LAST
        unparenthesized branch binds to the whole set expression."""
        if id(right) in (self._parenthesized or ()):
            return
        if isinstance(right, (SelectA, UnionA, SetOpA)):
            u.order_by, right.order_by = right.order_by, []
            u.limit, right.limit = right.limit, None

    def parse_intersect_term(self):
        stmt = self.parse_select_term()
        while self.at_kw("intersect"):
            self.next()
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self.parse_select_term()
            u = SetOpA("intersect", stmt, right, all_)
            self._hoist_order_limit(u, right)
            stmt = u
        return stmt

    def parse_select_term(self):
        if self.at_op("("):
            self.next()
            inner = self.parse_set_expr()
            self.expect_op(")")
            if self._parenthesized is None:
                self._parenthesized = set()
            self._parenthesized.add(id(inner))
            return inner
        return self.parse_select_core()

    def parse_select_core(self) -> SelectA:
        self.expect_kw("select")
        s = SelectA()
        if self.accept_kw("distinct"):
            s.distinct = True
        else:
            self.accept_kw("all")
        # select list
        while True:
            item = self.parse_expr()
            alias = None
            if self.accept_kw("as"):
                alias = self.next().value
            elif self.peek().kind == "IDENT" and not self.at_kw(
                    "from", "where", "group", "having", "order", "limit",
                    "union", "except", "minus", "intersect",
                    "inner", "left", "right", "full", "cross",
                    "join", "on"):
                alias = self.next().value
            s.items.append((item, alias))
            if not self.accept_op(","):
                break
        if self.accept_kw("from"):
            s.from_.append(JoinA(self.parse_table_ref(), None, None))
            while True:
                if self.accept_op(","):
                    s.from_.append(JoinA(self.parse_table_ref(), None, None))
                    continue
                how = None
                for kw, mapped in _JOIN_KINDS.items():
                    if self.at_kw(kw):
                        self.next()
                        how = mapped
                        break
                if how in ("left", "right", "full"):
                    self.accept_kw("outer")
                if how is not None:
                    self.expect_kw("join")
                elif self.at_kw("join"):
                    self.next()
                    how = "inner"
                else:
                    break
                ref = self.parse_table_ref()
                on = None
                if how != "cross" and self.accept_kw("on"):
                    on = self.parse_expr()
                s.from_.append(JoinA(ref, how, on))
        if self.accept_kw("where"):
            s.where = self.parse_expr()
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            self._parse_group_by(s)
        if self.accept_kw("having"):
            s.having = self.parse_expr()
        if self.at_kw("order") and self._lookahead_is_order_by():
            s.order_by = self.parse_order_by()
        if self.accept_kw("limit"):
            s.limit = int(self.next().value)
        return s

    def _parse_group_by(self, s: SelectA) -> None:
        """Plain exprs, optionally mixed with ONE of ROLLUP(...),
        CUBE(...), GROUPING SETS((...),...). ``s.group_by`` collects the
        distinct key exprs in order; ``s.group_sets`` (when non-plain)
        holds index lists into group_by per output grouping set, with
        plain exprs present in every set."""
        base: List[Ast] = []
        construct = None  # (kind, [expr or [exprs]])
        while True:
            if self.at_kw("rollup", "cube"):
                if construct is not None:
                    raise SqlError("multiple ROLLUP/CUBE/GROUPING SETS "
                                   "constructs in one GROUP BY are not "
                                   "supported")
                kind = self.next().value.lower()
                self.expect_op("(")
                exprs = [self.parse_expr()]
                while self.accept_op(","):
                    exprs.append(self.parse_expr())
                self.expect_op(")")
                construct = (kind, exprs)
            elif self.at_kw("grouping"):
                if construct is not None:
                    raise SqlError("multiple ROLLUP/CUBE/GROUPING SETS "
                                   "constructs in one GROUP BY are not "
                                   "supported")
                self.next()
                self.expect_kw("sets")
                self.expect_op("(")
                sets = []
                while True:
                    if self.accept_op("("):
                        grp = []
                        if not self.at_op(")"):
                            grp.append(self.parse_expr())
                            while self.accept_op(","):
                                grp.append(self.parse_expr())
                        self.expect_op(")")
                        sets.append(grp)
                    else:
                        sets.append([self.parse_expr()])
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                construct = ("sets", sets)
            else:
                base.append(self.parse_expr())
            if not self.accept_op(","):
                break
        if construct is None:
            s.group_by = base
            return
        kind, payload = construct
        if kind == "rollup":
            variable = [payload[:i] for i in range(len(payload), -1, -1)]
        elif kind == "cube":
            variable = []
            n = len(payload)
            for m in range((1 << n) - 1, -1, -1):
                variable.append([payload[i] for i in range(n)
                                 if m & (1 << (n - 1 - i))])
        else:
            variable = payload
        # distinct keys in first-appearance order; sets as index lists
        keys: List[Ast] = list(base)

        def key_idx(e: Ast) -> int:
            for i, k in enumerate(keys):
                if _ast_repr(k) == _ast_repr(e):
                    return i
            keys.append(e)
            return len(keys) - 1
        base_idx = [key_idx(e) for e in base]
        sets_idx = []
        for grp in variable:
            sets_idx.append(base_idx + [key_idx(e) for e in grp])
        s.group_by = keys
        s.group_sets = sets_idx

    def _lookahead_is_order_by(self) -> bool:
        t = self.toks[self.i + 1]
        return t.kind == "IDENT" and t.value.lower() == "by"

    def parse_order_by(self):
        self.expect_kw("order")
        self.expect_kw("by")
        out = []
        while True:
            e = self.parse_expr()
            asc = True
            if self.accept_kw("desc"):
                asc = False
            else:
                self.accept_kw("asc")
            nulls_first = None
            if self.accept_kw("nulls"):
                which = self.next().value.lower()
                nulls_first = which == "first"
            out.append((e, asc, nulls_first))
            if not self.accept_op(","):
                break
        return out

    def _maybe_over(self, fn: FnA) -> Ast:
        if not self.at_kw("over"):
            return fn
        self.next()
        self.expect_op("(")
        partition = []
        order = []
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        if self.at_kw("order"):
            order = self.parse_order_by()
        kind = self.accept_kw("rows", "range")
        if kind:
            self.expect_kw("between")
            lo = self._parse_frame_bound()
            self.expect_kw("and")
            hi = self._parse_frame_bound()
            frame = (kind == "rows", lo, hi)
        self.expect_op(")")
        return OverA(fn, partition, order, frame)

    def _parse_frame_bound(self):
        """UNBOUNDED PRECEDING/FOLLOWING | CURRENT ROW | n PRECEDING |
        n FOLLOWING -> None or signed int offset."""
        if self.accept_kw("unbounded"):
            self.next()  # preceding / following
            return None
        if self.accept_kw("current"):
            self.expect_kw("row")
            return 0
        t = self.next()
        if t.kind != "NUMBER":
            raise SqlError(f"bad frame bound {t.value!r}")
        n = int(t.value)
        which = self.next().value.lower()
        return -n if which == "preceding" else n

    def parse_table_ref(self):
        if self.accept_op("("):
            stmt = self.parse_set_expr()
            self.expect_op(")")
            if self.accept_kw("as"):
                alias = self.next().value
            elif self.peek().kind == "IDENT" and not self.at_kw(
                    "where", "group", "having", "order", "limit", "union",
                    "except", "minus", "intersect",
                    "inner", "left", "right", "full", "cross", "join",
                    "on"):
                alias = self.next().value
            else:
                alias = f"__subq{self.i}"
            return SubqueryA(stmt, alias)
        name = self.next().value
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek().kind == "IDENT" and not self.at_kw(
                "where", "group", "having", "order", "limit", "union",
                "except", "minus", "intersect",
                "inner", "left", "right", "full", "cross", "join", "on"):
            alias = self.next().value
        return TableRefA(name, alias)

    # --- expressions (precedence climbing) ---
    def parse_expr(self) -> Ast:
        return self.parse_or()

    def parse_or(self) -> Ast:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = BinA("or", e, self.parse_and())
        return e

    def parse_and(self) -> Ast:
        e = self.parse_not()
        while self.accept_kw("and"):
            e = BinA("and", e, self.parse_not())
        return e

    def parse_not(self) -> Ast:
        if self.accept_kw("not"):
            return UnA("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Ast:
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            stmt = self.parse_set_expr()
            self.expect_op(")")
            return ExistsA(stmt)
        e = self.parse_additive()
        neg = bool(self.accept_kw("not"))
        if self.accept_kw("between"):
            lo = self.parse_additive()
            self.expect_kw("and")
            hi = self.parse_additive()
            return BetweenA(e, lo, hi, neg)
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.at_kw("select", "with"):
                stmt = self.parse_set_expr()
                self.expect_op(")")
                return InSubqueryA(e, stmt, neg)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return InA(e, items, neg)
        if self.accept_kw("like"):
            pat = self.next()
            if pat.kind != "STRING":
                raise SqlError("LIKE pattern must be a string literal")
            return LikeA(e, pat.value, neg)
        if self.accept_kw("rlike", "regexp"):
            pat = self.next()
            if pat.kind != "STRING":
                raise SqlError("RLIKE pattern must be a string literal")
            return FnA("rlike", [e, LitA(pat.value)]) if not neg else \
                UnA("not", FnA("rlike", [e, LitA(pat.value)]))
        if neg:
            raise SqlError("dangling NOT before non-predicate")
        if self.accept_kw("is"):
            isneg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return IsNullA(e, isneg)
        op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
        if op:
            return BinA(op, e, self.parse_additive())
        return e

    def parse_additive(self) -> Ast:
        e = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-", "||")
            if not op:
                return e
            e = BinA(op, e, self.parse_multiplicative())

    def parse_multiplicative(self) -> Ast:
        e = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                if self.at_kw("div"):  # integral division keyword op
                    self.next()
                    e = BinA("div", e, self.parse_unary())
                    continue
                return e
            e = BinA(op, e, self.parse_unary())

    def parse_unary(self) -> Ast:
        if self.accept_op("-"):
            t = self.peek()
            if t.kind == "NUMBER":
                # fold the sign into the literal (Spark's AST visitor does
                # this so Long.MinValue is a VALID literal rather than
                # -(9223372036854775808) overflowing to decimal)
                self.next()
                if "." in t.value or "e" in t.value.lower():
                    return LitA(-float(t.value))
                return LitA(-int(t.value))
            return UnA("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Ast:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return LitA(float(t.value))
            return LitA(int(t.value))
        if t.kind == "STRING":
            self.next()
            return LitA(t.value)
        if t.kind == "OP" and t.value == "(":
            self.next()
            if self.at_kw("select", "with"):
                stmt = self.parse_set_expr()
                self.expect_op(")")
                return ScalarSubqueryA(stmt)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "OP" and t.value == "*":
            self.next()
            return StarA()
        if t.kind != "IDENT":
            raise SqlError(f"unexpected token {t.value!r} @{t.pos}")
        word = t.value
        lower = word.lower()
        # typed literals
        if lower == "date" and self.toks[self.i + 1].kind == "STRING":
            self.next()
            s = self.next().value
            return LitA(datetime.date.fromisoformat(s))
        if lower == "timestamp" and self.toks[self.i + 1].kind == "STRING":
            self.next()
            s = self.next().value
            v = datetime.datetime.fromisoformat(s)
            if v.tzinfo is None:
                v = v.replace(tzinfo=datetime.timezone.utc)
            return LitA(v)
        if lower == "interval":
            self.next()
            nt = self.next()
            if nt.kind == "STRING":
                n = int(nt.value)
            elif nt.kind == "NUMBER":
                n = int(nt.value)
            else:
                raise SqlError("bad INTERVAL quantity")
            unit = self.next().value.lower().rstrip("s")
            return IntervalA(n, unit)
        if lower in ("true", "false"):
            self.next()
            return LitA(lower == "true")
        if lower == "null":
            self.next()
            return LitA(None)
        if lower == "case":
            return self.parse_case()
        if lower == "cast":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            to = self.parse_type()
            self.expect_op(")")
            return CastA(e, to)
        if lower == "extract":
            self.next()
            self.expect_op("(")
            field = self.next().value.lower()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return FnA(field, [e])
        self.next()
        # function call?
        if self.at_op("("):
            self.next()
            if self.accept_op("*"):
                self.expect_op(")")
                return self._maybe_over(FnA(lower, [], star=True))
            if self.at_op(")"):
                self.next()
                return self._maybe_over(FnA(lower, []))
            distinct = bool(self.accept_kw("distinct"))
            args = [self.parse_expr()]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return self._maybe_over(FnA(lower, args, distinct=distinct))
        # qualified name / star
        if self.at_op("."):
            self.next()
            if self.accept_op("*"):
                return StarA(qualifier=word)
            return ColA(self.next().value, qualifier=word)
        return ColA(word)

    def parse_case(self) -> Ast:
        self.expect_kw("case")
        branches = []
        base = None
        if not self.at_kw("when"):
            base = self.parse_expr()
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            if base is not None:
                cond = BinA("=", base, cond)
            branches.append((cond, val))
        els = None
        if self.accept_kw("else"):
            els = self.parse_expr()
        self.expect_kw("end")
        return CaseA(branches, els)

    def parse_type(self) -> dt.DType:
        name = self.next().value.lower()
        simple = {
            "boolean": dt.BOOL, "bool": dt.BOOL,
            "tinyint": dt.INT8, "byte": dt.INT8,
            "smallint": dt.INT16, "short": dt.INT16,
            "int": dt.INT32, "integer": dt.INT32,
            "bigint": dt.INT64, "long": dt.INT64,
            "float": dt.FLOAT32, "real": dt.FLOAT32,
            "double": dt.FLOAT64,
            "string": dt.STRING, "varchar": dt.STRING, "text": dt.STRING,
            "date": dt.DATE, "timestamp": dt.TIMESTAMP,
        }
        if name in simple:
            if name == "varchar" and self.accept_op("("):
                self.next()
                self.expect_op(")")
            return simple[name]
        if name in ("decimal", "numeric", "dec"):
            p, sc = 10, 0
            if self.accept_op("("):
                p = int(self.next().value)
                if self.accept_op(","):
                    sc = int(self.next().value)
                self.expect_op(")")
            try:
                return dt.DecimalType(p, sc)
            except TypeError as e:
                raise SqlError(str(e)) from e
        raise SqlError(f"unknown type {name!r}")


# ---------------------------------------------------------------------------
# Analyzer: AST -> DataFrame
# ---------------------------------------------------------------------------

_AGG_FNS = {
    "sum": Agg.Sum, "min": Agg.Min, "max": Agg.Max,
    "avg": Agg.Average, "mean": Agg.Average,
    "stddev": Agg.StddevSamp, "stddev_samp": Agg.StddevSamp,
    "stddev_pop": Agg.StddevPop,
    "variance": Agg.VarianceSamp, "var_samp": Agg.VarianceSamp,
    "var_pop": Agg.VariancePop,
    "first": Agg.First, "last": Agg.Last,
    "collect_list": Agg.CollectList, "collect_set": Agg.CollectSet,
}

_UNARY_FNS = {
    "abs": A.Abs, "sqrt": M.Sqrt, "cbrt": M.Cbrt, "exp": M.Exp,
    "ln": M.Log, "log": M.Log, "log2": M.Log2, "log10": M.Log10,
    "sin": M.Sin, "cos": M.Cos, "tan": M.Tan, "asin": M.Asin,
    "acos": M.Acos, "atan": M.Atan, "sinh": M.Sinh, "cosh": M.Cosh,
    "tanh": M.Tanh, "degrees": M.ToDegrees, "radians": M.ToRadians,
    "sign": M.Signum, "signum": M.Signum, "floor": M.Floor,
    "ceil": M.Ceil, "ceiling": M.Ceil,
    "length": S.Length, "char_length": S.Length,
    "octet_length": S.OctetLength,
    "upper": S.Upper, "ucase": S.Upper, "lower": S.Lower,
    "lcase": S.Lower, "trim": S.StringTrim, "ltrim": S.StringTrimLeft,
    "rtrim": S.StringTrimRight, "reverse": S.Reverse,
    "initcap": S.InitCap, "isnan": P.IsNaN,
    "year": D.Year, "month": D.Month, "day": D.DayOfMonth,
    "dayofmonth": D.DayOfMonth, "quarter": D.Quarter,
    "dayofweek": D.DayOfWeek, "dayofyear": D.DayOfYear,
    "weekday": D.WeekDay, "last_day": D.LastDay,
    "hour": D.Hour, "minute": D.Minute, "second": D.Second,
}

_BINARY_FNS = {
    "pow": M.Pow, "power": M.Pow, "atan2": M.Atan2, "hypot": M.Hypot,
    "pmod": A.Pmod, "date_add": D.DateAdd, "date_sub": D.DateSub,
    "datediff": D.DateDiff, "add_months": D.AddMonths,
    "nullif": Cond.NullIf, "nvl": Cond.Nvl, "ifnull": Cond.Nvl,
}

_VARARG_FNS = {
    "concat": S.Concat, "coalesce": Cond.Coalesce,
    "least": A.Least, "greatest": A.Greatest,
    "hash": H.Murmur3Hash, "xxhash64": H.XxHash64,
}

#: the field functions that read a timestamp's wall clock in the
#: session time zone
_TS_FIELD_FNS = frozenset({"hour", "minute", "second", "year", "month",
                           "day", "dayofmonth", "quarter", "dayofweek",
                           "dayofyear", "weekday", "last_day"})

class _Scope:
    """FROM-clause name resolution.

    Entries are ``(alias, [(user_name, internal_name)])``: when two FROM
    tables share a column name, the analyzer renames the physical
    columns to unique internal names before joining (our plans use flat
    column names), and this mapping resolves qualified references to the
    right copy."""

    def __init__(self, entries, types=None):
        self.entries = list(entries)
        #: internal column name -> DType (for type-dependent lowering)
        self.types = dict(types or {})

    def type_schema(self):
        return list(self.types.items())

    def resolve(self, name: str, qualifier: Optional[str]) -> str:
        if qualifier is not None:
            for alias, cols in self.entries:
                if alias.lower() == qualifier.lower():
                    for user, internal in cols:
                        if user.lower() == name.lower():
                            return internal
                    raise SqlError(f"column {qualifier}.{name} not found")
            raise SqlError(f"unknown table alias {qualifier!r}")
        hits = []
        for alias, cols in self.entries:
            for user, internal in cols:
                if user.lower() == name.lower():
                    hits.append(internal)
                    break
        if not hits:
            raise SqlError(f"column {name!r} not found in scope "
                           f"{[a for a, _ in self.entries]}")
        if len(set(hits)) > 1:
            raise SqlError(f"ambiguous column {name!r}")
        return hits[0]

    def all_columns(self, qualifier: Optional[str] = None):
        """[(user_name, internal_name)] for star expansion."""
        out = []
        for alias, cols in self.entries:
            if qualifier is None or alias.lower() == qualifier.lower():
                out.extend(cols)
        if not out:
            raise SqlError(f"unknown table alias {qualifier!r}")
        return out


class Analyzer:
    def __init__(self, session):
        self.session = session
        #: WITH-binding scopes, innermost last (CTEs see earlier CTEs)
        self._cte_frames: List[dict] = []

    # --- entry ---
    def analyze(self, stmt):
        ctes = getattr(stmt, "ctes", [])
        frame = {}
        if ctes:
            self._cte_frames.append(frame)
            for name, sub in ctes:
                frame[name.lower()] = self.analyze(sub)
        try:
            return self._analyze_body(stmt)
        finally:
            if ctes:
                self._cte_frames.pop()

    def _analyze_body(self, stmt):
        if isinstance(stmt, (UnionA, SetOpA)):
            left = self.analyze_select(stmt.left) if \
                isinstance(stmt.left, SelectA) else self.analyze(stmt.left)
            right = self.analyze_select(stmt.right) if \
                isinstance(stmt.right, SelectA) else self.analyze(stmt.right)
            if isinstance(stmt, UnionA):
                df = left.union(right)
                if not stmt.all:
                    df = df.distinct()
            else:
                df = self._set_op(left, right, stmt.op, stmt.all)
            return self._order_limit(df, stmt.order_by, stmt.limit,
                                     scope=None)
        return self.analyze_select(stmt)

    def _set_op(self, left, right, op: str, all_: bool):
        """INTERSECT / EXCEPT as the JAX package lowers them: a UNION ALL
        of both sides tagged by side, a GROUP BY over every column (its
        keys take NULL = NULL, SQL's set semantics) counting each side's
        rows, and a filter on the two counts."""
        if all_:
            raise SqlError(f"{op.upper()} ALL is not supported")
        if len(left.schema) != len(right.schema):
            raise SqlError(f"{op.upper()} branches have different "
                           "column counts")
        lnames = [n for n, _ in left.schema]
        right2 = right.select(*[Alias(col(rn), ln)
                                for (ln, _), (rn, _) in
                                zip(left.schema, right.schema)])
        ltag = left.select(*([col(n) for n in lnames] +
                             [Alias(lit(1), "__setl"),
                              Alias(lit(0), "__setr")]))
        rtag = right2.select(*([col(n) for n in lnames] +
                               [Alias(lit(0), "__setl"),
                                Alias(lit(1), "__setr")]))
        g = ltag.union(rtag).group_by(*[col(n) for n in lnames]).agg(
            Alias(Agg.Sum(col("__setl")), "__cl"),
            Alias(Agg.Sum(col("__setr")), "__cr"))
        right_count = P.GreaterThan(col("__cr"), lit(0)) \
            if op == "intersect" else P.EqualTo(col("__cr"), lit(0))
        g = g.filter(P.And(P.GreaterThan(col("__cl"), lit(0)), right_count))
        return g.select(*[col(n) for n in lnames])

    # --- FROM resolution + join planning ---
    def _resolve_ref(self, ref):
        if isinstance(ref, SubqueryA):
            return ref.alias, self.analyze(ref.stmt)
        for frame in reversed(self._cte_frames):
            if ref.name.lower() in frame:
                return ref.alias, frame[ref.name.lower()]
        df = self.session.table(ref.name)
        return ref.alias, df

    def _conjuncts(self, ast) -> List[Ast]:
        if isinstance(ast, BinA) and ast.op == "and":
            return self._conjuncts(ast.l) + self._conjuncts(ast.r)
        return [ast] if ast is not None else []

    def _ast_tables(self, ast, scope: _Scope) -> set:
        """Aliases referenced by an AST (for join planning)."""
        out = set()

        def walk(a):
            if isinstance(a, ColA):
                if a.qualifier is not None:
                    out.add(a.qualifier.lower())
                else:
                    for alias, cols in scope.entries:
                        if any(u.lower() == a.name.lower()
                               for u, _ in cols):
                            out.add(alias.lower())
                            break
            elif isinstance(a, BinA):
                walk(a.l)
                walk(a.r)
            elif isinstance(a, UnA):
                walk(a.e)
            elif isinstance(a, BetweenA):
                walk(a.e), walk(a.lo), walk(a.hi)
            elif isinstance(a, InA):
                walk(a.e)
                for x in a.items:
                    walk(x)
            elif isinstance(a, (LikeA, IsNullA)):
                walk(a.e)
            elif isinstance(a, CastA):
                walk(a.e)
            elif isinstance(a, FnA):
                for x in a.args:
                    walk(x)
            elif isinstance(a, CaseA):
                for c, v in a.branches:
                    walk(c), walk(v)
                if a.els is not None:
                    walk(a.els)
        walk(ast)
        return out

    def analyze_select(self, s: SelectA):
        if not s.from_:
            # SELECT without FROM: single-row relation
            base = self.session.create_dataframe({"__one": [1]},
                                                 [("__one", dt.INT32)])
            scope = _Scope([("", [("__one", "__one")])],
                           {"__one": dt.INT32})
            return self._finish(base, scope, s)

        entries = []           # [(alias, DataFrame)]
        for j in s.from_:
            entries.append(self._resolve_ref(j.ref))

        # duplicate column names across FROM entries get unique internal
        # names (flat-name plans can't hold two columns called "v")
        seen_names = {}
        for alias, df in entries:
            for n, _ in df.schema:
                seen_names[n.lower()] = seen_names.get(n.lower(), 0) + 1
        scope_entries = []
        renamed_entries = []
        type_map = {}
        for alias, df in entries:
            cols = []
            renames = []
            for n, t in df.schema:
                if seen_names[n.lower()] > 1:
                    internal = f"__{alias}__{n}"
                    renames.append(Alias(col(n), internal))
                    cols.append((n, internal))
                else:
                    renames.append(col(n))
                    cols.append((n, n))
                type_map[cols[-1][1]] = t
            if any(isinstance(r, Alias) for r in renames):
                df = df.select(*renames)
            scope_entries.append((alias, cols))
            renamed_entries.append((alias, df))
        entries = renamed_entries
        scope = _Scope(scope_entries, type_map)

        # conjuncts holding subquery predicates (EXISTS / IN (SELECT) /
        # correlated scalar comparisons) lower via joins after the base
        # join tree is built; everything else flows the normal path
        all_conjuncts = self._conjuncts(s.where)
        conjuncts, subq_preds = [], []
        for c in all_conjuncts:
            if self._has_subquery_pred(c):
                subq_preds.append(c)
            else:
                conjuncts.append(c)
        used = [False] * len(conjuncts)

        # WHERE predicates may only be pushed below the joins into
        # tables never on a null-supplying join side (pushing into the
        # right leg of a LEFT JOIN would let null-extended rows through)
        preserved = {entries[0][0].lower()}
        for j, (alias, _) in zip(s.from_[1:], entries[1:]):
            al = alias.lower()
            if j.how in (None, "inner", "cross"):
                preserved.add(al)
            elif j.how == "left":
                pass                      # right leg null-supplied
            elif j.how == "right":
                preserved = {al}          # accumulated left null-supplied
            else:                         # full
                preserved = set()

        table_df = {}
        for idx, (alias, df) in enumerate(entries):
            preds = []
            for ci, c in enumerate(conjuncts):
                if used[ci]:
                    continue
                tabs = self._ast_tables(c, scope)
                if tabs == {alias.lower()} and alias.lower() in preserved:
                    preds.append(c)
                    used[ci] = True
            sub = _Scope([e for e in scope.entries if e[0] == alias],
                         scope.types)
            for p in preds:
                df = df.filter(self.lower(p, sub))
            table_df[alias.lower()] = df

        # left-deep join: explicit JOIN ... ON first, then comma joins
        # connected through WHERE equi-conjuncts
        joined_aliases = [entries[0][0].lower()]
        current = table_df[joined_aliases[0]]

        def current_scope():
            return _Scope([(a, cs) for a, cs in scope.entries
                           if a.lower() in joined_aliases], scope.types)

        def equi_keys(on_conjs, other_alias):
            """Split conjuncts into equi key pairs vs residual."""
            lk, rk, residual = [], [], []
            right_scope = _Scope([(a, cs) for a, cs in scope.entries
                                  if a.lower() == other_alias],
                                 scope.types)
            left_scope = current_scope()
            for c in on_conjs:
                if isinstance(c, BinA) and c.op == "=":
                    lt = self._ast_tables(c.l, scope)
                    rt_ = self._ast_tables(c.r, scope)
                    if lt <= set(joined_aliases) and rt_ == {other_alias}:
                        lk.append(self.lower(c.l, left_scope))
                        rk.append(self.lower(c.r, right_scope))
                        continue
                    if rt_ <= set(joined_aliases) and lt == {other_alias}:
                        lk.append(self.lower(c.r, left_scope))
                        rk.append(self.lower(c.l, right_scope))
                        continue
                residual.append(c)
            return lk, rk, residual

        remaining = [(j, alias) for j, (alias, _) in
                     list(zip(s.from_, entries))[1:]]
        force_cross = False
        while remaining:
            progressed = False
            for k, (j, alias) in enumerate(remaining):
                al = alias.lower()
                if j.how is not None and j.how != "cross":
                    if k != 0:
                        # explicit joins keep declaration order: wait
                        # until everything declared before them is joined
                        continue
                    on_conjs = self._conjuncts(j.on)
                    lk, rk, residual = equi_keys(on_conjs, al)
                    how = {"left": "left_outer", "right": "right_outer",
                           "full": "full_outer"}.get(j.how, j.how)
                    other = table_df[al]
                    if lk:
                        if residual and how != "inner":
                            # a residual ON conjunct changes outer-join
                            # match semantics; filtering after the join
                            # would silently produce inner-join results
                            raise SqlError(
                                f"non-equi ON condition on {j.how} JOIN "
                                "not supported")
                        current = current.join(other, (lk, rk), how=how)
                        joined_aliases.append(al)
                        if residual:
                            sc = current_scope()
                            for c in residual:
                                current = current.filter(self.lower(c, sc))
                    else:
                        if how != "inner":
                            raise SqlError(
                                f"{j.how} JOIN without equi-condition not "
                                "supported")
                        current = current.cross_join(other)
                        joined_aliases.append(al)
                        if on_conjs:
                            sc = current_scope()
                            for c in on_conjs:
                                current = current.filter(self.lower(c, sc))
                    progressed = True
                elif j.how == "cross":
                    current = current.cross_join(table_df[al])
                    joined_aliases.append(al)
                    progressed = True
                else:
                    # comma join: connect via WHERE equi-conjuncts
                    cand = []
                    for ci, c in enumerate(conjuncts):
                        if used[ci]:
                            continue
                        tabs = self._ast_tables(c, scope)
                        if al in tabs and \
                                tabs <= set(joined_aliases + [al]):
                            cand.append((ci, c))
                    lk, rk, residual = equi_keys([c for _, c in cand], al)
                    if not lk and len(remaining) > 1 and not force_cross:
                        continue  # try a better-connected table first
                    for ci, _ in cand:
                        used[ci] = True
                    other = table_df[al]
                    if lk:
                        current = current.join(other, (lk, rk), how="inner")
                    else:
                        current = current.cross_join(other)
                    joined_aliases.append(al)
                    if residual:
                        sc = current_scope()
                        for c in residual:
                            current = current.filter(self.lower(c, sc))
                    progressed = True
                if progressed:
                    remaining.pop(k)
                    break
            if not progressed:
                if not force_cross and any(j.how is None
                                           for j, _ in remaining):
                    # disconnected comma entry: fall back to a cartesian
                    # product rather than failing
                    force_cross = True
                    continue
                raise SqlError("could not order joins (disconnected FROM "
                               "without equi-conditions)")
            force_cross = False

        # leftover WHERE conjuncts (multi-table non-equi)
        full_scope = current_scope()
        for ci, c in enumerate(conjuncts):
            if not used[ci]:
                current = current.filter(self.lower(c, full_scope))
        for c in subq_preds:
            current = self._apply_subquery_pred(current, full_scope, c)
        return self._finish(current, full_scope, s)

    # --- subquery predicates (EXISTS / IN (SELECT) / correlated scalar) ---
    _subq_n = 0

    def _has_subquery_pred(self, a) -> bool:
        if isinstance(a, (ExistsA, InSubqueryA)):
            return True
        if isinstance(a, ScalarSubqueryA):
            return self._is_correlated(a.stmt)
        for v in vars(a).values() if isinstance(a, Ast) else ():
            if isinstance(v, Ast) and self._has_subquery_pred(v):
                return True
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, Ast) and self._has_subquery_pred(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, Ast) and \
                                    self._has_subquery_pred(y):
                                return True
        return False

    def _inner_scope_of(self, stmt) -> Optional[_Scope]:
        """Resolution scope of a subquery's own FROM (schemas only).
        Memoized per stmt object: correlation classification asks for
        it repeatedly and derived-table refs are costly to resolve."""
        cache = getattr(self, "_inner_scope_cache", None)
        if cache is None:
            cache = self._inner_scope_cache = {}
        if id(stmt) in cache:
            return cache[id(stmt)]
        if not isinstance(stmt, SelectA) or not stmt.from_:
            scope = None
        else:
            entries, types = [], {}
            for j in stmt.from_:
                alias, df = self._resolve_ref(j.ref)
                cols = [(n, n) for n, _ in df.schema]
                types.update({n: t for n, t in df.schema})
                entries.append((alias, cols))
            scope = _Scope(entries, types)
        cache[id(stmt)] = scope
        return scope

    def _is_correlated(self, stmt) -> bool:
        """Does the subquery's WHERE reference columns outside its own
        FROM scope?"""
        inner = self._inner_scope_of(stmt)
        if inner is None:
            return False
        for c in self._conjuncts(stmt.where):
            if self._outer_refs(c, inner):
                return True
        return False

    def _outer_refs(self, ast, inner_scope: _Scope) -> bool:
        """True when ``ast`` references a column the inner scope cannot
        resolve (i.e. a correlated outer reference)."""
        found = [False]

        def walk(a):
            if found[0]:
                return
            if isinstance(a, ColA):
                try:
                    inner_scope.resolve(a.name, a.qualifier)
                except SqlError:
                    found[0] = True
                except KeyError:
                    found[0] = True
                return
            if isinstance(a, (ScalarSubqueryA, ExistsA, InSubqueryA)):
                return  # nested subqueries resolve their own scopes
            if isinstance(a, Ast):
                for v in vars(a).items():
                    _walk_val(v[1])

        def _walk_val(v):
            if isinstance(v, Ast):
                walk(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    _walk_val(x)
        walk(ast)
        return found[0]

    def _correlation_split(self, stmt: "SelectA", outer_scope: _Scope):
        """Split a subquery's WHERE into (inner conjuncts, correlation
        pairs [(outer_ast, inner_ast)], outer-only conjuncts, residual
        conjuncts). Residuals reference BOTH scopes non-equi (q94's
        ``ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk``); EXISTS lowers
        them as a post-join filter (``_apply_exists_residual``), other
        shapes reject them."""
        inner = self._inner_scope_of(stmt)
        if inner is None:
            raise SqlError("correlated subquery needs a FROM clause")
        inner_c, pairs, outer_c, residuals = [], [], [], []
        for c in self._conjuncts(stmt.where):
            if not self._outer_refs(c, inner):
                inner_c.append(c)
                continue
            if isinstance(c, BinA) and c.op == "=":
                l_out = self._outer_refs(c.l, inner)
                r_out = self._outer_refs(c.r, inner)
                if l_out and not r_out:
                    pairs.append((c.l, c.r))
                    continue
                if r_out and not l_out:
                    pairs.append((c.r, c.l))
                    continue
            if not self._outer_refs_any_inner(c, inner):
                outer_c.append(c)
                continue
            residuals.append(c)
        return inner_c, pairs, outer_c, residuals

    def _outer_refs_any_inner(self, ast, inner_scope: _Scope) -> bool:
        """Does ``ast`` reference ANY column the inner scope resolves?"""
        found = [False]

        def walk(a):
            if found[0] or not isinstance(a, Ast):
                return
            if isinstance(a, ColA):
                try:
                    inner_scope.resolve(a.name, a.qualifier)
                    found[0] = True
                except (SqlError, KeyError):
                    pass
                return
            for v in vars(a).values():
                if isinstance(v, Ast):
                    walk(v)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, Ast):
                            walk(x)
        walk(ast)
        return found[0]

    def _plan_semi_source(self, stmt: "SelectA", outer_scope: _Scope,
                          value_ast: Optional[Ast]):
        """Build (sub_df, left_key_exprs, right_key_names) for an
        EXISTS/IN predicate; ``value_ast`` is the outer expression of an
        IN (its match column is the subquery's single select item)."""
        if not isinstance(stmt, SelectA):
            if value_ast is None:
                raise SqlError("EXISTS over set operations is not "
                               "supported")
            # uncorrelated IN over a set expression
            sub_df = self.analyze(stmt)
            if len(sub_df.schema) != 1:
                raise SqlError("IN subquery must return one column")
            n = Analyzer._subq_n = Analyzer._subq_n + 1
            key = f"__sqv{n}"
            sub_df = sub_df.select(
                Alias(col(sub_df.schema[0][0]), key))
            return (sub_df, [self.lower(value_ast, outer_scope)],
                    [key], [])
        inner_c, pairs, outer_c, residuals = self._correlation_split(
            stmt, outer_scope)
        if outer_c:
            raise SqlError("outer-only conjunct inside subquery not "
                           "supported")
        if residuals and value_ast is not None:
            raise SqlError("non-equi correlated predicates are only "
                           "supported in EXISTS")
        if (stmt.group_by or stmt.having) and (pairs or residuals):
            raise SqlError("correlated subquery with GROUP BY/HAVING "
                           "not supported in EXISTS/IN")
        n = Analyzer._subq_n = Analyzer._subq_n + 1
        s2 = SelectA()
        s2.from_ = stmt.from_
        s2.where = _and_all(inner_c)
        s2.group_by = list(stmt.group_by)
        s2.having = stmt.having
        items = []
        left_keys, right_names = [], []
        if value_ast is not None:
            if len(stmt.items) != 1 or isinstance(stmt.items[0][0],
                                                  StarA):
                raise SqlError("IN subquery must select exactly one "
                               "column")
            vname = f"__sqv{n}"
            items.append((stmt.items[0][0], vname))
            left_keys.append(self.lower(value_ast, outer_scope))
            right_names.append(vname)
        for i, (o_ast, i_ast) in enumerate(pairs):
            kname = f"__sqk{n}_{i}"
            items.append((i_ast, kname))
            left_keys.append(self.lower(o_ast, outer_scope))
            right_names.append(kname)
        res_asts = []
        if residuals:
            # project every inner column a residual references under a
            # fresh name and rewrite the residual to reference it; the
            # EXISTS rewrite filters on it post-join
            inner_scope = self._inner_scope_of(stmt)
            mapping: dict = {}

            def rw(a):
                if isinstance(a, ColA):
                    try:
                        internal = inner_scope.resolve(a.name,
                                                       a.qualifier)
                    except (SqlError, KeyError):
                        return a
                    if internal not in mapping:
                        fresh = f"__sqr{n}_{len(mapping)}"
                        mapping[internal] = fresh
                        items.append((ColA(a.name, a.qualifier), fresh))
                    return ColA(mapping[internal], None)
                if isinstance(a, (ScalarSubqueryA, ExistsA,
                                  InSubqueryA)):
                    raise SqlError("nested subquery inside a "
                                   "correlated predicate is not "
                                   "supported")
                if not isinstance(a, Ast):
                    return a
                b = copy.copy(a)
                for k, v in vars(a).items():
                    if isinstance(v, Ast):
                        setattr(b, k, rw(v))
                    elif isinstance(v, (list, tuple)):
                        setattr(b, k, type(v)(
                            rw(x) if isinstance(x, Ast) else x
                            for x in v))
                return b

            res_asts = [rw(c) for c in residuals]
        if not items:
            # uncorrelated EXISTS: non-emptiness only
            items.append((LitA(1), f"__sq1_{n}"))
            right_names, left_keys = [], []
        s2.items = items
        sub_df = self.analyze_select(s2)
        return sub_df, left_keys, right_names, res_asts

    def _apply_subquery_pred(self, df, scope: _Scope, ast):
        """Lower one WHERE conjunct containing subquery predicates onto
        joins (the engine-side version of Spark's RewritePredicate
        Subquery, whose output the reference accelerates as
        GpuBroadcastHashJoin left-semi/anti)."""
        neg = False
        inner = ast
        while isinstance(inner, UnA) and inner.op == "not":
            neg = not neg
            inner = inner.e
        if isinstance(inner, ExistsA):
            sub_df, lk, rk, res = self._plan_semi_source(
                inner.stmt, scope, None)
            if res:
                return self._apply_exists_residual(
                    df, scope, sub_df, lk, rk, res, neg)
            if not lk:
                # uncorrelated: EXISTS is a plan-time boolean
                nonempty = len(sub_df.limit(1).collect()) > 0
                keep = nonempty != neg
                return df if keep else df.filter(
                    P.EqualTo(lit(1), lit(0)))
            return df.join(sub_df, (lk, [col(n) for n in rk]),
                           how="left_anti" if neg else "left_semi")
        if isinstance(inner, InSubqueryA):
            effective_neg = neg != inner.neg
            sub_df, lk, rk, _res = self._plan_semi_source(
                inner.stmt, scope, inner.e)
            if effective_neg:
                return self._apply_not_in(df, scope, inner, sub_df, lk,
                                          rk)
            return df.join(sub_df, (lk, [col(n) for n in rk]),
                           how="left_semi")
        if neg:
            raise SqlError("NOT over this subquery predicate shape is "
                           "not supported")
        return self._apply_general_subquery_expr(df, scope, ast)

    def _apply_exists_residual(self, df, scope: _Scope, sub_df, lk, rk,
                               res_asts, neg: bool):
        """EXISTS whose correlation has non-equi conjuncts (q94's
        ``ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk``): tag each outer
        row with a unique id, inner-join to the subquery on the equi
        pairs, filter on the residual, and semi/anti-join the surviving
        ids back. The reference plans this same shape as a conditional
        existence join (GpuBroadcastHashJoinExec with a bound AST
        condition)."""
        n = Analyzer._subq_n = Analyzer._subq_n + 1
        rid = f"__srid{n}"
        out_names = [nm for nm, _t in df.schema]
        df_id = df.with_column(rid, monotonically_increasing_id())
        if lk:
            joined = df_id.join(sub_df, (lk, [col(k) for k in rk]),
                                how="inner")
        else:
            joined = df_id.cross_join(sub_df)
        comb = _Scope(
            scope.entries + [(f"__sub{n}",
                              [(nm, nm) for nm, _t in sub_df.schema])],
            {**scope.types, **dict(sub_df.schema)})
        cond = None
        for a in res_asts:
            e = self.lower(a, comb)
            cond = e if cond is None else P.And(cond, e)
        matched = joined.filter(cond).select(Alias(col(rid), rid))
        kept = df_id.join(matched, ([col(rid)], [col(rid)]),
                          how="left_anti" if neg else "left_semi")
        return kept.select(*[Alias(col(nm), nm) for nm in out_names])

    def _apply_not_in(self, df, scope, inner: "InSubqueryA", sub_df, lk,
                      rk):
        """NOT IN (subquery) with SQL null semantics: any NULL in the
        subquery result ⇒ no row qualifies; a NULL probe value only
        qualifies when the subquery is empty (GpuBroadcastNestedLoopJoin
        null-aware anti join in the reference)."""
        if len(lk) > 1:
            raise SqlError("correlated NOT IN is not supported")
        vname = rk[0]
        from ..plan.session import GroupedData
        agg = GroupedData(sub_df, []).agg(
            Alias(Agg.CountStar(), "__n"),
            Alias(Agg.Count(col(vname)), "__nn"))
        row = agg.collect()[0]
        total, nonnull = row["__n"], row["__nn"]
        if total == 0:
            return df                     # NOT IN ∅ is TRUE
        if nonnull < total:
            return df.filter(P.EqualTo(lit(1), lit(0)))  # NULL ⇒ empty
        out = df.join(sub_df, (lk, [col(n) for n in rk]),
                      how="left_anti")
        return out.filter(P.Not(P.IsNull(lk[0])))

    def _apply_general_subquery_expr(self, df, scope: _Scope, ast):
        """Subquery predicates nested under OR (q10/q35 shape: EXISTS
        (...) OR EXISTS (...)) lower as existence-join markers, plus
        correlated scalar subqueries rewritten to grouped-aggregate
        joins; the rewritten conjunct then filters normally."""
        out_names = [n for n, _ in df.schema]
        repl: dict = {}

        def rewrite(a):
            nonlocal df
            if isinstance(a, ExistsA):
                sub_df, lk, rk, res = self._plan_semi_source(
                    a.stmt, scope, None)
                if res:
                    raise SqlError("non-equi correlated EXISTS under "
                                   "OR is not supported")
                if not lk:
                    nonempty = len(sub_df.limit(1).collect()) > 0
                    return LitA(nonempty)
                n = Analyzer._subq_n = Analyzer._subq_n + 1
                marker = f"__exists{n}"
                sub_m = sub_df.select(
                    *[Alias(col(k), k) for k in rk] +
                    [Alias(lit(True), marker)]).distinct()
                df = df.join(sub_m, (lk, [col(k) for k in rk]),
                             how="left_outer")
                return _PreLowered(Cond.Coalesce(col(marker),
                                                 lit(False)))
            if isinstance(a, InSubqueryA):
                if a.neg:
                    raise SqlError("NOT IN under OR is not supported")
                sub_df, lk, rk, _res = self._plan_semi_source(
                    a.stmt, scope, a.e)
                n = Analyzer._subq_n = Analyzer._subq_n + 1
                marker = f"__exists{n}"
                sub_m = sub_df.select(
                    *[Alias(col(k), k) for k in rk] +
                    [Alias(lit(True), marker)]).distinct()
                df = df.join(sub_m, (lk, [col(k) for k in rk]),
                             how="left_outer")
                return _PreLowered(Cond.Coalesce(col(marker),
                                                 lit(False)))
            if isinstance(a, ScalarSubqueryA) and \
                    self._is_correlated(a.stmt):
                # correlated scalar: rewrite to a grouped aggregate
                # joined on the correlation keys; no match ⇒ NULL ⇒
                # the comparison is UNKNOWN and the row filters out,
                # exactly SQL semantics
                stmt = a.stmt
                if not isinstance(stmt, SelectA) or len(stmt.items) != 1:
                    raise SqlError("correlated scalar subquery must "
                                   "select one expression")
                inner_c, pairs, outer_c, residuals = \
                    self._correlation_split(stmt, scope)
                if outer_c or residuals or not pairs or stmt.group_by:
                    raise SqlError("unsupported correlated scalar "
                                   "subquery shape")
                n = Analyzer._subq_n = Analyzer._subq_n + 1
                s2 = SelectA()
                s2.from_ = stmt.from_
                s2.where = _and_all(inner_c)
                s2.group_by = [i_ast for _, i_ast in pairs]
                vname = f"__scv{n}"
                knames = [f"__sck{n}_{i}" for i in range(len(pairs))]
                s2.items = [(i_ast, kn)
                            for (_, i_ast), kn in zip(pairs, knames)] + \
                    [(stmt.items[0][0], vname)]
                sub_df = self.analyze_select(s2)
                lk = [self.lower(o_ast, scope) for o_ast, _ in pairs]
                df = df.join(sub_df, (lk, [col(k) for k in knames]),
                             how="left_outer")
                return _PreLowered(col(vname))
            if not isinstance(a, Ast):
                return a
            clone = a.__class__.__new__(a.__class__)
            for k, v in vars(a).items():
                if isinstance(v, Ast):
                    setattr(clone, k, rewrite(v))
                elif isinstance(v, list):
                    setattr(clone, k, [
                        rewrite(x) if isinstance(x, Ast) else
                        (tuple(rewrite(y) if isinstance(y, Ast) else y
                               for y in x) if isinstance(x, tuple) else x)
                        for x in v])
                else:
                    setattr(clone, k, v)
            return clone

        new_ast = rewrite(ast)
        cond = self.lower(new_ast, scope)
        df = df.filter(cond)
        # drop the helper columns the joins added
        return df.select(*[col(n) for n in out_names])

    # --- SELECT/GROUP BY/HAVING/ORDER BY lowering ---
    def _finish(self, df, scope: _Scope, s: SelectA):
        # expand stars (user-facing names become the output aliases)
        items: List[Tuple[Ast, Optional[str]]] = []
        for ast, alias in s.items:
            if isinstance(ast, StarA):
                for user, internal in scope.all_columns(ast.qualifier):
                    items.append((ColA(user), user))
            else:
                items.append((ast, alias))

        # group-by ordinals -> select items
        group_asts = []
        for g in s.group_by:
            if isinstance(g, LitA) and isinstance(g.value, int):
                if not 1 <= g.value <= len(items):
                    raise SqlError(f"GROUP BY position {g.value} is not "
                                   f"in the select list (1..{len(items)})")
                group_asts.append(items[g.value - 1][0])
            else:
                group_asts.append(g)

        lowered = [self.lower(a, scope) for a, _ in items]
        names = [alias or self._default_name(a, i)
                 for i, ((a, alias), e) in enumerate(zip(items, lowered))]
        has_agg = any(self._find_aggs(e) for e in lowered) or \
            bool(group_asts) or \
            (s.having is not None)

        if not has_agg and not s.distinct and any(
                not self._resolves_in_output(oast, names)
                for oast, _, _ in s.order_by):
            # ORDER BY items the output does not name ride along as
            # hidden projection columns and every key sorts in one pass
            # after the projection (the JAX analyzer sorts them before
            # the projection and the output columns after it, so the
            # output columns order first: ROADMAP C4)
            proj = [Alias(e, n) for e, n in zip(lowered, names)]
            order = []
            for k, (oast, asc, nf) in enumerate(s.order_by):
                if self._resolves_in_output(oast, names):
                    order.append((oast, asc, nf))
                else:
                    proj.append(Alias(self.lower(oast, scope), f"__ord{k}"))
                    order.append((ColA(f"__ord{k}"), asc, nf))
            out = self._order_limit(df.select(*proj), order, s.limit,
                                    scope, items)
            return out.select(*[col(n) for n in names])

        if not has_agg:
            pre_sort = []
            post_sort = []
            out_like = list(names)
            for (oast, asc, nf) in s.order_by:
                if self._resolves_in_output(oast, out_like):
                    post_sort.append((oast, asc, nf))
                else:
                    pre_sort.append((oast, asc, nf))
            if pre_sort:
                df = self._order_limit(df, pre_sort, None, scope)
            out = df.select(*[Alias(e, n)
                              for e, n in zip(lowered, names)])
            if s.distinct:
                out = out.distinct()
            out = self._order_limit(out, post_sort, s.limit, scope, items)
            return out

        # aggregate path: split aggs out of select/having/order exprs
        keys_src = [self.lower(g, scope) for g in group_asts]
        n_keys = len(keys_src)
        if s.group_sets is None:
            keys = keys_src
            key_names = [output_name(k, i) for i, k in enumerate(keys)]
        else:
            # GROUPING SETS / ROLLUP / CUBE: expand each row once per
            # grouping set (key slots NULL where absent, plus a grouping
            # id), then group by (keys..., __grouping_id), so a subtotal
            # NULL never merges with a natural NULL key (GpuExpandExec's
            # role in the reference)
            from ..plan import logical as L
            in_names = [n for n, _ in df.schema]
            key_names = [f"__gk{i}" for i in range(n_keys)]
            projections = []
            for idxs in s.group_sets:
                gid_val = 0
                proj = [col(n) for n in in_names]
                for i, ke in enumerate(keys_src):
                    if i in idxs:
                        proj.append(ke)
                    else:
                        proj.append(Literal(None,
                                            ke.data_type(df.schema)))
                        gid_val |= 1 << (n_keys - 1 - i)
                proj.append(lit(gid_val))
                projections.append(proj)
            df = type(df)(df.session, L.Expand(
                df.plan, projections,
                in_names + key_names + ["__grouping_id"]))
            keys = [col(kn) for kn in key_names] + [col("__grouping_id")]
            key_names = list(key_names) + ["__grouping_id"]
        agg_fns: List[Tuple[Agg.AggregateFunction, str]] = []

        def replace(e: Expression) -> Expression:
            """Replace aggregate subtrees with refs to computed columns,
            and group-key subtrees with refs to key output columns."""
            if isinstance(e, _GroupingMarker):
                if s.group_sets is None:
                    return lit(0)  # plain GROUP BY: every key is grouped
                for i, k in enumerate(keys_src):
                    if repr(e.children[0]) == repr(k):
                        return Bit.BitwiseAnd(
                            Bit.ShiftRight(col("__grouping_id"),
                                           lit(n_keys - 1 - i)),
                            lit(1))
                raise SqlError("GROUPING() argument is not a grouping "
                               "key")
            for k, kn in zip(keys_src, key_names):
                if repr(e) == repr(k):
                    return col(kn)
            for k, kn in zip(keys, key_names):
                if repr(e) == repr(k):
                    return col(kn)
            if isinstance(e, W.WindowExpression):
                # window OVER aggregated output (SUM(SUM(x)) OVER
                # (PARTITION BY k), RANK() OVER (ORDER BY SUM(x))):
                # Spark evaluates the window after the aggregate, so only
                # the window function's operands and the spec's
                # partition/order expressions are substituted; the window
                # function itself stays, applied over the aggregate's rows
                nf = e.func.__class__.__new__(e.func.__class__)
                nf.__dict__.update(e.func.__dict__)
                nf.children = [replace(c) for c in e.func.children]
                spec = e.spec.__class__.__new__(e.spec.__class__)
                spec.__dict__.update(e.spec.__dict__)
                spec.partition_by = [replace(p)
                                     for p in e.spec.partition_by]
                new_orders = []
                for o in e.spec.order_fields:
                    no = o.__class__.__new__(o.__class__)
                    no.__dict__.update(o.__dict__)
                    no.expr = replace(o.expr)
                    new_orders.append(no)
                spec.order_fields = new_orders
                return W.WindowExpression(nf, spec)
            if isinstance(e, Agg.AggregateFunction):
                for fn, n in agg_fns:
                    if repr(fn) == repr(e):
                        return col(n)
                n = f"__agg{len(agg_fns)}"
                agg_fns.append((e, n))
                return col(n)
            if isinstance(e, Cond.CaseWhen):
                # CaseWhen evaluates via .branches/.otherwise, not
                # .children — rebuild it so aggregates inside CASE are
                # substituted too
                return Cond.CaseWhen(
                    [(replace(c), replace(v)) for c, v in e.branches],
                    replace(e.otherwise)
                    if e.otherwise is not None else None)
            out = e.__class__.__new__(e.__class__)
            out.__dict__.update(e.__dict__)
            out.children = [replace(c) for c in e.children]
            return out

        post = [replace(e) for e in lowered]
        having_e = None
        if s.having is not None:
            having_e = replace(self.lower(s.having, scope))

        # ORDER BY expressions not present in the output (e.g. ORDER BY
        # sum(x) when only avg(x) is selected) ride along as hidden
        # projection columns, then get dropped after the sort
        proj = [Alias(e, n) for e, n in zip(post, names)]
        order_post = []
        hidden = 0
        for (oast, asc, nf) in s.order_by:
            if self._resolves_in_output(oast, names):
                order_post.append((oast, asc, nf))
            else:
                e = replace(self.lower(oast, scope))
                hname = f"__ord{hidden}"
                hidden += 1
                proj.append(Alias(e, hname))
                order_post.append((ColA(hname), asc, nf))

        from ..plan.session import GroupedData
        agg_df = GroupedData(df, keys).agg(
            *[Alias(fn, n) for fn, n in agg_fns])
        if having_e is not None:
            agg_df = agg_df.filter(having_e)
        if s.distinct and hidden:
            # standard SQL: with DISTINCT, ORDER BY items must appear in
            # the select list
            raise SqlError("ORDER BY expression must be in the select "
                           "list when DISTINCT is used")
        out = agg_df.select(*proj)
        if s.distinct:
            out = out.distinct()
        out = self._order_limit(out, order_post, s.limit, scope, items,
                                agg_replace=replace)
        if hidden:
            out = out.select(*[col(n) for n in names])
        return out

    def _order_limit(self, df, order_by, limit, scope, items=None,
                     agg_replace=None):
        if order_by:
            from ..plan import logical as L
            out_names = [n for n, _ in df.schema]
            fields = []
            for (oast, asc, nf) in order_by:
                e = self._resolve_order_expr(oast, out_names, scope,
                                             items, agg_replace)
                fields.append(L.SortField(e, asc, nf))
            df = type(df)(df.session, L.Sort(df.plan, fields))
        if limit is not None:
            df = df.limit(limit)
        return df

    def _resolves_in_output(self, oast, out_names) -> bool:
        if isinstance(oast, LitA) and isinstance(oast.value, int):
            return 1 <= oast.value <= len(out_names)
        return isinstance(oast, ColA) and oast.qualifier is None and \
            any(n.lower() == oast.name.lower() for n in out_names)

    def _resolve_order_expr(self, oast, out_names, scope, items,
                            agg_replace):
        # ordinal
        if isinstance(oast, LitA) and isinstance(oast.value, int) and \
                1 <= oast.value <= len(out_names):
            return col(out_names[oast.value - 1])
        # output column / select alias
        if isinstance(oast, ColA) and oast.qualifier is None:
            for n in out_names:
                if n.lower() == oast.name.lower():
                    return col(n)
        # general expression against the input scope
        if scope is None:
            raise SqlError("ORDER BY of a UNION must reference output "
                           "columns")
        e = self.lower(oast, scope)
        if agg_replace is not None:
            e = agg_replace(e)
        return e

    def _default_name(self, ast, i) -> str:
        if isinstance(ast, ColA):
            return ast.name
        return f"_c{i}"

    def _find_aggs(self, e: Expression) -> List:
        out = []
        if isinstance(e, Agg.AggregateFunction):
            out.append(e)
        for c in e.children:
            out.extend(self._find_aggs(c))
        return out

    # --- expression lowering ---
    def lower(self, ast: Ast, scope: _Scope) -> Expression:
        if isinstance(ast, _PreLowered):
            return ast.expr
        if isinstance(ast, (ExistsA, InSubqueryA)):
            raise SqlError("EXISTS / IN (SELECT ...) is only supported "
                           "in WHERE conjuncts")
        if isinstance(ast, ColA):
            return col(scope.resolve(ast.name, ast.qualifier))
        if isinstance(ast, ScalarSubqueryA):
            # scalar subquery: execute now, inline the value (the
            # uncorrelated-subquery path of SURVEY §2.4 #43; correlated
            # subqueries are not supported)
            sub = self.analyze(ast.stmt)
            rows = sub.collect()
            if len(sub.schema) != 1:
                raise SqlError("scalar subquery must return one column")
            if len(rows) > 1:
                raise SqlError("scalar subquery returned more than one "
                               "row")
            name = sub.schema[0][0]
            value = rows[0][name] if rows else None
            from ..expr.core import Literal
            return Literal(value, sub.schema[0][1]) \
                if value is not None else Literal(None, sub.schema[0][1])
        if isinstance(ast, OverA):
            return self._lower_over(ast, scope)
        if isinstance(ast, LitA):
            return lit(ast.value)
        if isinstance(ast, IntervalA):
            raise SqlError("INTERVAL only supported in +/- date arithmetic")
        if isinstance(ast, UnA):
            if ast.op == "not":
                return P.Not(self.lower(ast.e, scope))
            return A.UnaryMinus(self.lower(ast.e, scope))
        if isinstance(ast, BinA):
            return self._lower_bin(ast, scope)
        if isinstance(ast, BetweenA):
            e = self.lower(ast.e, scope)
            lo = self.lower(ast.lo, scope)
            hi = self.lower(ast.hi, scope)
            out = P.And(P.GreaterThanOrEqual(e, lo),
                        P.LessThanOrEqual(e, hi))
            return P.Not(out) if ast.neg else out
        if isinstance(ast, InA):
            vals = []
            for x in ast.items:
                if not isinstance(x, LitA):
                    raise SqlError("IN list items must be literals")
                vals.append(x.value)
            out = P.InSet(self.lower(ast.e, scope), vals)
            return P.Not(out) if ast.neg else out
        if isinstance(ast, LikeA):
            out = self._made(lambda: S.Like(self.lower(ast.e, scope),
                                            ast.pattern), "LIKE")
            return P.Not(out) if ast.neg else out
        if isinstance(ast, IsNullA):
            e = self.lower(ast.e, scope)
            return P.IsNotNull(e) if ast.neg else P.IsNull(e)
        if isinstance(ast, CaseA):
            branches = [(self.lower(c, scope), self.lower(v, scope))
                        for c, v in ast.branches]
            els = self.lower(ast.els, scope) if ast.els is not None else None
            return Cond.CaseWhen(branches, els)
        if isinstance(ast, CastA):
            out = Cast(self.lower(ast.e, scope), ast.to)
            schema = scope.type_schema() if scope is not None else []
            if out.children[0].references() <= {n for n, _ in schema}:
                self._made(lambda: out.check_supported(schema), "CAST")
            return out
        if isinstance(ast, FnA):
            return self._lower_fn(ast, scope)
        if isinstance(ast, StarA):
            raise SqlError("* only valid in SELECT list or COUNT(*)")
        raise SqlError(f"cannot lower {type(ast).__name__}")

    def _lower_bin(self, ast: BinA, scope) -> Expression:
        op = ast.op
        if op == "and":
            return P.And(self.lower(ast.l, scope), self.lower(ast.r, scope))
        if op == "or":
            return P.Or(self.lower(ast.l, scope), self.lower(ast.r, scope))
        if op in ("+", "-"):
            if isinstance(ast.r, IntervalA):
                return self._date_shift(self.lower(ast.l, scope), ast.r,
                                        negate=(op == "-"))
            if isinstance(ast.l, IntervalA) and op == "+":
                return self._date_shift(self.lower(ast.r, scope), ast.l,
                                        negate=False)
        l = self.lower(ast.l, scope)
        r = self.lower(ast.r, scope)
        if op == "+":
            return A.Add(l, r)
        if op == "-":
            return A.Subtract(l, r)
        if op == "*":
            return A.Multiply(l, r)
        if op == "/":
            return A.Divide(l, r)
        if op == "div":
            return A.IntegralDivide(l, r)
        if op == "%":
            return A.Remainder(l, r)
        if op == "||":
            return S.Concat(l, r)
        if op == "=":
            return P.EqualTo(l, r)
        if op in ("<>", "!="):
            return P.Not(P.EqualTo(l, r))
        if op == "<":
            return P.LessThan(l, r)
        if op == "<=":
            return P.LessThanOrEqual(l, r)
        if op == ">":
            return P.GreaterThan(l, r)
        if op == ">=":
            return P.GreaterThanOrEqual(l, r)
        raise SqlError(f"unknown operator {op!r}")

    def _date_shift(self, base: Expression, iv: IntervalA,
                    negate: bool) -> Expression:
        n = -iv.n if negate else iv.n
        if iv.unit == "day":
            return D.DateAdd(base, lit(n))
        if iv.unit == "week":
            return D.DateAdd(base, lit(n * 7))
        if iv.unit == "month":
            return D.AddMonths(base, lit(n))
        if iv.unit == "year":
            return D.AddMonths(base, lit(n * 12))
        raise SqlError(f"unsupported interval unit {iv.unit!r}")

    @staticmethod
    def _made(build, what: str):
        """``build()``, with what the port refuses when the plan is made
        (a time zone, format or cast it cannot run: TypeError,
        ValueError, zoneinfo's KeyError / OSError, or NotImplementedError)
        as SqlError."""
        try:
            return build()
        except (TypeError, ValueError, KeyError, OSError,
                NotImplementedError) as e:
            raise SqlError(f"{what}: {e}") from e

    def _lower_over(self, ast: OverA, scope) -> Expression:
        from ..plan.logical import SortField
        fn = ast.fn
        name = fn.name
        if name in ("row_number", "rank", "dense_rank", "percent_rank"):
            func = {"row_number": W.RowNumber, "rank": W.Rank,
                    "dense_rank": W.DenseRank,
                    "percent_rank": W.PercentRank}[name]()
        elif name == "ntile":
            if not fn.args or not isinstance(fn.args[0], LitA):
                raise SqlError("ntile(n) needs an integer literal")
            func = W.NTile(int(fn.args[0].value))
        elif name in ("lead", "lag"):
            off = 1
            default = None
            if len(fn.args) >= 2:
                if not isinstance(fn.args[1], LitA):
                    raise SqlError(f"{name} offset must be a literal")
                off = int(fn.args[1].value)
            if len(fn.args) >= 3:
                if not isinstance(fn.args[2], LitA):
                    raise SqlError(f"{name} default must be a literal")
                default = fn.args[2].value
            cls = W.Lead if name == "lead" else W.Lag
            func = cls(self.lower(fn.args[0], scope), off, default)
        elif name in _AGG_FNS or name == "count":
            # the planner's _tag_window sends what the window execs do
            # not run (stddev / variance, first / last, a string min /
            # max) to the CPU engine
            func = self._lower_fn(fn, scope)
        else:
            raise SqlError(f"unsupported window function {name!r}")
        spec = W.WindowSpec(
            [self.lower(p, scope) for p in ast.partition],
            [SortField(self.lower(o, scope), asc,
                       asc if nf is None else nf)
             for o, asc, nf in ast.order])
        if ast.frame is not None:
            row_based, lo, hi = ast.frame
            spec = spec.with_frame(W.WindowFrame(lo, hi,
                                                 row_based=row_based))
        return func.over(spec)

    def _lower_fn(self, ast: FnA, scope) -> Expression:
        name = ast.name
        if name == "grouping":
            if len(ast.args) != 1:
                raise SqlError("GROUPING takes one argument")
            return _GroupingMarker(self.lower(ast.args[0], scope))
        if name == "count":
            if ast.star or not ast.args:
                return Agg.CountStar()
            if ast.distinct:
                # COUNT(DISTINCT x) = size(collect_set(x)): collect_set
                # drops NULLs and repeats, exactly distinct-count
                # semantics; the aggregate split substitutes the inner
                # CollectSet and Size applies after the aggregate
                return Cast(Coll.Size(
                    Agg.CollectSet(self.lower(ast.args[0], scope))),
                    dt.INT64)
            return Agg.Count(self.lower(ast.args[0], scope))
        if name in _AGG_FNS:
            if ast.distinct:
                raise SqlError(f"{name}(DISTINCT ...) not supported yet")
            return _AGG_FNS[name](self.lower(ast.args[0], scope))
        args = [self.lower(a, scope) for a in ast.args]
        if name in _TS_FIELD_FNS:
            self._arity(ast, 1)
            return _UNARY_FNS[name](self._session_wall_clock(args[0],
                                                             scope))
        if name in _UNARY_FNS:
            self._arity(ast, 1)
            return _UNARY_FNS[name](args[0])
        if name in _BINARY_FNS:
            self._arity(ast, 2)
            return _BINARY_FNS[name](args[0], args[1])
        if name in _VARARG_FNS:
            return _VARARG_FNS[name](*args)
        if name in ("substring", "substr"):
            pos = self._lit_value(ast.args[1], "substring position")
            if len(ast.args) >= 3:
                ln = self._lit_value(ast.args[2], "substring length")
                return S.Substring(args[0], pos, ln)
            return S.Substring(args[0], pos)
        if name in ("round", "bround"):
            scale = self._lit_value(ast.args[1], f"{name} scale") \
                if len(ast.args) > 1 else 0
            return (M.Round if name == "round" else M.BRound)(args[0],
                                                              scale)
        if name == "if":
            self._arity(ast, 3)
            return Cond.If(args[0], args[1], args[2])
        if name == "nvl2":
            self._arity(ast, 3)
            return Cond.Nvl2(args[0], args[1], args[2])
        if name == "get_json_object":
            from ..expr import json as JX
            self._arity(ast, 2)
            try:
                return JX.GetJsonObject(
                    args[0], self._lit_value(ast.args[1], "JSON path"))
            except TypeError as e:
                raise SqlError(f"get_json_object: {e}") from None
        if name == "from_json":
            from ..expr import json as JX
            self._arity(ast, 2)
            return JX.JsonToStructs(args[0], self._struct_schema(
                self._lit_value(ast.args[1], "schema")))
        if name == "to_json":
            from ..expr import json as JX
            self._arity(ast, 1)
            return JX.StructsToJson(args[0])
        return self._lower_scalar_fn(ast, args)

    @staticmethod
    def _struct_schema(text: str) -> dt.StructType:
        """A from_json schema, ``'a INT, b DECIMAL(10,2)'``, as the JAX
        analyzer reads it: fields split on the commas outside
        parentheses, each ``name type``."""
        parts, depth, cur = [], 0, []
        for ch in text:
            depth += (ch == "(") - (ch == ")")
            if ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur:
            parts.append("".join(cur))
        fields = []
        for part in parts:
            fname, _, ftype = part.strip().partition(" ")
            fields.append((fname, Parser(ftype.strip()).parse_type()))
        return dt.StructType(tuple(fields))

    def _session_wall_clock(self, arg: Expression, scope) -> Expression:
        """A timestamp argument of a field function moved to the session
        time zone's wall clock (spark.sql.session.timeZone); a date, or
        a UTC session, is left as it is."""
        from ..conf import SESSION_TIMEZONE
        zone = self.session.conf.get(SESSION_TIMEZONE)
        schema = scope.type_schema() if scope is not None else []
        if not arg.references() <= {n for n, _ in schema} or \
                arg.data_type(schema) != dt.TIMESTAMP or \
                zone in ("UTC", "GMT", "+00:00", "Z"):
            return arg
        from ..expr import timezone as TZ
        return self._made(lambda: TZ.FromUTCTimestamp(arg, zone),
                          f"session time zone {zone!r}")

    def _lower_scalar_fn(self, ast: FnA, args) -> Expression:
        """The functions with literal arguments: pads, replace,
        translate, locate, concat_ws, the regexes, the time-zone
        conversions and the date constructors."""
        from ..expr import regex as RX
        from ..expr import timezone as TZ
        name = ast.name

        def lit_arg(i: int, what: str):
            return self._lit_value(ast.args[i], what)

        if name in ("lpad", "rpad"):
            pad = lit_arg(2, "pad string") if len(ast.args) > 2 else " "
            cls = S.Lpad if name == "lpad" else S.Rpad
            return cls(args[0], lit_arg(1, "pad length"), pad)
        if name == "replace":
            return S.StringReplace(
                args[0], lit_arg(1, "search"),
                lit_arg(2, "replacement") if len(ast.args) > 2 else "")
        if name == "translate":
            self._arity(ast, 3)
            return self._made(lambda: S.StringTranslate(
                args[0], lit_arg(1, "from"), lit_arg(2, "to")), name)
        if name in ("locate", "position"):
            start = lit_arg(2, "start") if len(ast.args) > 2 else 1
            return S.StringLocate(args[1], lit_arg(0, "substring"), start)
        if name == "concat_ws":
            return S.ConcatWs(lit_arg(0, "separator"), *args[1:])
        if name == "from_unixtime":
            self._arity(ast, 1)
            return D.FromUnixTime(args[0])
        if name == "make_date":
            self._arity(ast, 3)
            return D.MakeDate(args[0], args[1], args[2])
        if name == "trunc":
            self._arity(ast, 2)
            return self._made(lambda: D.TruncDate(
                args[0], lit_arg(1, "trunc format")), name)
        if name == "regexp_extract":
            if len(ast.args) not in (2, 3):
                raise SqlError("regexp_extract expects 2 or 3 arguments, "
                               f"got {len(ast.args)}")
            grp = lit_arg(2, "group") if len(ast.args) > 2 else 1
            return self._made(lambda: RX.RegExpExtract(
                args[0], lit_arg(1, "pattern"), grp), name)
        if name == "regexp_replace":
            self._arity(ast, 3)
            return self._made(lambda: RX.RegExpReplace(
                args[0], lit_arg(1, "pattern"),
                lit_arg(2, "replacement")), name)
        if name in ("rlike", "regexp_like", "regexp"):
            self._arity(ast, 2)
            return self._made(lambda: RX.RLike(args[0],
                                               lit_arg(1, "pattern")), name)
        if name in ("from_utc_timestamp", "to_utc_timestamp"):
            self._arity(ast, 2)
            cls = TZ.FromUTCTimestamp if name == "from_utc_timestamp" \
                else TZ.ToUTCTimestamp
            return self._made(lambda: cls(args[0], lit_arg(1, "timezone")),
                              name)
        raise SqlError(f"unknown function {name!r}")

    def _arity(self, ast: FnA, n: int):
        if len(ast.args) != n:
            raise SqlError(f"{ast.name} expects {n} argument(s), got "
                           f"{len(ast.args)}")

    def _lit_value(self, ast, what: str):
        if not isinstance(ast, LitA):
            raise SqlError(f"{what} must be a literal")
        return ast.value


def parse_sql(session, text: str):
    """Parse + analyze SQL text into a DataFrame on ``session``."""
    stmt = Parser(text).parse_statement()
    return Analyzer(session).analyze(stmt)
