"""Session and DataFrame API.

Counterpart of spark_rapids_tpu/plan/session.py (TpuSession, DataFrame,
GroupedData) for filter / select / with_column / group_by / agg /
distinct / join / sort / limit / collect, window functions in select and
with_column, the temp-view catalog and ``sql``, joins of every type
(``join(how=...)``, ``cross_join``) and ``union``. The session runs on
one torch device, ``cuda`` unless the caller asks for the CPU; a session
asked for CUDA where there is none raises.

Each query registers with the device budget for its run (a budget
slice, and the owner its spillables are charged to), starts its
thread's task counters from zero, and leaves its task metrics
(``spilledBytes``, ``retryCount``, ``splitAndRetryCount``,
``spillTimeNs``, ``semaphoreWaitTimeNs``, ``allocAttempts``) in
``_last_execution[1].memory``.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..conf import OOM_INJECTION_MODE, SrtConf
from ..exec.base import ExecContext
from ..memory.budget import device_budget, query_scope, task_context
from ..expr.core import Alias, Expression, col, output_name
from . import logical as L
from .host_table import (HostColumn, HostTable, batch_to_table,
                         concat_tables, empty_table, table_to_batch,
                         to_pydict)
from .overrides import apply_overrides


def _to_expr(c) -> Expression:
    return col(c) if isinstance(c, str) else c


#: DataFrame.join's ``how`` names, as the JAX package spells them
_JOIN_TYPES = {"inner": "inner", "left": "left_outer",
               "left_outer": "left_outer", "right": "right_outer",
               "right_outer": "right_outer", "full": "full_outer",
               "full_outer": "full_outer", "outer": "full_outer",
               "semi": "left_semi", "left_semi": "left_semi",
               "anti": "left_anti", "left_anti": "left_anti",
               "cross": "cross"}


def _host_table_from_pydict(data: Dict[str, list], schema) -> HostTable:
    """{name: [python values, None for null]} with a [(name, DType)]
    schema -> HostTable."""
    from ..columnar.vector import HostStrings
    from ..expr.core import literal_physical
    cols = []
    for name, t in schema:
        vals = data[name]
        mask = np.array([v is not None for v in vals], bool)
        if t.np_physical is None:  # strings
            lane = HostStrings.from_objects(vals)
        else:
            lane = np.array([0 if v is None else literal_physical(v, t)
                             for v in vals], t.np_physical)
        cols.append(HostColumn(lane, mask, t))
    return HostTable(cols, [n for n, _ in schema])


def _extract_windows(plan: L.LogicalPlan, exprs):
    """Pull WindowExpressions out of a projection list into Window nodes
    (the analyzer step Spark performs for window functions in select):
    one Window node per distinct (partition_by, order_by) spec, chained;
    the projection then references the produced columns by name. Window
    expressions nested inside larger expressions (the TPC-DS
    ``sum(x)*100/sum(sum(x)) over (...)`` ratio shape) extract the same
    way: the surrounding arithmetic stays in the projection and reads
    the generated column."""
    from ..expr import conditional as Cond
    from ..expr.window import WindowExpression
    groups = {}  # spec signature -> [(WindowExpression, gen_name)]
    counter = [0]

    def pull(e):
        if isinstance(e, WindowExpression):
            # always a fresh internal name: a user alias may collide
            # with an input column, and name lookup resolves first-match
            gen = f"__w{counter[0]}"
            counter[0] += 1
            sig = (repr(e.spec.partition_by),
                   repr([(repr(o.expr), o.ascending, o.nulls_first)
                         for o in e.spec.order_fields]))
            groups.setdefault(sig, []).append((e, gen))
            return col(gen)
        if isinstance(e, Cond.CaseWhen):
            return Cond.CaseWhen(
                [(pull(c), pull(v)) for c, v in e.branches],
                pull(e.otherwise) if e.otherwise is not None else None)
        if not e.children:
            return e
        out = e.__class__.__new__(e.__class__)
        out.__dict__.update(e.__dict__)
        out.children = [pull(c) for c in e.children]
        return out

    out_exprs = []
    for i, e in enumerate(exprs):
        if isinstance(e, Alias):
            out_exprs.append(Alias(pull(e.children[0]), e.name))
        elif isinstance(e, WindowExpression):
            out_exprs.append(Alias(pull(e), f"_w{i}"))
        else:
            out_exprs.append(pull(e))
    for wexprs in groups.values():
        plan = L.Window(plan, wexprs)
    return plan, out_exprs


class TpuSession:
    """Entry point (SparkSession analogue): holds the conf and the
    device queries run on."""

    def __init__(self, conf: Optional[SrtConf] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TpuSession: CUDA is not available here; "
                               "pass device='cpu' to run on the CPU")
        self.conf = conf or SrtConf()
        self.device = device
        self._catalog: Dict[str, "DataFrame"] = {}
        #: (physical plan, ExecContext) of the most recent execute: its
        #: metrics (ctx.metric_totals()) outlive the query
        self._last_execution = None

    def from_batches(self, batches, schema=None) -> "DataFrame":
        """A DataFrame over batches already on this session's device."""
        batches = list(batches)
        for b in batches:
            if b.device != self.device:
                raise ValueError(f"batch on {b.device}, session on "
                                 f"{self.device}")
        if schema is None:
            schema = batches[0].schema()
        return DataFrame(self, L.DeviceRelation(batches, schema))

    def create_dataframe(self, table, schema=None) -> "DataFrame":
        """Move a host table (or a {name: [values]} dict with its
        [(name, DType)] schema) to the device in batches of
        ``srt.sql.batchSizeRows`` rows."""
        if not isinstance(table, HostTable):
            table = _host_table_from_pydict(table, schema)
        per = self.conf.batch_size_rows
        batches = [table_to_batch(table.slice(s, s + per),
                                  device=self.device)
                   for s in range(0, table.num_rows, per)]
        return self.from_batches(batches, table.schema())

    # --- SQL frontend (sql/parser.py) ---
    def create_or_replace_temp_view(self, name: str, df: "DataFrame"
                                    ) -> None:
        self._catalog[name.lower()] = df

    def table(self, name: str) -> "DataFrame":
        try:
            return self._catalog[name.lower()]
        except KeyError:
            raise KeyError(f"table or view {name!r} not found; register "
                           "with create_or_replace_temp_view") from None

    def sql(self, text: str) -> "DataFrame":
        """A SQL SELECT over the registered temp views."""
        from ..sql import parse_sql
        return parse_sql(self, text)

    _query_seq = itertools.count(1)

    def execute(self, plan: L.LogicalPlan) -> HostTable:
        """Run a logical plan to a host table, as one query of the
        device budget."""
        physical = apply_overrides(plan, self.conf)
        ctx = ExecContext(self.conf, self.device)
        self._last_execution = (physical, ctx)
        qid = f"q{os.getpid()}-{next(TpuSession._query_seq)}"
        task = task_context()
        task.reset_counters()
        mode = self.conf.get(OOM_INJECTION_MODE)
        if mode == "RETRY":
            task.force_retry_oom(0)
        elif mode == "SPLIT":
            task.force_split_and_retry_oom(0)
        budget = device_budget(self.conf, self.device)
        budget.register_query(qid)
        try:
            with query_scope(qid):
                tables = [batch_to_table(b) for b in physical.execute(ctx)
                          if b.num_rows]
        finally:
            budget.unregister_query(qid)
            ctx.memory = task.metrics()
        return concat_tables(tables) if tables else empty_table(plan.schema)


class DataFrame:
    """Lazy logical-plan builder."""

    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    def select(self, *cols) -> "DataFrame":
        plan, exprs = _extract_windows(self.plan,
                                       [_to_expr(c) for c in cols])
        return DataFrame(self.session, L.Project(plan, exprs))

    def with_column(self, name: str, expr) -> "DataFrame":
        existing = [col(n) for n, _ in self.plan.schema if n != name]
        return self.select(*existing, Alias(_to_expr(expr), name))

    def filter(self, condition) -> "DataFrame":
        return DataFrame(self.session,
                         L.Filter(self.plan, _to_expr(condition)))

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [_to_expr(c) for c in cols])

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join. ``on`` is a column name, a list of names (USING:
        for inner, left outer, semi and anti joins the key is kept once,
        from the left; other types keep both) or a pair (left key
        expressions, right key expressions). ``how`` takes the JAX
        package's names (``inner``, ``left``, ``right``, ``full`` /
        ``outer``, ``semi``, ``anti``, ``cross`` and the long forms)."""
        if how not in _JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}")
        how = _JOIN_TYPES[how]
        if isinstance(on, str):
            on = [on]
        using: List[str] = []
        if isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            using = list(on)
            lk = [col(n) for n in on]
            rk = [col(n) for n in on]
        elif isinstance(on, tuple) and len(on) == 2:
            lk = [_to_expr(e) for e in on[0]]
            rk = [_to_expr(e) for e in on[1]]
        else:
            raise TypeError("join `on`: column name(s) or (left_exprs, "
                            "right_exprs)")
        joined: L.LogicalPlan = L.Join(self.plan, other.plan, lk, rk, how)
        if using and how in ("inner", "left_outer", "left_semi",
                             "left_anti"):
            # the left copy of the key is the right survivor for these;
            # a semi or anti join has no right columns
            keep = [col(n) for n in self.columns]
            if how in ("inner", "left_outer"):
                keep += [col(n) for n in other.columns if n not in using]
            joined = L.Project(joined, keep)
        return DataFrame(self.session, joined)

    def cross_join(self, other: "DataFrame",
                   condition: Optional[Expression] = None) -> "DataFrame":
        """Cartesian product, or with ``condition`` a nested-loop join
        keeping the pairs where it is true."""
        how = "cross" if condition is None else "inner"
        return DataFrame(self.session, L.Join(
            self.plan, other.plan, [], [], how, condition=condition))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position; the columns take this side's names."""
        return DataFrame(self.session, L.Union(self.plan, other.plan))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.Limit(self.plan, n))

    def distinct(self) -> "DataFrame":
        """Distinct rows: a grouping on every column with no aggregate
        (Spark's rewrite of Distinct)."""
        return GroupedData(self, [col(n) for n in self.columns]).agg()

    def sort(self, *cols, ascending: Union[bool, Sequence[bool]] = True
             ) -> "DataFrame":
        exprs = [_to_expr(c) for c in cols]
        if isinstance(ascending, bool):
            ascending = [ascending] * len(exprs)
        return DataFrame(self.session, L.Sort(
            self.plan, [L.SortField(e, a) for e, a in zip(exprs, ascending)]))

    @property
    def schema(self) -> List:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.plan.schema]

    def to_table(self) -> HostTable:
        return self.session.execute(self.plan)

    def collect(self) -> List[dict]:
        """Run the query and return its rows as dicts."""
        table = self.to_table()
        data = to_pydict(table)
        return [{k: data[k][i] for k in data} for i in range(table.num_rows)]

    def explain(self) -> str:
        """The physical plan this DataFrame runs as."""
        out = apply_overrides(self.plan, self.session.conf).tree_string()
        print(out)
        return out

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}" for n, t in self.plan.schema)
        return f"DataFrame[{cols}]"


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        pairs = []
        for i, a in enumerate(aggs):
            if isinstance(a, Alias):
                pairs.append((a.children[0], a.name))
            else:
                pairs.append((a, output_name(a, len(self.keys) + i)))
        return DataFrame(self.df.session,
                         L.Aggregate(self.df.plan, self.keys, pairs))
