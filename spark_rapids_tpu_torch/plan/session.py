"""Session and DataFrame API.

Counterpart of spark_rapids_tpu/plan/session.py (TpuSession, DataFrame,
GroupedData) for filter / select / with_column / group_by / agg (and
the ``count`` / ``sum`` / ``min`` / ``max`` / ``avg`` shorthands) /
distinct / join / sort / sort_desc / limit / sample / collect /
to_pydict / to_pandas / count, ``TpuSession.range``, window functions
and explode
generators in select and with_column, nested columns (arrays, structs,
maps) in ``create_dataframe``, the temp-view catalog and ``sql``, joins of every type
(``join(how=...)``, ``cross_join``) and ``union``, Parquet and
standard-format Delta tables through ``session.read`` and ``df.write``,
and the ML hand-off ``to_device_arrays``. The session runs on
one torch device, ``cuda`` unless the caller asks for the CPU; a session
asked for CUDA where there is none raises.

Planning tags each node for the device or the CPU engine
(plan/overrides.py); a query whose root runs on the CPU engine returns
that engine's table, and with ``srt.sql.enabled=false`` the whole plan
runs there. ``DataFrame.explain(mode)`` prints the marks (``*`` on the
device, ``!`` on the CPU engine with the reasons) and the physical tree
with its seams; ``explain(metrics=True)`` runs the query and prints
each operator with its metrics. Under ``srt.sql.ansi.enabled`` the plan
runs with ANSI semantics (expr/ansi.py).

Each query registers with the device budget for its run (a budget
slice, and the owner its spillables are charged to), starts its
thread's task counters from zero, and leaves its task metrics
(``spilledBytes``, ``retryCount``, ``splitAndRetryCount``,
``spillTimeNs``, ``semaphoreWaitTimeNs``, ``allocAttempts``) in
``_last_execution[1].memory``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..conf import OOM_INJECTION_MODE, SrtConf
from ..exec.base import ExecContext, TpuExec
from ..memory.budget import device_budget, query_scope, task_context
from ..expr.aggregates import Average, CountStar, Max, Min, Sum
from ..expr.core import Alias, Expression, col, output_name
from . import logical as L
from .host_table import (HostTable, batch_to_table, concat_tables,
                         empty_like, from_engine, from_pydict,
                         table_to_batch, to_pydict)
from .overrides import apply_overrides, tag_only


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
    schema -> HostTable in the device path's layout."""
    return from_engine(from_pydict(data, schema))


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


def _extract_generators(plan: L.LogicalPlan, exprs):
    """Pull explode generators out of a projection into a Generate node
    (the analyzer step Spark performs for explode() in select; JAX
    session.py:493): at most one generator a projection. The element
    column takes the alias (``col`` without one), posexplode's position
    ``pos``, a map's entries Spark's ``key`` and ``value``."""
    from ..expr.collections import Explode
    out_exprs = []
    gen_count = 0
    for i, e in enumerate(exprs):
        inner = e.children[0] if isinstance(e, Alias) else e
        if not isinstance(inner, Explode):
            out_exprs.append(e)
            continue
        gen_count += 1
        if gen_count > 1:
            raise ValueError("only one generator allowed per select")
        user = e.name if isinstance(e, Alias) else "col"
        pos_name = f"__gpos{i}" if inner.with_position else None
        plan = L.Generate(plan, inner, f"__gen{i}", pos_name)
        if pos_name:
            out_exprs.append(Alias(col(pos_name), "pos"))
        if plan.value_name:
            # a map's entries: Spark's key and value columns
            out_exprs += [Alias(col(f"__gen{i}"), "key"),
                          Alias(col(plan.value_name), "value")]
        else:
            out_exprs.append(Alias(col(f"__gen{i}"), user))
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
        ``srt.sql.batchSizeRows`` rows. A nested column's values are
        Python lists (arrays), dicts or tuples (structs) and dicts
        (maps), None for null; a host table may carry flat lanes
        (columnar/nested.py ``HostList`` / ``HostStruct``)."""
        if not isinstance(table, HostTable):
            table = _host_table_from_pydict(table, schema)
        per = self.conf.batch_size_rows
        batches = [table_to_batch(table.slice(s, s + per),
                                  device=self.device)
                   for s in range(0, table.num_rows, per)]
        return self.from_batches(batches, table.schema())

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> "DataFrame":
        """``id`` BIGINT from ``start`` to ``end`` (exclusive) by
        ``step``; ``range(n)`` is ``range(0, n)``. The ids are made on
        the device, batch by batch."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(start, end, step))

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

    @property
    def read(self):
        """``session.read.parquet(path)`` (io/reader.py)."""
        from ..io.reader import DataFrameReader
        return DataFrameReader(self)

    _query_seq = itertools.count(1)

    @contextlib.contextmanager
    def _query(self, plan: L.LogicalPlan):
        """Plan ``plan`` and hold it as one query of the device budget
        while the block runs it: yields (physical plan, ExecContext).
        Under ``srt.sql.ansi.enabled`` the plan is first cloned with
        every Cast / arithmetic / SUM / AVG node ansi-marked
        (expr/ansi.py), so overflow and invalid casts raise."""
        if self.conf.ansi:
            from ..expr.ansi import rewrite_plan
            plan = rewrite_plan(plan)
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
                yield physical, ctx
        finally:
            budget.unregister_query(qid)
            ctx.memory = task.metrics()

    def execute(self, plan: L.LogicalPlan) -> HostTable:
        """Run a logical plan to a host table, as one query of the
        device budget."""
        with self._query(plan) as (physical, ctx):
            if isinstance(physical, TpuExec):
                tables = [batch_to_table(b)
                          for b in physical.execute(ctx) if b.num_rows]
            else:  # the root runs on the CPU engine
                tables = [from_engine(physical.evaluate(ctx))]
        return concat_tables(tables) if tables else \
            from_engine(empty_like(plan.schema))


class DeviceColumns(dict):
    """{name: (data, validity)} device tensors with the live row count:
    a string column's data is (offsets, chars). The tensors are
    capacity-padded past ``num_rows``, so a consumer slices to it
    (padding rows are indistinguishable from nulls by validity
    alone)."""

    def __init__(self, cols: dict, num_rows: int):
        super().__init__(cols)
        self.num_rows = num_rows


class DataFrame:
    """Lazy logical-plan builder."""

    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    def select(self, *cols) -> "DataFrame":
        plan, exprs = _extract_generators(self.plan,
                                          [_to_expr(c) for c in cols])
        plan, exprs = _extract_windows(plan, exprs)
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

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """A Bernoulli sample: a row is kept where murmur3 of its stream
        position under ``seed`` falls below ``fraction * 2^32``, so the
        same rows whatever the batch sizes (and the JAX package's)."""
        return DataFrame(self.session, L.Sample(self.plan, fraction, seed))

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

    def sort_desc(self, *cols) -> "DataFrame":
        return self.sort(*cols, ascending=False)

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

    def to_pydict(self) -> dict:
        """Run the query: {column: [values]}."""
        return to_pydict(self.to_table())

    def to_pandas(self):
        """Run the query into a pandas DataFrame (pandas is imported
        here, not by the package)."""
        import pandas as pd
        return pd.DataFrame(self.to_pydict())

    def count(self) -> int:
        """Run the query and count its rows."""
        return self.to_table().num_rows

    def to_device_arrays(self) -> DeviceColumns:
        """The ML hand-off (ColumnarRdd.scala:42 role: the reference
        hands cuDF tables to XGBoost): the query's columns on the
        session's device, the batches joined by one concat and no other
        copy; a plan whose root runs on the CPU engine comes back
        through the host-to-device seam. A DECIMAL above precision 18
        or a nested column has no flat tensor and raises TypeError."""
        from ..columnar.vector import ColumnVector, StringColumn
        from ..ops.kernels import concat_stream
        from .transitions import HostToDeviceExec
        session = self.session
        with session._query(self.plan) as (physical, ctx):
            if not isinstance(physical, TpuExec):
                physical = HostToDeviceExec(physical)
            merged = concat_stream(physical.execute(ctx))
        if merged is None:
            return DeviceColumns({}, 0)
        cols = {}
        for name, c in zip(merged.names, merged.columns):
            if isinstance(c, StringColumn):
                cols[name] = ((c.offsets, c.chars), c.validity)
            elif isinstance(c, ColumnVector):
                cols[name] = (c.data, c.validity)
            else:
                raise TypeError(f"to_device_arrays: column {name!r} "
                                f"({c.dtype}) has no flat device array")
        return DeviceColumns(cols, merged.num_rows)

    @property
    def write(self):
        """``df.write.mode(...).partition_by(...).parquet(path)``
        (io/writer.py)."""
        from ..io.writer import DataFrameWriter
        return DataFrameWriter(self)

    def explain(self, mode: Optional[str] = None,
                metrics: bool = False) -> str:
        """The physical plan this DataFrame runs as; with ``mode``
        (``ALL`` or ``NOT_ON_TPU``, as ``srt.sql.explain``) first the
        tagging's marks: every node (``ALL``) or only those that run on
        the CPU engine, with the reasons. With ``metrics`` the query
        runs first and each device operator is printed with its metrics
        (``opTime`` and the other times in ms) and a footer with the
        query's wall time and totals."""
        if metrics:
            return self._explain_metrics()
        out = apply_overrides(self.plan, self.session.conf).tree_string()
        if mode is not None:
            if mode not in ("ALL", "NOT_ON_TPU"):
                raise ValueError(f"explain mode {mode!r}: ALL or NOT_ON_TPU")
            marks = tag_only(self.plan, self.session.conf).explain_lines(
                only_not_on_tpu=mode == "NOT_ON_TPU")
            out = "\n".join(marks + [out])
        print(out)
        return out

    def _explain_metrics(self) -> str:
        t0 = time.perf_counter_ns()
        self.to_table()
        wall_ns = time.perf_counter_ns() - t0
        physical, ctx = self.session._last_execution
        body = _metrics_tree_lines(physical, ctx.metrics) \
            if isinstance(physical, TpuExec) else \
            [f"* {physical.node_description()} (CPU engine)"]
        totals = ctx.metric_totals()
        footer = (f"query: wall={wall_ns / 1e6:.1f}ms "
                  f"opTime={totals.get('opTime', 0) / 1e6:.1f}ms "
                  f"rows={totals.get('numOutputRows', 0)} "
                  f"spilledBytes={ctx.memory.get('spilledBytes', 0)} "
                  f"retries={ctx.memory.get('retryCount', 0)}")
        out = "\n".join(body + [footer])
        print(out)
        return out

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}" for n, t in self.plan.schema)
        return f"DataFrame[{cols}]"


def _metrics_tree_lines(node, metrics, indent: int = 0) -> List[str]:
    """The physical tree, each device operator with its metrics (the
    reference's SQL-UI annotations); a CPU-engine node under a seam is
    printed with its own children."""
    line = "  " * indent + "* " + node.node_description()
    parts = []
    for name, met in sorted(metrics.get(getattr(node, "exec_id", None),
                                        {}).items()):
        parts.append(f"{name}={met.value / 1e6:.1f}ms" if met.unit == "ns"
                     else f"{name}={met.value}{met.unit}")
    if parts:
        line += "  [" + ", ".join(parts) + "]"
    lines = [line]
    for c in getattr(node, "children", []):
        lines.extend(_metrics_tree_lines(c, metrics, indent + 1))
    return lines


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

    def count(self) -> DataFrame:
        return self.agg(Alias(CountStar(), "count"))

    def _simple(self, fn_cls, cols) -> DataFrame:
        return self.agg(*[Alias(fn_cls(_to_expr(c)), f"{fn_cls.name}({c})")
                          for c in cols])

    def sum(self, *cols) -> DataFrame:
        return self._simple(Sum, cols)

    def min(self, *cols) -> DataFrame:
        return self._simple(Min, cols)

    def max(self, *cols) -> DataFrame:
        return self._simple(Max, cols)

    def avg(self, *cols) -> DataFrame:
        return self._simple(Average, cols)

    mean = avg
