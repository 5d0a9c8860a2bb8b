"""Session and DataFrame API.

Counterpart of spark_rapids_tpu/plan/session.py (TpuSession, DataFrame,
GroupedData) for filter / select / group_by / agg / join / sort / limit
/ collect. The
session runs on one torch device, ``cuda`` unless the caller asks for
the CPU; a session asked for CUDA where there is none raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..conf import SrtConf
from ..exec.base import ExecContext
from ..expr.core import Alias, Expression, col, output_name
from . import logical as L
from .host_table import (HostTable, batch_to_table, concat_tables,
                         empty_table, table_to_batch, to_pydict)
from .overrides import apply_overrides


def _to_expr(c) -> Expression:
    return col(c) if isinstance(c, str) else c


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

    def create_dataframe(self, table: HostTable) -> "DataFrame":
        """Move a host table to the device in batches of
        ``srt.sql.batchSizeRows`` rows."""
        per = self.conf.batch_size_rows
        batches = [table_to_batch(table.slice(s, s + per),
                                  device=self.device)
                   for s in range(0, table.num_rows, per)]
        return self.from_batches(batches, table.schema())

    def execute(self, plan: L.LogicalPlan) -> HostTable:
        """Run a logical plan to a host table."""
        physical = apply_overrides(plan, self.conf)
        ctx = ExecContext(self.conf, self.device)
        self._last_execution = (physical, ctx)
        tables = [batch_to_table(b) for b in physical.execute(ctx)
                  if b.num_rows]
        return concat_tables(tables) if tables else empty_table(plan.schema)


class DataFrame:
    """Lazy logical-plan builder."""

    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    def select(self, *cols) -> "DataFrame":
        return DataFrame(self.session,
                         L.Project(self.plan, [_to_expr(c) for c in cols]))

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
        the key is kept once, from the left) or a pair (left key
        expressions, right key expressions). Only ``how="inner"`` is in
        this port yet."""
        if how != "inner":
            raise NotImplementedError(f"{how!r} join is not in this port "
                                      "yet")
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
        if using:
            keep = [col(n) for n in self.columns] + \
                [col(n) for n in other.columns if n not in using]
            joined = L.Project(joined, keep)
        return DataFrame(self.session, joined)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.Limit(self.plan, n))

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
