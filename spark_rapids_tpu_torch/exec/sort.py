"""Sort exec (in-core) and TopN.

Counterpart of spark_rapids_tpu/exec/sort.py's in-core path: at one
partition a global sort concatenates the child's batches and sorts them
with one stable multi-key sort, emitted as one batch or, below a batched
running window, in slices of ``batch_rows`` rows; TopNExec fuses ORDER BY
+ LIMIT. The out-of-core merge is not ported.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from ..columnar.vector import ColumnarBatch, choose_capacity
from ..expr.core import Expression
from ..ops import kernels as K
from .base import ExecContext, Schema, TpuExec


class SortOrder:
    """(expr, ascending, nulls_first)."""

    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = ascending if nulls_first is None else nulls_first


class SortExec(TpuExec):
    """Global in-core sort. With ``batch_rows`` the sorted rows leave in
    batches of that many rows (the last one shorter), so that a consumer
    that streams with carried state sees them batch by batch."""

    def __init__(self, child: TpuExec, order: Sequence[SortOrder],
                 batch_rows: Optional[int] = None):
        super().__init__(child)
        self.order = list(order)
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator:
        held = [b for b in self.children[0].execute(ctx) if b.num_rows > 0]
        if not held:
            return
        batch = held[0] if len(held) == 1 else K.concat_batches(
            held, choose_capacity(sum(b.num_rows for b in held)))
        keys = [o.expr.eval(batch) for o in self.order]
        out = K.sort_batch(batch, keys, [o.ascending for o in self.order],
                           [o.nulls_first for o in self.order])
        per = self.batch_rows
        if per is None or out.num_rows <= per:
            yield out
            return
        cap = choose_capacity(per)
        for start in range(0, out.num_rows, per):
            yield K.slice_batch(out, start, per, cap)

    def node_description(self) -> str:
        keys = ", ".join(f"{o.expr!r} {'ASC' if o.ascending else 'DESC'}"
                         for o in self.order)
        return f"Sort[{keys}]"


class TopNExec(TpuExec):
    """ORDER BY + LIMIT n fused: keeps only the top n rows of each batch,
    shrunk to the limit's capacity, then selects the top n of those.
    Memory stays O(batches * n), not the full-sort concat."""

    def __init__(self, child: TpuExec, order: Sequence[SortOrder],
                 limit: int):
        super().__init__(child)
        self.order = list(order)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def _topn(self, batch: ColumnarBatch) -> ColumnarBatch:
        keys = [o.expr.eval(batch) for o in self.order]
        sorted_b = K.sort_batch(batch, keys, [o.ascending for o in self.order],
                                [o.nulls_first for o in self.order])
        return K.local_limit(sorted_b, self.limit)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        part_cap = choose_capacity(self.limit)
        partials: List[ColumnarBatch] = []
        for batch in self.children[0].execute(ctx):
            if batch.num_rows == 0:
                continue
            part = self._topn(batch)
            if part.capacity > part_cap:
                part = K.repack_to(part, part_cap)
            partials.append(part)
        if not partials:
            return
        total = sum(p.num_rows for p in partials)
        merged = partials[0] if len(partials) == 1 else K.concat_batches(
            partials, choose_capacity(max(total, self.limit)))
        yield self._topn(merged)

    def node_description(self) -> str:
        return f"TopN[{self.limit}]"
