"""Basic physical operators: scan over device batches, project, filter.

Counterpart of spark_rapids_tpu/exec/basic.py (BatchScanExec,
ProjectExec, FilterExec, LocalLimitExec, UnionExec, ExpandExec,
CoalesceBatchesExec).
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

from ..columnar.vector import ColumnarBatch, choose_capacity
from ..conf import BATCH_SIZE_ROWS
from ..expr.cast import Cast
from ..expr.core import Expression, output_name
from ..expr.misc import row_offset, uses_row_position
from ..memory.retry import with_retry_no_split
from ..memory.spill import SpillableBatch
from ..ops import kernels as K
from .base import ExecContext, Metric, Schema, TpuExec


class BatchScanExec(TpuExec):
    """Leaf: yields pre-built device batches (in-memory table scan)."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema):
        super().__init__()
        self._batches = list(batches)
        self._schema = list(schema)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        yield from self._batches

    def node_description(self) -> str:
        return f"BatchScan[{len(self._batches)} batches]"


class ProjectExec(TpuExec):
    def __init__(self, child: TpuExec, exprs: Sequence[Expression]):
        super().__init__(child)
        self.exprs = list(exprs)
        in_schema = child.output_schema
        self._schema = [(output_name(e, i), e.data_type(in_schema))
                        for i, e in enumerate(self.exprs)]

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self._schema]
        positional = uses_row_position(self.exprs)
        offset = 0
        for batch in self.children[0].execute(ctx):
            if positional:
                # row ids continue across batches (expr/misc.py)
                with row_offset(offset):
                    cols = [e.eval(batch) for e in self.exprs]
                offset += batch.num_rows
            else:
                cols = [e.eval(batch) for e in self.exprs]
            yield ColumnarBatch(cols, names, batch.num_rows, batch.device)

    def node_description(self) -> str:
        return f"Project[{', '.join(n for n, _ in self._schema)}]"


class FilterExec(TpuExec):
    """WHERE: compacts passing rows to the batch prefix."""

    def __init__(self, child: TpuExec, condition: Expression):
        super().__init__(child)
        self.condition = condition

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute(ctx):
            yield K.filter_batch(batch, self.condition.eval(batch))

    def node_description(self) -> str:
        return f"Filter[{self.condition!r}]"


class LocalLimitExec(TpuExec):
    """LIMIT n within the stream."""

    def __init__(self, child: TpuExec, limit: int):
        super().__init__(child)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for batch in self.children[0].execute(ctx):
            if remaining <= 0:
                return
            out = K.local_limit(batch, remaining)
            remaining -= out.num_rows
            yield out

    def node_description(self) -> str:
        return f"LocalLimit[{self.limit}]"


class UnionExec(TpuExec):
    """UNION ALL: the children's streams one after another, each batch's
    columns renamed to the first child's names. As in the JAX package,
    no column is cast: a child whose types differ from the first's
    passes its own batches on."""

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self.output_schema]
        for child in self.children:
            for batch in child.execute(ctx):
                yield ColumnarBatch(batch.columns, names, batch.num_rows,
                                    batch.device, capacity=batch.capacity)

    def node_description(self) -> str:
        return f"Union[{len(self.children)}]"


class ExpandExec(TpuExec):
    """GROUPING SETS / ROLLUP / CUBE: one output batch per projection
    list for every input batch (GpuExpandExec). ``schema`` is the
    logical Expand's, whose columns take the common type of their slot
    across the lists; a slot of another type is cast to it, so every
    batch has that schema. A slot that is a plain column reference
    passes the input's column on (no copy); a NULL-ed key slot is an
    all-null column at the batch's capacity."""

    def __init__(self, child: TpuExec,
                 projections: Sequence[Sequence[Expression]],
                 schema: Schema):
        super().__init__(child)
        in_schema = child.output_schema
        self._schema = list(schema)
        self.projections = [
            [e if e.data_type(in_schema) == t else Cast(e, t)
             for e, (_, t) in zip(p, self._schema)] for p in projections]

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self._schema]
        for batch in self.children[0].execute(ctx):
            for proj in self.projections:
                yield ColumnarBatch([e.eval(batch) for e in proj], names,
                                    batch.num_rows, batch.device,
                                    capacity=batch.capacity)

    def node_description(self) -> str:
        return f"Expand[{len(self.projections)} projections]"


class CoalesceBatchesExec(TpuExec):
    """Combine small batches up to the target row count
    (GpuCoalesceBatches, AbstractGpuCoalesceIterator:250). Pending
    batches are held as spillables while they accumulate, like the
    reference's on-deck storage. The JAX planner places none; a caller
    builds it over a child that emits small batches."""

    def __init__(self, child: TpuExec, target_rows: Optional[int] = None):
        super().__init__(child)
        self.target_rows = target_rows

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        target = self.target_rows or ctx.conf.get(BATCH_SIZE_ROWS)
        counters = ctx.retry_counters(self.exec_id)
        # time spent blocked pulling the child
        wait = ctx.metric(self.exec_id, "coalesceWaitTime", Metric.MODERATE,
                          "ns")
        pending: List[SpillableBatch] = []
        pending_rows = 0

        def flush() -> ColumnarBatch:
            nonlocal pending, pending_rows
            cap = choose_capacity(pending_rows)

            def concat():
                batches = [sb.get() for sb in pending]
                if len(batches) == 1:
                    return batches[0]
                with ctx.semaphore:
                    return K.concat_batches(batches, cap)
            out = with_retry_no_split(concat, counters=counters)
            for sb in pending:
                sb.close()
            pending, pending_rows = [], 0
            return out

        try:
            it = iter(self.children[0].execute(ctx))
            while True:
                t0 = time.perf_counter_ns()
                batch = next(it, None)
                wait.add(time.perf_counter_ns() - t0)
                if batch is None:
                    break
                n = batch.num_rows
                if n == 0:
                    continue
                if n >= target and not pending:
                    # already at target with nothing buffered
                    yield batch
                    continue
                if pending_rows + n > target and pending:
                    yield flush()
                    if n >= target:
                        yield batch
                        continue
                pending.append(with_retry_no_split(
                    lambda b=batch: SpillableBatch(b), counters=counters))
                pending_rows += n
                del batch
                if pending_rows >= target:
                    yield flush()
            if pending:
                yield flush()
        finally:
            for sb in pending:
                sb.close()

    def node_description(self) -> str:
        return f"CoalesceBatches[target={self.target_rows or 'conf'}]"
