"""Basic physical operators: scan over device batches, project, filter.

Counterpart of spark_rapids_tpu/exec/basic.py (BatchScanExec,
ProjectExec, FilterExec, LocalLimitExec, UnionExec, ExpandExec,
RangeExec, SampleExec, CoalesceBatchesExec).
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (ColumnVector, ColumnarBatch, choose_capacity,
                               live_mask)
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


class RangeExec(TpuExec):
    """``SELECT id FROM range(start, end, step)`` (GpuRangeExec), in
    batches of ``srt.sql.batchSizeRows`` rows made on the device."""

    def __init__(self, start: int, end: int, step: int = 1,
                 batch_rows: Optional[int] = None):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> Schema:
        return [("id", dt.INT64)]

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        per = self.batch_rows or ctx.conf.get(BATCH_SIZE_ROWS)
        total = max(0, -(-(self.end - self.start) // self.step))
        done = 0
        while done < total:
            n = min(per, total - done)
            cap = choose_capacity(n)
            live = live_mask(cap, n, ctx.device)
            ids = torch.arange(cap, dtype=torch.int64, device=ctx.device) \
                * self.step + (self.start + done * self.step)
            col = ColumnVector(torch.where(live, ids, 0), live, dt.INT64)
            yield ColumnarBatch([col], ["id"], n, ctx.device)
            done += n

    def node_description(self) -> str:
        return f"Range[{self.start}, {self.end}, step={self.step}]"


def sample_keep_mask(row_offset: int, capacity: int, fraction: float,
                     seed: int, device) -> torch.Tensor:
    """The Bernoulli keep mask of a batch whose row 0 is the stream's row
    ``row_offset``: murmur3 of each row's stream position under ``seed``
    below ``fraction * 2^32`` (the JAX package's rule, so both keep the
    same rows whatever the batch sizes). The CPU engine runs it too."""
    if fraction >= 1.0:
        return torch.ones(capacity, dtype=torch.bool, device=device)
    from ..expr.hashing import murmur3_column
    pos = torch.arange(capacity, dtype=torch.int64, device=device) + \
        row_offset
    h = murmur3_column(ColumnVector(pos, torch.ones(
        capacity, dtype=torch.bool, device=device), dt.INT64), seed)
    return h < min(int(fraction * (1 << 32)), (1 << 32) - 1)


class SampleExec(TpuExec):
    """DataFrame.sample: a filter by ``sample_keep_mask`` over the stream
    position (GpuSampleExec, basicPhysicalOperators.scala)."""

    def __init__(self, child: TpuExec, fraction: float, seed: int):
        super().__init__(child)
        self.fraction = fraction
        self.seed = seed

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        offset = 0
        for batch in self.children[0].execute(ctx):
            keep = sample_keep_mask(offset, batch.capacity, self.fraction,
                                    self.seed, batch.device)
            live = batch.live_mask()
            offset += batch.num_rows
            yield K.filter_batch(batch, ColumnVector(keep & live, live,
                                                     dt.BOOL))

    def node_description(self) -> str:
        return f"Sample[{self.fraction}, seed={self.seed}]"
