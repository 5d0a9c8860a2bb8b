"""Basic physical operators: scan over device batches, project, filter.

Counterpart of spark_rapids_tpu/exec/basic.py (BatchScanExec,
ProjectExec, FilterExec, LocalLimitExec).
"""

from __future__ import annotations

from typing import Iterator, Sequence

from ..columnar.vector import ColumnarBatch
from ..expr.core import Expression, output_name
from ..ops import kernels as K
from .base import ExecContext, Schema, TpuExec


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
        for batch in self.children[0].execute(ctx):
            yield ColumnarBatch([e.eval(batch) for e in self.exprs], names,
                                batch.num_rows, batch.device)

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
