"""Cartesian product and broadcast nested-loop join.

Counterpart of spark_rapids_tpu/exec/nested_loop_join.py: the join path
without equi-keys. The build (right) side is concatenated once; each
probe (left) batch is paired with every build row in tiles of at most
``tile_rows`` pairs, probe-row-major, so memory stays bounded. An
optional condition is an ordinary Expression evaluated over each tile's
paired batch (probe columns, then build columns); the pairs where it is
true are compacted to the output. Only live rows are paired (the JAX
package pairs whole capacities and masks, because its shapes are
static).
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from ..columnar.vector import ColumnarBatch
from ..expr.core import Expression
from ..ops import kernels as K
from .base import ExecContext, Schema, TpuExec


def pair_tile(probe: ColumnarBatch, build: ColumnarBatch, start: int,
              size: int) -> ColumnarBatch:
    """Pairs ``start .. start + size`` of probe x build in probe-row-major
    order (pair k is probe row k // build rows, build row k % build
    rows), as one batch of probe then build columns."""
    flat = torch.arange(start, start + size, device=probe.device)
    p_idx = flat // build.num_rows
    b_idx = flat % build.num_rows
    cols = [c.gather(p_idx) for c in probe.columns] + \
        [c.gather(b_idx) for c in build.columns]
    return ColumnarBatch(cols, probe.names + build.names, size, probe.device)


class BroadcastNestedLoopJoinExec(TpuExec):
    """Inner or cross nested-loop join with an optional condition; left
    is the streamed side, right the broadcast (build) side."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 condition: Optional[Expression] = None,
                 join_type: str = "inner", tile_rows: int = 1 << 16):
        super().__init__(left, right)
        if join_type not in ("inner", "cross"):
            raise NotImplementedError(
                f"nested-loop join type {join_type!r} is not in this port "
                "yet")
        self.condition = condition
        self.join_type = join_type
        self.tile_rows = tile_rows

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema + \
            self.children[1].output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        build = K.concat_stream(self.children[1].execute(ctx))
        if build is None:
            return
        for probe in self.children[0].execute(ctx):
            total = probe.num_rows * build.num_rows
            for start in range(0, total, self.tile_rows):
                out = pair_tile(probe, build, start,
                                min(self.tile_rows, total - start))
                if self.condition is not None:
                    out = K.filter_batch(out, self.condition.eval(out))
                if out.num_rows:
                    yield out

    def node_description(self) -> str:
        c = f", cond={self.condition!r}" if self.condition is not None \
            else ""
        return f"BroadcastNestedLoopJoin[{self.join_type}{c}]"


class CartesianProductExec(BroadcastNestedLoopJoinExec):
    """CROSS JOIN: a nested loop without a condition."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 tile_rows: int = 1 << 16):
        super().__init__(left, right, condition=None, join_type="cross",
                         tile_rows=tile_rows)

    def node_description(self) -> str:
        return "CartesianProduct"
