"""Generate exec: explode / explode_outer / posexplode over list columns.

Counterpart of spark_rapids_tpu/exec/generate.py (GpuGenerateExec): one
output row per array element, the generating row's columns repeated.
The JAX exec runs its kernel at a static capacity and retries at the
reported size on overflow (:66-80); eager torch reads the total and
sizes the output once (ops/kernels.py ``explode_batch``).
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnarBatch
from ..expr.collections import Explode
from ..ops import kernels as K
from .base import ExecContext, Schema, TpuExec


class GenerateExec(TpuExec):
    def __init__(self, child: TpuExec, generator: Explode,
                 element_name: str, pos_name: Optional[str] = None):
        super().__init__(child)
        self.generator = generator
        self.element_name = element_name
        self.pos_name = pos_name if generator.with_position else None
        in_schema = child.output_schema
        self._schema = list(in_schema)
        if self.pos_name:
            self._schema.append((self.pos_name, dt.INT32))
        self._schema.append((element_name, generator.data_type(in_schema)))

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute(ctx):
            if batch.num_rows == 0:
                continue
            lc = self.generator.children[0].eval(batch)
            with ctx.semaphore:
                out = K.explode_batch(batch, lc, self.element_name,
                                      outer=self.generator.outer,
                                      pos_name=self.pos_name)
            if out.num_rows:
                yield out

    def node_description(self) -> str:
        kind = "posexplode" if self.pos_name else "explode"
        outer = "_outer" if self.generator.outer else ""
        return f"Generate[{kind}{outer} -> {self.element_name}]"
