"""Exec base: the physical operator protocol and its metrics.

Counterpart of spark_rapids_tpu/exec/base.py, without the device
semaphore, profiler spans and fault-injection hooks (not ported yet).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Iterator, List, Optional

import torch

from ..columnar.vector import ColumnarBatch
from ..conf import SrtConf

Schema = List  # [(name, DType), ...]


class Metric:
    """One operator metric (an accumulator)."""

    ESSENTIAL = "ESSENTIAL"
    MODERATE = "MODERATE"
    DEBUG = "DEBUG"

    def __init__(self, name: str, level: str = MODERATE, unit: str = ""):
        self.name = name
        self.level = level
        self.unit = unit
        self.value = 0

    def add(self, v) -> None:
        self.value += int(v)

    def __repr__(self):
        return f"{self.name}={self.value}{self.unit}"


class ExecContext:
    """Per-query execution context: conf, the session's device and the
    metrics sink. The device is ``cuda`` unless the caller asks for the
    CPU, as for TpuSession; a context asked for CUDA where there is none
    raises."""

    def __init__(self, conf: Optional[SrtConf] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExecContext: CUDA is not available here; "
                               "pass device='cpu' to run on the CPU")
        self.conf = conf or SrtConf()
        self.device = device
        self.metrics: Dict[str, Dict[str, Metric]] = {}

    def metric(self, exec_id: str, name: str, level: str = Metric.MODERATE,
               unit: str = "") -> Metric:
        return self.metrics.setdefault(exec_id, {}).setdefault(
            name, Metric(name, level, unit))

    def metric_totals(self) -> Dict[str, int]:
        """Each metric name summed over the query's operators."""
        totals: Dict[str, int] = {}
        for per_exec in self.metrics.values():
            for name, m in per_exec.items():
                totals[name] = totals.get(name, 0) + m.value
        return totals


class TpuExec:
    """Base physical operator: ``execute(ctx)`` yields ColumnarBatches;
    subclasses implement ``do_execute``. (The class name is the JAX
    package's; here the operator runs on the session's torch device.)"""

    _ids = itertools.count(1)

    def __init__(self, *children: "TpuExec"):
        self.children: List[TpuExec] = list(children)
        self.exec_id = f"{type(self).__name__}#{next(TpuExec._ids)}"

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        rows = ctx.metric(self.exec_id, "numOutputRows", Metric.ESSENTIAL)
        batches = ctx.metric(self.exec_id, "numOutputBatches")
        optime = ctx.metric(self.exec_id, "opTime", Metric.ESSENTIAL, "ns")
        it = iter(self.do_execute(ctx))
        while True:
            t0 = time.perf_counter_ns()
            batch = next(it, None)
            # inclusive of the children's pull time (host clock, no sync)
            optime.add(time.perf_counter_ns() - t0)
            if batch is None:
                return
            rows.add(batch.num_rows)
            batches.add(1)
            yield batch

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + "* " + self.node_description()
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children])

    def node_description(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.tree_string()
