"""Exec base: the physical operator protocol, its metrics, and the
device semaphore.

Counterpart of spark_rapids_tpu/exec/base.py, without the profiler
spans and fault-injection hooks (not ported yet). ``execute`` reads the
ANSI guards of each batch an operator makes with one host sync.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from ..columnar.vector import ColumnarBatch
from ..conf import CONCURRENT_TASKS, SrtConf
from ..expr.ansi import deferred
from ..memory.budget import task_context
from ..memory.spill import spill_catalog

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


class TpuSemaphore:
    """Limits the host threads that submit device work at once
    (GpuSemaphore.scala); re-entrant per thread. Time spent blocked goes
    to the task's ``semaphore_wait_ns``."""

    def __init__(self, permits: int):
        self._sem = threading.Semaphore(permits)
        self.permits = permits
        self._holders: Dict[int, int] = {}
        self._lock = threading.Lock()

    def acquire_if_necessary(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            if self._holders.get(tid, 0) > 0:
                self._holders[tid] += 1
                return
        # uncontended fast path: only actual blocking counts as wait
        if not self._sem.acquire(blocking=False):
            t0 = time.perf_counter_ns()
            self._sem.acquire()
            task_context().semaphore_wait_ns += time.perf_counter_ns() - t0
        with self._lock:
            self._holders[tid] = 1

    def release_if_held(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            n = self._holders.get(tid, 0)
            if n == 0:
                return
            if n > 1:
                self._holders[tid] = n - 1
                return
            del self._holders[tid]
        self._sem.release()

    def __enter__(self):
        self.acquire_if_necessary()
        return self

    def __exit__(self, *exc):
        self.release_if_held()
        return False


_GLOBAL_SEM: Optional[TpuSemaphore] = None
_SEM_LOCK = threading.Lock()


def device_semaphore(conf: Optional[SrtConf] = None) -> TpuSemaphore:
    """The process-wide device semaphore, sized from
    ``srt.sql.concurrentTpuTasks`` at first use."""
    global _GLOBAL_SEM
    with _SEM_LOCK:
        if _GLOBAL_SEM is None:
            _GLOBAL_SEM = TpuSemaphore((conf or SrtConf()).get(
                CONCURRENT_TASKS))
        return _GLOBAL_SEM


class ExecContext:
    """Per-query execution context: conf, the session's device, the
    metrics sink, the device semaphore and the query's memory counters.
    The device is ``cuda`` unless the caller asks for the CPU, as for
    TpuSession; a context asked for CUDA where there is none raises."""

    def __init__(self, conf: Optional[SrtConf] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExecContext: CUDA is not available here; "
                               "pass device='cpu' to run on the CPU")
        self.conf = conf or SrtConf()
        self.device = device
        self.metrics: Dict[str, Dict[str, Metric]] = {}
        self.semaphore = device_semaphore(self.conf)
        #: the task's memory counters at the query's end (the session
        #: fills them in)
        self.memory: Dict[str, int] = {}
        # the process-wide spill catalog and budget, sized on first use
        # from this context's conf and device
        spill_catalog(self.conf, device)

    def retry_counters(self, exec_id: str) -> Dict[str, Metric]:
        """The operator's retry and split metrics, as with_retry takes
        them."""
        return {n: self.metric(exec_id, n, Metric.DEBUG)
                for n in ("retryCount", "splitAndRetryCount")}

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
            # the ANSI guards this batch raised are read with one host
            # sync when it is done (expr/ansi.py)
            with deferred():
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
