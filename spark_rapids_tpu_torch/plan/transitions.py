"""Host <-> device transition nodes.

Counterpart of spark_rapids_tpu/plan/transitions.py (the role of
GpuTransitionOverrides and the row <-> columnar execs): the planner
emits mixed trees where device subtrees and CPU-engine subtrees meet;
these nodes are the seams. Both sides are columnar, so a transition is
a buffer copy plus the lane conversion of host_table.py (``to_engine``,
``from_engine``), not a row pivot.

Each node records metrics in the query's ExecContext, as the
reference's row <-> columnar execs do:

- ``DeviceToHostBridge`` and ``HostToDeviceExec``: ``transitionRows``,
  ``transitionBytes`` (the host lanes' bytes: fixed-width lanes and
  masks, string offsets and bytes, 16 a wide decimal, 8 a nested
  element) and ``transitionTimeNs`` (host clock: the copy and the lane
  conversion, after the device's queued work is finished);
- ``CpuPhysical``: ``cpuTimeNs``, the host time of its own node in the
  CPU engine (children excluded), and ``numOutputRows``.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator, List

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnarBatch, HostStrings
from ..conf import BATCH_SIZE_ROWS
from ..exec.base import ExecContext, Metric, Schema, TpuExec
from .cpu_exec import apply_cpu_node
from .host_table import (HostTable, batch_to_table, concat_tables,
                         empty_like, from_engine, table_to_batch, to_engine)
from .logical import LogicalPlan

_ids = itertools.count(1)


def host_bytes(table: HostTable) -> int:
    """Bytes of a host table's lanes in the device path's layout."""
    total = 0
    for c in table.columns:
        total += c.mask.nbytes
        v = c.values
        if isinstance(v, HostStrings):
            total += v.offsets.nbytes + v.chars.nbytes
        elif dt.is_wide_decimal(c.dtype):
            total += 16 * len(v)
        elif c.dtype.is_nested:
            total += 8 * sum(len(x) for x, ok in zip(v, c.mask)
                             if ok and hasattr(x, "__len__"))
        else:
            total += np.asarray(v).nbytes
    return total


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seam_metrics(ctx: ExecContext, exec_id: str):
    return (ctx.metric(exec_id, "transitionRows", Metric.ESSENTIAL),
            ctx.metric(exec_id, "transitionBytes", Metric.ESSENTIAL),
            ctx.metric(exec_id, "transitionTimeNs", Metric.ESSENTIAL,
                       "ns"))


class CpuPhysical:
    """A logical node run by the CPU engine, over children that are
    CpuPhysical nodes or DeviceToHostBridges."""

    def __init__(self, plan: LogicalPlan, children: List):
        self.plan = plan
        self.children = children
        self.exec_id = f"Cpu{type(plan).__name__}#{next(_ids)}"

    @property
    def output_schema(self) -> Schema:
        return self.plan.schema

    def evaluate(self, ctx: ExecContext) -> HostTable:
        tables = [c.evaluate(ctx) for c in self.children]
        t0 = time.perf_counter_ns()
        out = apply_cpu_node(self.plan, tables, ctx.conf)
        ctx.metric(self.exec_id, "cpuTimeNs", Metric.ESSENTIAL, "ns").add(
            time.perf_counter_ns() - t0)
        ctx.metric(self.exec_id, "numOutputRows", Metric.ESSENTIAL).add(
            out.num_rows)
        return out

    def node_description(self) -> str:
        return "Cpu" + self.plan.node_description()

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + "! " + self.node_description()
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children])


class DeviceToHostBridge:
    """Drains a device subtree to one host table in the CPU engine's
    layout (GpuColumnarToRowExec's role)."""

    def __init__(self, tpu_exec: TpuExec):
        self.tpu = tpu_exec
        self.children = [tpu_exec]
        self.exec_id = f"DeviceToHost#{next(_ids)}"

    @property
    def output_schema(self) -> Schema:
        return self.tpu.output_schema

    def evaluate(self, ctx: ExecContext) -> HostTable:
        rows, nbytes, ns = _seam_metrics(ctx, self.exec_id)
        tables = []
        for b in self.tpu.execute(ctx):
            if not b.num_rows:
                continue
            _sync(ctx.device)
            t0 = time.perf_counter_ns()
            host = batch_to_table(b)
            nbytes.add(host_bytes(host))
            tables.append(to_engine(host))
            ns.add(time.perf_counter_ns() - t0)
            rows.add(host.num_rows)
        if not tables:
            return empty_like(self.tpu.output_schema)
        return concat_tables(tables)

    def node_description(self) -> str:
        return "DeviceToHost"

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + "* DeviceToHost"
        return "\n".join([line, self.tpu.tree_string(indent + 1)])


class HostToDeviceExec(TpuExec):
    """Feeds a CPU subtree's result to the device as batches of at most
    ``srt.sql.batchSizeRows`` rows on the query's device
    (GpuRowToColumnarExec's role)."""

    def __init__(self, cpu_child):
        super().__init__()
        self.cpu_child = cpu_child

    @property
    def output_schema(self) -> Schema:
        return self.cpu_child.output_schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        table = self.cpu_child.evaluate(ctx)
        rows, nbytes, ns = _seam_metrics(ctx, self.exec_id)
        per = ctx.conf.get(BATCH_SIZE_ROWS)
        n = table.num_rows
        for start in range(0, max(n, 1), per):
            t0 = time.perf_counter_ns()
            chunk = from_engine(table.slice(start, start + per))
            batch = table_to_batch(chunk, device=ctx.device)
            _sync(ctx.device)
            ns.add(time.perf_counter_ns() - t0)
            rows.add(chunk.num_rows)
            nbytes.add(host_bytes(chunk))
            yield batch

    def node_description(self) -> str:
        return "HostToDevice"

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + "* HostToDevice"
        return "\n".join([line, self.cpu_child.tree_string(indent + 1)])
