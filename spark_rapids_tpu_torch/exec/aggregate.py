"""Hash aggregate exec.

Counterpart of spark_rapids_tpu/exec/aggregate.py with its staged
structure:

  PARTIAL  : per input batch, raw rows -> packed per-group state batch
  FINAL    : concat the partials, merge states, finalize

At one partition the exchange the JAX planner places between PARTIAL
and FINAL passes every partial through unchanged, so it is not placed.
Two kernel lanes: a global aggregate (optionally absorbing its child
FilterExec's predicate) runs as one ``tile_reduce`` pass per batch
(exec/pallas_agg.py); a grouped PARTIAL update over sum-decomposable
aggregates takes ``tile_group_reduce`` for batches of <= 1024 groups.
Neither lane has a fallback: on CUDA the kernel runs or the query fails.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (ColumnVector, ColumnarBatch, StringColumn,
                               choose_capacity, live_mask, null_column,
                               with_validity)
from ..conf import PALLAS_ENABLED, PALLAS_GROUPED_ENABLED
from ..expr.aggregates import AggregateFunction
from ..expr.core import Expression, make_result, output_name
from ..ops import kernels as K
from . import pallas_agg
from .base import ExecContext, Metric, Schema, TpuExec
from .basic import FilterExec

PARTIAL = "partial"
FINAL = "final"


def _state_col_name(agg_index: int, state_name: str) -> str:
    return f"__agg{agg_index}__{state_name}"


class HashAggregateExec(TpuExec):
    """groupBy(keys).agg(fns) over the child stream.

    ``agg_exprs``: [(AggregateFunction, output_name)]; aggregate inputs
    are evaluated against the pre-partial input schema, which a FINAL
    node (whose child yields packed partials) receives as
    ``input_schema``.
    """

    def __init__(self, child: TpuExec, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Tuple[AggregateFunction, str]],
                 mode: str, input_schema: Optional[Schema] = None):
        super().__init__(child)
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        in_schema = input_schema if input_schema is not None \
            else child.output_schema
        self.input_schema = list(in_schema)
        self._key_names = [output_name(e, i)
                           for i, e in enumerate(self.group_exprs)]
        key_schema = [(n, e.data_type(in_schema))
                      for n, e in zip(self._key_names, self.group_exprs)]
        self._result_schema = key_schema + [
            (name, fn.data_type(in_schema)) for fn, name in self.agg_exprs]
        self._state_schemas = [fn.state_schema(in_schema)
                               for fn, _ in self.agg_exprs]
        self._packed_schema = list(key_schema)
        for i, sschema in enumerate(self._state_schemas):
            for sname, stype in sschema:
                self._packed_schema.append((_state_col_name(i, sname), stype))
        self._pallas_gate = pallas_agg.pallas_eligible(self)
        self._pallas_grouped_gate = pallas_agg.grouped_eligible(self)
        self._pallas_plans = {}

    @property
    def output_schema(self) -> Schema:
        return self._packed_schema if self.mode == PARTIAL \
            else self._result_schema

    # --- phase 1: partial aggregation of one raw batch ---
    def _eval_update_inputs(self, batch: ColumnarBatch):
        key_cols = [e.eval(batch) for e in self.group_exprs]
        agg_in = [fn.children[0].eval(batch) if fn.children else None
                  for fn, _ in self.agg_exprs]
        return key_cols, agg_in

    def _update(self, batch: ColumnarBatch, stats: dict) -> ColumnarBatch:
        key_cols, agg_in = self._eval_update_inputs(batch)
        key_batch, states = K.group_aggregate(
            batch, key_cols, agg_in, [fn for fn, _ in self.agg_exprs],
            stats=stats)
        return self._pack(key_batch, states)

    def _update_pallas(self, batch: ColumnarBatch, stats: dict
                       ) -> Tuple[ColumnarBatch, bool]:
        """_update through the grouped kernel lane; returns (packed,
        whether the kernel ran)."""
        key_cols, agg_in = self._eval_update_inputs(batch)
        key_batch, states, used = K.group_aggregate_pallas(
            batch, key_cols, agg_in, [fn for fn, _ in self.agg_exprs],
            stats=stats)
        return self._pack(key_batch, states), used

    def _pack(self, key_batch: ColumnarBatch,
              states: List[dict]) -> ColumnarBatch:
        """Flatten state dicts into columns so partials flow as
        batches."""
        cap, num_groups = key_batch.capacity, key_batch.num_rows
        lm = live_mask(cap, num_groups, key_batch.device)
        cols: List = list(key_batch.columns)
        names: List[str] = list(self._key_names)
        for i, sschema in enumerate(self._state_schemas):
            for sname, stype in sschema:
                arr = states[i][sname]
                if isinstance(arr, StringColumn):  # a string MIN / MAX
                    cols.append(with_validity(arr, arr.validity & lm))
                elif arr.dtype == torch.bool:
                    cols.append(ColumnVector(arr & lm, lm, stype))
                else:
                    cols.append(ColumnVector(torch.where(
                        lm, arr, torch.zeros((), dtype=arr.dtype,
                                             device=arr.device)), lm, stype))
                names.append(_state_col_name(i, sname))
        return ColumnarBatch(cols, names, num_groups, key_batch.device,
                             capacity=cap)

    def _unpack(self, batch: ColumnarBatch):
        key_cols = [batch.column(n) for n in self._key_names]

        def state(c):
            return c if isinstance(c, StringColumn) else c.data
        states = [{sname: state(batch.column(_state_col_name(i, sname)))
                   for sname, _ in sschema}
                  for i, sschema in enumerate(self._state_schemas)]
        return key_cols, states

    # --- phase 2: merge partials + finalize ---
    def _merge_finalize(self, batch: ColumnarBatch,
                        stats: dict) -> ColumnarBatch:
        key_cols, states = self._unpack(batch)
        key_batch, merged, num_groups = K.group_merge(
            batch, key_cols, states, [fn for fn, _ in self.agg_exprs],
            stats=stats)
        if not self.group_exprs:
            # a global aggregate has exactly one output row, even on
            # empty input (count() = 0, sum() = null)
            num_groups = max(num_groups, 1)
        cap = key_batch.capacity
        lm = live_mask(cap, num_groups, batch.device)
        out_cols: List = list(key_batch.columns)
        for i, (fn, _name) in enumerate(self.agg_exprs):
            data, ok = fn.finalize(merged[i])
            if isinstance(data, StringColumn):
                out_cols.append(with_validity(data, data.validity & ok & lm))
                continue
            out_cols.append(make_result(
                data, ok & lm,
                self._result_schema[len(self._key_names) + i][1]))
        return ColumnarBatch(out_cols, [n for n, _ in self._result_schema],
                             num_groups, batch.device, capacity=cap)

    def _grouped_lane_on(self, ctx: ExecContext) -> bool:
        return self._pallas_grouped_gate and ctx.conf.get(PALLAS_ENABLED) \
            and ctx.conf.get(PALLAS_GROUPED_ENABLED)

    def _record_claims(self, ctx: ExecContext, stats: dict) -> None:
        """Hash-claim grouping outcomes (claimResolved: the claim
        prelude grouped the batch; claimFallbacks: it met a collision
        or an unclaimed row and the sort path ran)."""
        for name, n in stats.items():
            ctx.metric(self.exec_id, name, Metric.DEBUG).add(n)
        stats.clear()

    def _partial_stream(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        grouped = self._grouped_lane_on(ctx)
        pb = ctx.metric(self.exec_id, "pallasBatches", Metric.DEBUG)
        stats: dict = {}
        for batch in self.children[0].execute(ctx):
            if batch.num_rows == 0:
                continue
            if grouped:
                partial, used = self._update_pallas(batch, stats)
                pb.add(int(used))
            else:
                partial = self._update(batch, stats)
            self._record_claims(ctx, stats)
            yield partial

    def _merge_partials(self, ctx: ExecContext,
                        partials) -> Iterator[ColumnarBatch]:
        held = [p for p in partials if p.num_rows > 0]
        if not held:
            if not self.group_exprs:
                yield self._empty_global_result(ctx.device)
            return
        cap = choose_capacity(sum(p.num_rows for p in held))
        merged_in = held[0] if len(held) == 1 else \
            K.concat_batches(held, cap)
        stats: dict = {}
        out = self._merge_finalize(merged_in, stats)
        self._record_claims(ctx, stats)
        yield out

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        if self.mode == FINAL:
            yield from self._merge_partials(ctx,
                                            self.children[0].execute(ctx))
            return
        fused = self._pallas_stream_or_none(ctx)
        yield from (fused if fused is not None
                    else self._partial_stream(ctx))

    # --- fused global lane (tile_reduce) ---
    def _pallas_stream_or_none(self, ctx: ExecContext):
        """The fused filter+aggregate stream, or None when the static
        gate or the conf keeps the stock path."""
        if not self._pallas_gate or not ctx.conf.get(PALLAS_ENABLED):
            return None
        source, pred = self.children[0], None
        if isinstance(source, FilterExec) and \
                pallas_agg.pred_safe(source.condition, self.input_schema):
            source, pred = source.children[0], source.condition
        plan = self._pallas_plans.get(id(pred))
        if plan is None:
            plan = self._pallas_plans[id(pred)] = \
                pallas_agg.build_plan(self, pred)
        fn = plan.batch_fn()

        def stream():
            pb = ctx.metric(self.exec_id, "pallasBatches", Metric.DEBUG)
            totals = plan.init_totals()
            device = None
            for batch in source.execute(ctx):
                if batch.num_rows == 0:
                    continue
                device = batch.device
                plan.combine(totals, fn(batch))
                pb.add(1)
            if device is None:
                return  # FINAL emits the empty-input row
            key_batch = ColumnarBatch([], [], 1, device, capacity=8)
            yield self._pack(key_batch, plan.states(totals, device))
        return stream()

    def _empty_global_result(self, device) -> ColumnarBatch:
        cap = 8
        cols = []
        for i, (fn, _name) in enumerate(self.agg_exprs):
            out_t = fn.data_type(self.input_schema)
            if out_t == dt.STRING:  # MIN / MAX over no row is null
                cols.append(null_column(out_t, cap, device))
                continue
            zero = {sname: torch.zeros(cap, dtype=stype.physical,
                                       device=device)
                    for sname, stype in self._state_schemas[i]}
            data, ok = fn.finalize(zero)
            cols.append(make_result(data, ok & live_mask(cap, 1, device),
                                    out_t))
        return ColumnarBatch(cols, [n for _, n in self.agg_exprs], 1, device)

    def node_description(self) -> str:
        aggs = ", ".join(f"{fn.name} as {n}" for fn, n in self.agg_exprs)
        keys = ", ".join(self._key_names)
        return f"HashAggregate[{self.mode}, keys=({keys}), aggs=({aggs})]"
