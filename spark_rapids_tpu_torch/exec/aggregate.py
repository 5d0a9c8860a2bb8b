"""Hash aggregate exec.

Counterpart of spark_rapids_tpu/exec/aggregate.py with its staged
structure:

  PARTIAL  : per input batch, raw rows -> packed per-group state batch
  FINAL    : concat the partials, merge states, finalize

At one partition the exchange the JAX planner places between PARTIAL
and FINAL passes every partial through unchanged, so it is not placed.
Two kernel lanes: a global aggregate (optionally absorbing the chain of
FilterExecs below it) runs as one ``tile_reduce`` pass per batch
(exec/pallas_agg.py); a grouped PARTIAL update over sum-decomposable
aggregates takes ``tile_group_reduce`` for batches of <= 1024 groups.
Neither lane has a fallback: on CUDA the kernel runs or the query fails.

Memory (memory/): each PARTIAL input batch is held as a spillable under
``with_retry`` with the halving split policy, as the JAX package's
fused stage holds the batches of a pipeline ending in a partial
aggregate, so a split batch's halves are aggregated on their own. FINAL
holds the partials as spillables and merges them under
``with_retry_no_split``; above ``srt.sql.agg.mergePartitionRows``
partial rows it re-partitions them by group-key hash and merges the
disjoint buckets one by one (GpuAggregateExec.scala:711).
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import decimal128 as d128
from ..columnar import dtypes as dt
from ..columnar.nested import empty_list_column
from ..columnar.vector import (ColumnVector, ColumnarBatch,
                               choose_capacity, live_mask, null_column,
                               with_validity)
from ..conf import (AGG_MERGE_PARTITION_ROWS, PALLAS_ENABLED,
                    PALLAS_GROUPED_ENABLED)
from ..expr import predicates as Pr
from ..expr.aggregates import AggregateFunction
from ..expr.core import Expression, make_result, output_name
from ..memory.retry import retry_each, with_retry_no_split
from ..memory.spill import SpillableBatch
from ..ops import kernels as K
from . import pallas_agg
from .base import ExecContext, Metric, Schema, TpuExec
from .basic import FilterExec

PARTIAL = "partial"
FINAL = "final"


def _state_col_name(agg_index: int, state_name: str) -> str:
    return f"__agg{agg_index}__{state_name}"


def make_agg_result(data, validity, out_t: dt.DType):
    """A finalized aggregate as its output column: a string or list
    column as it is, a wide decimal's (hi, lo) pair through the
    precision check of its type (the JAX package's make_agg_result), a
    plain lane through make_result."""
    if isinstance(data, tuple):
        hi, lo = data
        validity = validity & d128.d128_fits_precision(hi, lo,
                                                       out_t.precision)
        return d128.build_decimal_column(hi, lo, validity, out_t)
    if not isinstance(data, torch.Tensor):
        return with_validity(data, data.validity & validity)
    return make_result(data, validity, out_t)


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
                if not isinstance(arr, torch.Tensor):
                    # a string MIN / MAX or a collect's list
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
            return c.data if isinstance(c, ColumnVector) else c
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
            out_cols.append(make_agg_result(
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

        def update(sb: SpillableBatch) -> ColumnarBatch:
            batch = sb.get()
            stats: dict = {}
            with ctx.semaphore:
                if grouped:
                    partial, used = self._update_pallas(batch, stats)
                    pb.add(int(used))
                else:
                    partial = self._update(batch, stats)
            sb.close()
            self._record_claims(ctx, stats)
            return partial
        yield from retry_each(ctx, self.exec_id,
                              self.children[0].execute(ctx), update)

    def _merge_batches(self, ctx: ExecContext, held, cap: int
                       ) -> ColumnarBatch:
        """Concat + merge + finalize of held partials, under
        ``with_retry_no_split`` (a pure function of the spillables)."""
        def merge_all():
            batches = [sb.get() for sb in held]
            stats: dict = {}
            with ctx.semaphore:
                merged_in = batches[0] if len(batches) == 1 else \
                    K.concat_batches(batches, cap)
                del batches
                out = self._merge_finalize(merged_in, stats)
            self._record_claims(ctx, stats)
            return out
        return with_retry_no_split(
            merge_all, counters=ctx.retry_counters(self.exec_id))

    def _merge_partials(self, ctx: ExecContext,
                        partials) -> Iterator[ColumnarBatch]:
        """Hold the partials as spillables and merge them: one merge,
        or the re-partitioned merge above
        ``srt.sql.agg.mergePartitionRows`` rows."""
        counters = ctx.retry_counters(self.exec_id)
        held: List[SpillableBatch] = []
        total = 0
        try:
            for p in partials:
                if p.num_rows == 0:
                    continue
                total += p.num_rows
                held.append(with_retry_no_split(
                    lambda b=p: SpillableBatch(b), counters=counters))
                del p
            if not held:
                if not self.group_exprs:
                    yield self._empty_global_result(ctx.device)
                return
            threshold = ctx.conf.get(AGG_MERGE_PARTITION_ROWS)
            if total > threshold and self.group_exprs:
                yield from self._repartition_merge(ctx, held, total,
                                                   threshold)
                return
            out = self._merge_batches(ctx, held, choose_capacity(total))
            for sb in held:
                sb.close()
            yield out
        finally:
            for sb in held:
                sb.close()

    def _repartition_merge(self, ctx: ExecContext, held, total: int,
                           threshold: int) -> Iterator[ColumnarBatch]:
        """Bucket every held partial by group-key hash (the seed-7 chain
        the sub-partition join uses) into spillable buckets, then merge
        each bucket on its own: equal keys share a bucket, so the
        buckets' results are disjoint."""
        counters = ctx.retry_counters(self.exec_id)
        parts = max(2, -(-total // max(threshold, 1)))
        ctx.metric(self.exec_id, "aggMergePartitions",
                   Metric.DEBUG).add(parts)
        buckets: List[List[SpillableBatch]] = [[] for _ in range(parts)]
        bucket_rows = [0] * parts
        try:
            for sb in held:
                batch = with_retry_no_split(sb.get, counters=counters)
                with ctx.semaphore:
                    ids = K.bucket_ids([batch.column(n)
                                        for n in self._key_names], parts)
                for p in range(parts):
                    with ctx.semaphore:
                        sub = K.bucket_compact(batch, ids, p)
                    if sub is None:
                        continue
                    bucket_rows[p] += sub.num_rows
                    buckets[p].append(with_retry_no_split(
                        lambda b=sub: SpillableBatch(b), counters=counters))
                del batch, ids, sub
                sb.close()
            for p in range(parts):
                if not buckets[p]:
                    continue
                out = self._merge_batches(ctx, buckets[p],
                                          choose_capacity(bucket_rows[p]))
                for b in buckets[p]:
                    b.close()
                buckets[p] = []
                yield out
        finally:
            for bs in buckets:
                for b in bs:
                    b.close()

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
        # a WHERE plans as one FilterExec per conjunct: the lane takes
        # the chain of them it can lower, top down, as one conjunction
        # (the safe nodes cannot fail, so evaluating a condition on rows
        # a lower one drops changes no result)
        source, preds = self.children[0], []
        while isinstance(source, FilterExec) and \
                pallas_agg.pred_safe(source.condition, self.input_schema):
            preds.append(source.condition)
            source = source.children[0]
        key = tuple(id(p) for p in preds)
        plan = self._pallas_plans.get(key)
        if plan is None:
            plan = self._pallas_plans[key] = pallas_agg.build_plan(
                self, functools.reduce(Pr.And, preds) if preds else None)
        fn = plan.batch_fn()

        def stream():
            pb = ctx.metric(self.exec_id, "pallasBatches", Metric.DEBUG)
            totals = plan.init_totals()

            def reduce(sb: SpillableBatch):
                batch = sb.get()
                with ctx.semaphore:
                    part = fn(batch)
                sb.close()
                return part
            seen = False
            for part in retry_each(ctx, self.exec_id, source.execute(ctx),
                                   reduce):
                plan.combine(totals, part)
                pb.add(1)
                seen = True
            if not seen:
                return  # FINAL emits the empty-input row
            key_batch = ColumnarBatch([], [], 1, ctx.device, capacity=8)
            yield self._pack(key_batch, plan.states(totals, ctx.device))
        return stream()

    def _empty_global_result(self, device) -> ColumnarBatch:
        cap = 8
        cols = []
        for i, (fn, _name) in enumerate(self.agg_exprs):
            out_t = fn.data_type(self.input_schema)
            if out_t == dt.STRING:  # MIN / MAX over no row is null
                cols.append(null_column(out_t, cap, device))
                continue
            zero = {sname: empty_list_column(stype.element_type, cap,
                                             device)
                    if isinstance(stype, dt.ArrayType) else
                    null_column(stype, cap, device)
                    if dt.is_wide_decimal(stype) else
                    torch.zeros(cap, dtype=stype.physical, device=device)
                    for sname, stype in self._state_schemas[i]}
            data, ok = fn.finalize(zero)
            cols.append(make_agg_result(data, ok & live_mask(cap, 1, device),
                                        out_t))
        return ColumnarBatch(cols, [n for _, n in self.agg_exprs], 1, device)

    def node_description(self) -> str:
        aggs = ", ".join(f"{fn.name} as {n}" for fn, n in self.agg_exprs)
        keys = ", ".join(self._key_names)
        return f"HashAggregate[{self.mode}, keys=({keys}), aggs=({aggs})]"
