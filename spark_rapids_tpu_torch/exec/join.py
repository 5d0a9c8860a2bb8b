"""Hash join execs: shuffled and broadcast hash joins with output-growth
retry, sub-partitioning of large build sides and a bloom pre-filter.

Counterpart of spark_rapids_tpu/exec/join.py at one partition, where
the exchanges the JAX planner places below a shuffled join (and the
broadcast exchange below a broadcast one) pass batches through
unchanged, so none is placed; both execs then join the whole probe
stream against the whole build side.

Join types (Catalyst names): ``inner``, ``left_outer`` (build right),
``right_outer`` (build left: the probe side is the preserved one),
``left_semi`` and ``left_anti`` (build right; probe columns only).
Full outer joins are planned as a union of a left outer join and a
null-extended anti join (plan/overrides.py).

- The build side is concatenated once. An empty one gives nothing for
  inner and semi joins, the probe rows for an anti join and the probe
  rows null-extended for an outer join.
- A build side above ``srt.sql.join.subPartitionRows`` is hash-split
  into sub-partitions and both sides are bucketed by the same key hash
  (seed 7), so each bucket pair joins on its own and every probe row
  lands in one bucket. A bucket still above the threshold (a hot key
  defeats hashing) is joined in row chunks only for an inner join; an
  outer or anti join runs it whole, since a probe row unmatched in one
  chunk may match in another.
- Each (probe batch, build) pair joins through ops/kernels.py
  (``inner_join``, ``left_join``, ``semi_anti_join``) at an output
  capacity of the probe's row count. The kernel reports the capacity
  it needed; when that overflows, the pair re-runs at the reported
  count's capacity, at most ``srt.sql.join.outputGrowthSteps`` times.
- Probe batches of at least ``srt.sql.join.bloomFilter.minProbeRows``
  rows are first filtered against a bloom filter of the build keys, for
  inner and semi joins only: an outer or anti join must keep the rows
  it would drop.
- Memory (memory/): each probe batch is held as a spillable and joined
  under ``with_retry`` with the halving split policy, as the JAX
  package's fused join does (every probe row's output depends on that
  row and the whole build side alone, so halves join on their own). The
  sub-partition path holds its sub-builds and probe buckets as
  spillables and brings each sub-build back under
  ``with_retry_no_split``.

Dynamic partition pruning, adaptive join demotion and the fused join
pipeline are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

from ..columnar.vector import ColumnarBatch, choose_capacity, null_column
from ..conf import (JOIN_BLOOM_BITS_PER_KEY, JOIN_BLOOM_ENABLED,
                    JOIN_BLOOM_MIN_PROBE_ROWS, JOIN_GROWTH_STEPS,
                    JOIN_SUB_PARTITION_ROWS)
from ..expr.core import Expression
from ..memory.retry import retry_each, with_retry_no_split
from ..memory.spill import SpillableBatch
from ..ops import bloom as B
from ..ops import kernels as K
from .base import ExecContext, Metric, Schema, TpuExec

INNER = "inner"
LEFT_OUTER = "left_outer"
RIGHT_OUTER = "right_outer"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"
#: the build side each join type takes (the probe side is preserved)
_BUILD_SIDES = {INNER: ("left", "right"), LEFT_OUTER: ("right",),
                RIGHT_OUTER: ("left",), LEFT_SEMI: ("right",),
                LEFT_ANTI: ("right",)}


class _HashJoinBase(TpuExec):
    """Build-side materialization and the per-probe-batch gather-map
    join with capacity retry."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = INNER, build_side: str = "right"):
        super().__init__(left, right)
        if join_type not in _BUILD_SIDES:
            raise NotImplementedError(
                f"join type {join_type!r} is not in this port yet")
        if build_side not in _BUILD_SIDES[join_type]:
            raise ValueError(f"a {join_type} join builds the "
                             f"{' or '.join(_BUILD_SIDES[join_type])} "
                             f"side, got {build_side!r}")
        if len(left_keys) != len(right_keys) or not left_keys:
            raise ValueError("an equi-join needs matching key lists")
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.build_side = build_side

    @property
    def output_schema(self) -> Schema:
        if self.join_type in (LEFT_SEMI, LEFT_ANTI):
            return self.children[0].output_schema
        return self.children[0].output_schema + \
            self.children[1].output_schema

    @property
    def _build_schema(self) -> Schema:
        return self.children[1 if self.build_side == "right" else 0] \
            .output_schema

    @property
    def _probe_key_exprs(self):
        return self.left_keys if self.build_side == "right" \
            else self.right_keys

    @property
    def _build_key_exprs(self):
        return self.right_keys if self.build_side == "right" \
            else self.left_keys

    def _probe_stream(self, ctx: ExecContext):
        return self.children[0 if self.build_side == "right" else 1] \
            .execute(ctx)

    def _build_stream(self, ctx: ExecContext):
        return self.children[1 if self.build_side == "right" else 0] \
            .execute(ctx)

    def _metric(self, ctx: ExecContext, name: str) -> Metric:
        return ctx.metric(self.exec_id, name, Metric.DEBUG)

    def _reorder_columns(self, out: ColumnarBatch) -> ColumnarBatch:
        """Kernel output is probe-then-build; the plan's is
        left-then-right."""
        if self.build_side == "right" or self.join_type in (LEFT_SEMI,
                                                            LEFT_ANTI):
            return out
        n_right = len(self.children[1].output_schema)
        return ColumnarBatch(out.columns[n_right:] + out.columns[:n_right],
                             out.names[n_right:] + out.names[:n_right],
                             out.num_rows, out.device)

    def _join_pair(self, ctx: ExecContext, probe: ColumnarBatch,
                   build: ColumnarBatch) -> ColumnarBatch:
        """One probe batch against one build batch, with capacity growth
        retry."""
        retries = self._metric(ctx, "joinOverflowRetries")
        pk = [e.eval(probe) for e in self._probe_key_exprs]
        bk = [e.eval(build) for e in self._build_key_exprs]
        max_steps = ctx.conf.get(JOIN_GROWTH_STEPS)
        # first guess: every probe row matches about one build row
        out_cap = choose_capacity(max(probe.num_rows, 16))
        for _ in range(max_steps + 1):
            if self.join_type == INNER:
                out, total = K.inner_join(probe, build, pk, bk, out_cap)
            elif self.join_type in (LEFT_SEMI, LEFT_ANTI):
                out, total = K.semi_anti_join(
                    probe, bk, pk, build.live_mask(),
                    anti=self.join_type == LEFT_ANTI,
                    scratch_capacity=out_cap)
            else:  # an outer join: the probe side is the preserved one
                out, total = K.left_join(probe, build, pk, bk, out_cap)
            if total <= out_cap:
                return self._reorder_columns(out)
            retries.add(1)
            out_cap = choose_capacity(total)
        raise RuntimeError(f"join expansion {total} exceeded capacity "
                           f"after {max_steps} growth steps")

    def _empty_build(self, probes) -> Iterator[ColumnarBatch]:
        """Probe batches against an empty build side: nothing for inner
        and semi joins, the probe rows for an anti join, the probe rows
        null-extended for an outer join."""
        if self.join_type in (INNER, LEFT_SEMI):
            return
        for probe in probes:
            if probe.num_rows == 0:
                continue
            if self.join_type == LEFT_ANTI:
                yield probe
                continue
            nulls = [null_column(t, probe.capacity, probe.device)
                     for _, t in self._build_schema]
            yield self._reorder_columns(ColumnarBatch(
                list(probe.columns) + nulls,
                probe.names + [n for n, _ in self._build_schema],
                probe.num_rows, probe.device))

    def _probe_pairs(self, ctx: ExecContext, probes, build: ColumnarBatch
                     ) -> Iterator[ColumnarBatch]:
        """Each probe batch against ``build``, under the per-batch retry
        block (a probe batch that does not fit is joined in halves)."""
        def pair(sb: SpillableBatch) -> ColumnarBatch:
            probe = sb.get()
            out = self._join_pair(ctx, probe, build)
            sb.close()
            return out
        yield from retry_each(ctx, self.exec_id, probes, pair)

    def _unspill(self, ctx: ExecContext, held: List[SpillableBatch],
                 close: bool = True) -> Iterator[ColumnarBatch]:
        counters = ctx.retry_counters(self.exec_id)
        for sb in held:
            batch = with_retry_no_split(sb.get, counters=counters)
            if close:
                sb.close()
            yield batch

    def _sub_partition_join(self, ctx: ExecContext, probe_stream,
                            build_holder: List[ColumnarBatch],
                            threshold: int) -> Iterator[ColumnarBatch]:
        """Bucket both sides by the same key hash into spillables, then
        join bucket pairs. ``build_holder`` hands over the concatenated
        build, so it is freed once it has been bucketed. The whole probe
        stream is bucketed first, so each sub-build comes back to the
        device once."""
        counters = ctx.retry_counters(self.exec_id)

        def retried(fn):
            return with_retry_no_split(fn, counters=counters)

        def bucket(batch: ColumnarBatch, ids, p: int):
            """Bucket ``p``'s rows, held as a spillable (None if none):
            one retry block, so an OOM spills the buckets made so far."""
            sub = K.bucket_compact(batch, ids, p)
            return None if sub is None else SpillableBatch(sub)
        build = build_holder.pop()
        parts = max(2, -(-build.num_rows // threshold))
        self._metric(ctx, "joinSubPartitions").add(parts)
        sub_builds: List = []
        probe_buckets: List[List[SpillableBatch]] = [[] for _ in range(parts)]
        try:
            ids = retried(lambda: K.bucket_ids(
                [e.eval(build) for e in self._build_key_exprs], parts))
            for p in range(parts):
                sub_builds.append(retried(lambda p=p: bucket(build, ids, p)))
            del build, ids
            for probe in probe_stream:
                if probe.num_rows == 0:
                    continue
                ids = retried(lambda b=probe: K.bucket_ids(
                    [e.eval(b) for e in self._probe_key_exprs], parts))
                for p in range(parts):
                    sb = retried(lambda p=p, b=probe: bucket(b, ids, p))
                    if sb is not None:
                        probe_buckets[p].append(sb)
                del probe, ids
            skew = self._metric(ctx, "joinSubPartitionSkew")
            for p in range(parts):
                if not probe_buckets[p]:
                    continue
                if sub_builds[p] is None:
                    yield from self._empty_build(
                        self._unspill(ctx, probe_buckets[p]))
                    continue
                build_p = with_retry_no_split(sub_builds[p].get,
                                              counters=counters)
                if build_p.num_rows > threshold:
                    skew.add(1)  # a hot key defeated the hashing
                if build_p.num_rows <= threshold or \
                        self.join_type != INNER:
                    # a hot bucket of any other join type runs whole: a
                    # probe row unmatched in one chunk may match in
                    # another
                    yield from self._probe_pairs(
                        ctx, self._unspill(ctx, probe_buckets[p]), build_p)
                else:
                    # a hot bucket of an inner join: row chunks of the
                    # build side join to a disjoint union of the matches
                    cap = choose_capacity(threshold)
                    for start in range(0, build_p.num_rows, threshold):
                        chunk = K.slice_batch(build_p, start, threshold, cap)
                        yield from self._probe_pairs(
                            ctx, self._unspill(ctx, probe_buckets[p],
                                               close=False), chunk)
                        del chunk
                del build_p
                for sb in probe_buckets[p]:
                    sb.close()
                probe_buckets[p] = []
                sub_builds[p].close()
                sub_builds[p] = None
        finally:
            for sb in sub_builds:
                if sb is not None:
                    sb.close()
            for bucket in probe_buckets:
                for sb in bucket:
                    sb.close()

    def _bloom_prefilter(self, ctx: ExecContext, probe_stream,
                         build: ColumnarBatch):
        """Drop probe rows whose keys cannot be in the build side before
        the gather-map join: sound only where a dropped probe row makes
        no output, an inner or a semi join."""
        if not ctx.conf.get(JOIN_BLOOM_ENABLED) or \
                self.join_type not in (INNER, LEFT_SEMI):
            return probe_stream
        min_rows = ctx.conf.get(JOIN_BLOOM_MIN_PROBE_ROWS)
        num_bits = B.choose_num_bits(build.num_rows,
                                     ctx.conf.get(JOIN_BLOOM_BITS_PER_KEY))
        bits = B.build_bloom([e.eval(build) for e in self._build_key_exprs],
                             build.live_mask(), num_bits)
        dropped = self._metric(ctx, "bloomFilteredRows")

        def filtered():
            for probe in probe_stream:
                if probe.num_rows < min_rows:
                    yield probe
                    continue
                keep = B.might_contain(
                    bits, [e.eval(probe) for e in self._probe_key_exprs])
                out = K.compact(probe, keep)
                dropped.add(probe.num_rows - out.num_rows)
                yield out
        return filtered()

    def _join_partition(self, ctx: ExecContext, probe_stream,
                        build_stream) -> Iterator[ColumnarBatch]:
        build = K.concat_stream(build_stream)
        if build is None:
            yield from self._empty_build(probe_stream)
            return
        probe_stream = self._bloom_prefilter(ctx, probe_stream, build)
        threshold = ctx.conf.get(JOIN_SUB_PARTITION_ROWS)
        if build.num_rows > threshold:
            holder = [build]
            del build
            yield from self._sub_partition_join(ctx, probe_stream, holder,
                                                threshold)
            return
        yield from self._probe_pairs(ctx, probe_stream, build)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # the build side is drawn first, as the JAX package does
        build_stream = self._build_stream(ctx)
        yield from self._join_partition(ctx, self._probe_stream(ctx),
                                        build_stream)


class ShuffledHashJoinExec(_HashJoinBase):
    """Hash join of two co-partitioned sides (one partition here)."""

    def node_description(self) -> str:
        return (f"ShuffledHashJoin[{self.join_type}, "
                f"build={self.build_side}]")


class BroadcastHashJoinExec(_HashJoinBase):
    """Hash join with a broadcast (small) build side."""

    def node_description(self) -> str:
        return (f"BroadcastHashJoin[{self.join_type}, "
                f"build={self.build_side}]")
