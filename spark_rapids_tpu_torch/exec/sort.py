"""Sort exec: in-core full sort, the out-of-core k-way chunk merge, and
TopN.

Counterpart of spark_rapids_tpu/exec/sort.py at one partition. The
child's batches are held as spillable runs. When their total rows fit
``srt.sql.sort.oocRowBudget`` they are concatenated and sorted with one
stable multi-key sort. Bigger inputs take the out-of-core merge
(GpuSortExec.scala:242): each run is sorted and split into spillable
C-row chunks whose head rows stay on the device; a host loop loads the
chunks in the order of their heads, one chunk or as many as fit a
quarter of the budget's rows at a step, sorts them, merges them into a
bounded carry in linear time and emits every row that no unloaded row
can precede (rows ordering at or before the smallest pending head).
Device residency stays O(budget): the step's chunks and the carry,
with the runs in the spill tiers when the budget or the card's
allocator asks for room. Every step over held spillables runs under
``with_retry_no_split``.

With ``batch_rows`` the sorted rows leave in batches of that many rows
(the last one shorter), so that a consumer that streams with carried
state sees them batch by batch. TopNExec fuses ORDER BY + LIMIT.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnarBatch, ColumnVector, choose_capacity
from ..conf import SORT_OOC_ROWS
from ..expr.core import Expression
from ..memory.retry import with_retry_no_split
from ..memory.spill import SpillableBatch, SpillPriority
from ..ops import kernels as K
from .base import ExecContext, Metric, Schema, TpuExec

#: the smallest chunk the out-of-core merge splits runs into
_MIN_CHUNK_ROWS = 256
#: the merge's run-index column
_RUN = "__run"
#: the out-of-core merge loads chunks of at least this share of the row
#: budget at a step: the steps' fixed cost (launches, host syncs) then
#: falls with the number of runs, while the carry stays within half
#: the budget and a step's rows within the budget
_STEP_SHARE = 4


class SortOrder:
    """(expr, ascending, nulls_first)."""

    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = ascending if nulls_first is None else nulls_first


def _rebatch(stream, per: int) -> Iterator[ColumnarBatch]:
    """The stream's rows, in order, in batches of ``per`` rows (the last
    one shorter); a batch of at most ``per`` rows with nothing before it
    passes through as it is."""
    cap = choose_capacity(per)
    rest: Optional[ColumnarBatch] = None
    for b in stream:
        if rest is not None:
            b = K.concat_batches([rest, b], choose_capacity(
                rest.num_rows + b.num_rows))
            rest = None
        start = 0
        while b.num_rows - start > per:
            yield K.slice_batch(b, start, per, cap)
            start += per
        rest = b if start == 0 else K.slice_batch(b, start, per, cap)
    if rest is not None:
        yield rest


class SortExec(TpuExec):
    """Global sort: in core under ``srt.sql.sort.oocRowBudget`` rows,
    else the out-of-core k-way chunk merge."""

    def __init__(self, child: TpuExec, order: Sequence[SortOrder],
                 batch_rows: Optional[int] = None):
        super().__init__(child)
        self.order = list(order)
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def _keys(self, batch: ColumnarBatch):
        return [o.expr.eval(batch) for o in self.order]

    def _sort_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        return K.sort_batch(batch, self._keys(batch),
                            [o.ascending for o in self.order],
                            [o.nulls_first for o in self.order])

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        out = self._sort_partition(ctx, self.children[0].execute(ctx))
        if self.batch_rows is None:
            yield from out
        else:
            yield from _rebatch(out, self.batch_rows)

    def _sort_partition(self, ctx: ExecContext,
                        stream) -> Iterator[ColumnarBatch]:
        """Hold the input as spillable runs and sort it: one concat and
        sort when it fits the in-core budget, the out-of-core chunk
        merge when it does not."""
        counters = ctx.retry_counters(self.exec_id)
        runs: List[SpillableBatch] = []
        total = 0
        max_run = 0
        try:
            for batch in stream:
                if batch.num_rows == 0:
                    continue
                total += batch.num_rows
                max_run = max(max_run, batch.capacity)
                runs.append(with_retry_no_split(
                    lambda b=batch: SpillableBatch(
                        b, SpillPriority.ACTIVE_ON_DECK), counters=counters))
                del batch
            if not runs:
                return
            budget = max(ctx.conf.get(SORT_OOC_ROWS), max_run)
            if total > budget:
                yield from self._ooc_merge(ctx, runs, budget)
                return
            cap = choose_capacity(total)

            def sort_all():
                batches = [sb.get() for sb in runs]
                with ctx.semaphore:
                    merged = batches[0] if len(batches) == 1 else \
                        K.concat_batches(batches, cap)
                    del batches
                    return self._sort_one(merged)
            out = with_retry_no_split(sort_all, counters=counters)
            for sb in runs:
                sb.close()
            yield out
        finally:
            for sb in runs:
                sb.close()

    # --- out-of-core merge ------------------------------------------------

    def _ooc_merge(self, ctx: ExecContext, runs: List[SpillableBatch],
                   budget: int) -> Iterator[ColumnarBatch]:
        """Bounded-memory k-way merge of spilled sorted runs.

        Each run is sorted and split into spilled C-row chunks with
        C = budget // (2*k); every chunk's head row is kept on the
        device. When k is too large for the bound (C would hit its
        floor), consecutive groups of runs merge into longer spilled runs
        first, so the final pass keeps carry <= k*C <= budget/2."""
        counters = ctx.retry_counters(self.exec_id)
        k = len(runs)
        max_k = max(2, budget // (2 * _MIN_CHUNK_ROWS))
        split: List[Tuple[List[SpillableBatch], List[ColumnarBatch]]] = []
        try:
            # 1. sort + split every input run
            for sb in runs:
                run = with_retry_no_split(
                    lambda sb=sb: self._sort_one(sb.get()),
                    counters=counters)
                sb.close()
                split.append(self._split_run(ctx, run, budget,
                                             max(min(k, max_k), 2)))
                del run
            # 2. cascade while too many runs for the residency bound:
            # each group of consecutive runs merges into one longer run,
            # in the runs' order, whose emitted pieces are split again
            # into C-row chunks
            while len(split) > max_k:
                groups = [split[i:i + max_k]
                          for i in range(0, len(split), max_k)]
                split = []
                for group in groups:
                    chunks: List[SpillableBatch] = []
                    heads: List[ColumnarBatch] = []
                    try:
                        for piece in self._merge_chunklists(ctx, group,
                                                            budget):
                            parts, hlist = self._split_run(ctx, piece,
                                                           budget, max_k)
                            chunks += parts
                            heads += hlist
                    except BaseException:
                        for p in chunks:
                            p.close()
                        for parts, _ in (g for gr in groups for g in gr):
                            for p in parts:
                                p.close()
                        raise
                    split.append((chunks, heads))
            yield from self._merge_chunklists(ctx, split, budget)
        finally:
            for parts, _ in split:
                for p in parts:
                    p.close()

    def _split_run(self, ctx: ExecContext, run: ColumnarBatch,
                   budget: int, k: int):
        """Split a sorted run into spilled C-row chunks plus their head
        rows (1-row batches, kept on the device)."""
        counters = ctx.retry_counters(self.exec_id)
        c = max(_MIN_CHUNK_ROWS, budget // (2 * k))
        parts: List[SpillableBatch] = []
        heads: List[ColumnarBatch] = []

        def piece_at(start):
            with ctx.semaphore:
                piece = K.slice_batch(run, start, c, c)
                head = K.slice_batch(piece, 0, 1, 1)
            return SpillableBatch(piece, SpillPriority.ACTIVE_ON_DECK), head
        try:
            for start in range(0, max(run.num_rows, 1), c):
                sb, head = with_retry_no_split(
                    lambda s=start: piece_at(s), counters=counters)
                parts.append(sb)
                heads.append(head)
        except BaseException:
            for p in parts:
                p.close()
            raise
        return parts, heads

    # Rows that tie on the sort keys leave in input order, as the in-core
    # stable sort gives them: the merge orders by (keys, run index) and
    # keeps each run's rows in their order, carrying a run-index column
    # (``_RUN``) on the carry only.

    def _tagged_order(self, batch: ColumnarBatch):
        return (self._keys(batch) + [batch.column(_RUN)],
                [o.ascending for o in self.order] + [True],
                [o.nulls_first for o in self.order] + [False])

    def _tag(self, batch: ColumnarBatch, run: int) -> ColumnarBatch:
        tag = ColumnVector(
            torch.full((batch.capacity,), run, dtype=torch.int32,
                       device=batch.device), batch.live_mask(), dt.INT32)
        return ColumnarBatch(batch.columns + [tag], batch.names + [_RUN],
                             batch.num_rows, batch.device)

    def _load_order(self, all_heads) -> List[Tuple[int, int]]:
        """(run, chunk) of every chunk, in the order the merge loads
        them: by head row under (keys, run index), each run's chunks in
        their order. A run's heads are in order, so the smallest pending
        head is always the next chunk of this order."""
        tags = [(r, i) for r, hlist in enumerate(all_heads)
                for i in range(len(hlist))]
        if len(all_heads) == 1:
            return tags
        hb = K.concat_batches([self._tag(h, r) for r, hlist in
                               enumerate(all_heads) for h in hlist],
                              choose_capacity(len(tags)))
        keys, asc, nf = self._tagged_order(hb)
        perm = K.sort_indices(keys, asc, nf, hb.live_mask())
        return [tags[p] for p in perm[:len(tags)].tolist()]

    def _merge_chunklists(self, ctx: ExecContext, split, budget: int
                          ) -> Iterator[ColumnarBatch]:
        """Merge k chunk lists ((spilled chunks, head rows) per run).

        Each step loads the next chunk in head order, and the ones after
        it while they fit ``budget // _STEP_SHARE`` rows, sorts them by
        (keys, run) and
        merges them into the carry. Loop invariant: every emitted row
        orders <= the first row of every unloaded chunk, so the emitted
        batches in order are globally sorted. The carry holds rows that
        unloaded rows may still precede; only the last loaded chunk of
        each run can have rows there, so carry <= k*C <= budget/2."""
        counters = ctx.retry_counters(self.exec_id)
        peak = ctx.metric(self.exec_id, "sortOocPeakRows", Metric.DEBUG)
        chunks = [parts for parts, _ in split]
        all_heads = [hlist for _, hlist in split]
        step_rows = max(1, budget // _STEP_SHARE)
        carry: Optional[ColumnarBatch] = None

        def sorted_group(loaded):
            if len(loaded) == 1:
                return loaded[0]  # a chunk of a sorted run is sorted
            # chunks of one run come in their order: the stable sort
            # keeps that run's tied rows in input order
            with ctx.semaphore:
                group = K.concat_batches(loaded, choose_capacity(
                    sum(b.num_rows for b in loaded)))
                keys, asc, nf = self._tagged_order(group)
                return K.sort_batch(group, keys, asc, nf)

        def merge_step(carry, group):
            if carry is None:
                return group
            # both sorted by (keys, run): a linear merge, carry first on
            # ties, as the stable sort of their concatenation orders them
            keys, asc, nf = self._tagged_order(carry)
            with ctx.semaphore:
                return K.merge_sorted(carry, group, keys,
                                      self._tagged_order(group)[0], asc, nf)

        def untagged(batch, start, n):
            out = K.slice_batch(batch, start, n, choose_capacity(n))
            return out.select(out.names[:-1])
        try:
            with ctx.semaphore:
                order = with_retry_no_split(
                    lambda: self._load_order(all_heads), counters=counters)
            pos = 0
            while pos < len(order):
                loaded: List[ColumnarBatch] = []
                rows = 0
                while pos < len(order):
                    r, i = order[pos]
                    sb = chunks[r][i]
                    if loaded and rows + sb.num_rows > step_rows:
                        break
                    loaded.append(self._tag(with_retry_no_split(
                        sb.get, counters=counters), r))
                    sb.close()
                    rows += loaded[-1].num_rows
                    pos += 1
                group = with_retry_no_split(lambda: sorted_group(loaded),
                                            counters=counters)
                del loaded
                merged = with_retry_no_split(
                    lambda c=carry, g=group: merge_step(c, g),
                    counters=counters)
                del group, carry
                peak.value = max(peak.value, merged.num_rows)
                if pos == len(order):
                    carry = merged
                    break
                rb, ib = order[pos]
                bound = self._tag(all_heads[rb][ib], rb)
                with ctx.semaphore:
                    keys, asc, nf = self._tagged_order(merged)
                    n = K.rows_not_after(keys, self._tagged_order(bound)[0],
                                         asc, nf, merged.live_mask())
                if n == 0:
                    carry = merged
                    continue
                rest = merged.num_rows - n
                with ctx.semaphore:
                    out = untagged(merged, 0, n)
                    carry = K.slice_batch(merged, n, rest,
                                          choose_capacity(rest)) \
                        if rest else None
                del merged
                yield out
            if carry is not None and carry.num_rows:
                yield carry.select(carry.names[:-1])
        finally:
            for parts in chunks:
                for p in parts:
                    p.close()

    def node_description(self) -> str:
        keys = ", ".join(f"{o.expr!r} {'ASC' if o.ascending else 'DESC'}"
                         for o in self.order)
        return f"Sort[{keys}]"


class TopNExec(TpuExec):
    """ORDER BY + LIMIT n fused: keeps only the top n rows of each batch,
    shrunk to the limit's capacity, then selects the top n of those.
    Memory stays O(batches * n), not the full-sort concat."""

    def __init__(self, child: TpuExec, order: Sequence[SortOrder],
                 limit: int):
        super().__init__(child)
        self.order = list(order)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def _topn(self, batch: ColumnarBatch) -> ColumnarBatch:
        keys = [o.expr.eval(batch) for o in self.order]
        sorted_b = K.sort_batch(batch, keys, [o.ascending for o in self.order],
                                [o.nulls_first for o in self.order])
        return K.local_limit(sorted_b, self.limit)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        part_cap = choose_capacity(self.limit)
        partials: List[ColumnarBatch] = []
        for batch in self.children[0].execute(ctx):
            if batch.num_rows == 0:
                continue
            part = self._topn(batch)
            if part.capacity > part_cap:
                part = K.repack_to(part, part_cap)
            partials.append(part)
        if not partials:
            return
        total = sum(p.num_rows for p in partials)
        merged = partials[0] if len(partials) == 1 else K.concat_batches(
            partials, choose_capacity(max(total, self.limit)))
        yield self._topn(merged)

    def node_description(self) -> str:
        return f"TopN[{self.limit}]"
