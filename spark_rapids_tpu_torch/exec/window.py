"""Window execs: sort-based segmented-scan window computation.

Counterpart of spark_rapids_tpu/exec/window.py. ``WindowExec`` sorts its
whole input by (partition keys, order keys) once, derives segment
boundaries, and lowers every window function to segmented scans and
gathers over the sorted layout:

  row_number   idx - segment_start + 1
  rank         order-run start - segment start + 1
  dense_rank   segmented count of order-run starts
  ntile        closed-form bucket from row_number and partition size
  lead/lag     index-shifted gather masked to the segment
  running agg  segmented scan (sum/min/max/count/avg)
  whole-part.  the segmented scan's value at the segment's last row
  sliding ROWS prefix differences (sum/count/avg) or O(w) masked
               min/max for static window widths
  RANGE        per-row frame bounds by binary search over the order key,
               then prefix differences or a sparse-table min/max

Results scatter back to input order, so the node is order-preserving.
Only the columns the functions read are gathered into sorted order.

``BatchedRunningWindowExec`` streams running frames over a child already
sorted by (partition, order), batch by batch, with carried state.

Eager torch code: the JAX package's per-plan jit (``shared_method_jit``)
is not carried. ``WindowExec`` holds its input's batches as spillable
runs and concatenates and computes them under ``with_retry_no_split``,
as the JAX package does.
"""

from __future__ import annotations

from functools import cached_property
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (Column, ColumnVector, ColumnarBatch,
                               StringColumn, choose_capacity)
from ..expr.aggregates import (AggregateFunction, Average, Count, CountStar,
                               Max, Min, Sum)
from ..expr.conditional import _select_strings
from ..expr.core import Literal, make_result
from ..expr.window import (DenseRank, Lag, Lead, NTile, PercentRank, Rank,
                           RowNumber, WindowExpression, WindowFrame)
from ..memory.retry import with_retry_no_split
from ..memory.spill import SpillableBatch
from ..ops import kernels as K
from .base import ExecContext, Schema, TpuExec

# ---------------------------------------------------------------------------
# segmented primitives (all length-N over the sorted layout)
# ---------------------------------------------------------------------------


def _seg_bounds(new_seg: torch.Tensor):
    """For each row, the indices of its segment's first and last rows
    (``new_seg[0]`` must be True): binary searches of each row's segment
    number in the non-decreasing segment numbers. (A running max of the
    start indices, ``torch.cummax``, runs as one thread block on a 1-D
    CUDA tensor: about 4 ms per million rows on the H100.)"""
    sid = torch.cumsum(new_seg.to(torch.int64), 0)
    return (torch.searchsorted(sid, sid),
            torch.searchsorted(sid, sid, right=True) - 1)


def _seg_scan(op, vals: torch.Tensor, new_seg: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan, restarting where ``new_seg`` is True.

    Integer sums are a global cumsum less the sum before each segment's
    first row, which is exact. Every other op (float sums, min, max) is
    a log-step scan over (flag, value) pairs, ceil(log2 n) passes: a row
    combines only values of its own segment, so a float sum's rounding
    grows with its segment's values and not with the whole prefix."""
    if op is torch.add and not vals.is_floating_point():
        cs = torch.cumsum(vals, 0)
        start = _seg_bounds(new_seg)[0]
        return (cs - (cs[start] - vals[start])).to(vals.dtype)
    v, f = vals, new_seg
    n = vals.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _prev_differs(cols: Sequence[Column]) -> torch.Tensor:
    """True where row i's keys differ from row i-1 (row 0 = True)."""
    eq = K._adjacent_equal(cols[0])
    for c in cols[1:]:
        eq = eq & K._adjacent_equal(c)
    return ~eq


def _seg_lower_bound(keys, seg_start, seg_end, query) -> torch.Tensor:
    """Per-row first index j in [seg_start_i, seg_end_i] with
    keys[j] >= query_i (vectorized binary search, bit_length(cap)
    rounds of gathers)."""
    cap = keys.shape[0]
    lo, hi = seg_start, seg_end + 1  # hi exclusive
    for _ in range(max(cap.bit_length(), 1)):
        mid = (lo + hi) // 2
        ge = keys[mid.clamp(0, cap - 1)] >= query
        open_ = lo < hi
        hi = torch.where(ge & open_, mid, hi)
        lo = torch.where(~ge & open_, mid + 1, lo)
    return lo


def _seg_upper_bound(keys, seg_start, seg_end, query) -> torch.Tensor:
    """Per-row last index j in [seg_start_i, seg_end_i] with
    keys[j] <= query_i (lower bound of > query, less one)."""
    cap = keys.shape[0]
    lo, hi = seg_start, seg_end + 1
    for _ in range(max(cap.bit_length(), 1)):
        mid = (lo + hi) // 2
        gt = keys[mid.clamp(0, cap - 1)] > query
        open_ = lo < hi
        hi = torch.where(gt & open_, mid, hi)
        lo = torch.where(~gt & open_, mid + 1, lo)
    return lo - 1


def _prefix_diff(ps: torch.Tensor, lo_i, hi_i, first) -> torch.Tensor:
    """Frame totals ps[hi] - ps[lo - 1] from an inclusive prefix ``ps``
    whose sums restart at each row's ``first`` row."""
    cap = ps.shape[0]
    top = ps[hi_i.clamp(0, cap - 1)]
    bot = torch.where(lo_i > first, ps[(lo_i - 1).clamp(0, cap - 1)],
                      torch.zeros((), dtype=ps.dtype, device=ps.device))
    return top - bot


def _range_count(cnt_vals, lo_i, hi_i, width_empty) -> torch.Tensor:
    out = _prefix_diff(torch.cumsum(cnt_vals, 0), lo_i, hi_i, 0)
    return torch.where(width_empty, 0, out)


def _range_sum(vals, lo_i, hi_i, width_empty, seg) -> torch.Tensor:
    """Frame sums by prefix differences, IEEE-safe for floats: a +/-inf
    or NaN anywhere in the partition poisons only the frames that
    contain it (a plain prefix difference gives inf - inf = NaN for
    every frame after the value). Float prefixes restart at each
    segment (``_seg_scan``), so their rounding stays segment-local."""
    if not vals.is_floating_point():
        out = _prefix_diff(torch.cumsum(vals, 0), lo_i, hi_i, 0)
        return torch.where(width_empty, 0, out)
    finite = torch.isfinite(vals)
    base = _prefix_diff(
        _seg_scan(torch.add, torch.where(finite, vals, 0.0), seg.new_part),
        lo_i, hi_i, seg.seg_start)

    def present(mask):
        return _range_count(mask.to(torch.int64), lo_i, hi_i,
                            width_empty) > 0
    pos_inf = present(vals == float("inf"))
    neg_inf = present(vals == float("-inf"))
    has_nan = present(torch.isnan(vals))
    out = torch.where(pos_inf & ~neg_inf, float("inf"),
                      torch.where(neg_inf & ~pos_inf, float("-inf"), base))
    out = torch.where(has_nan | (pos_inf & neg_inf), float("nan"), out)
    return torch.where(width_empty, 0.0, out)


def _rmq(vals, lo_i, hi_i, op, fill) -> torch.Tensor:
    """Range min/max by a doubling sparse table: ``cap x
    ceil(log2 cap)`` values built, two gathers per query."""
    cap = vals.shape[0]
    levels = [vals]
    span = 1
    while span < cap:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], torch.full(
            (span,), fill, dtype=prev.dtype, device=prev.device)])
        levels.append(op(prev, shifted))
        span *= 2
    table = torch.stack(levels).reshape(-1)
    w = (hi_i - lo_i + 1).clamp(min=1)
    kk = torch.floor(torch.log2(w.to(torch.float64))).to(torch.int64)
    last = table.shape[0] - 1
    a = table[(kk * cap + lo_i).clamp(0, last)]
    b = table[(kk * cap + hi_i - (1 << kk) + 1).clamp(0, last)]
    out = op(a, b)
    return torch.where(hi_i < lo_i, torch.full((), fill, dtype=vals.dtype,
                                               device=vals.device), out)


class _Segments:
    """Partition segments and order runs of a (partition, order)-sorted
    layout of ``cap`` rows, ``n`` of them live. Dead rows form their own
    segment after the last live one, so a live row's segment holds live
    rows only."""

    def __init__(self, s_part: Sequence[Column], s_order: Sequence[Column],
                 n: int, cap: int, device):
        self.cap = cap
        self.idx = torch.arange(cap, device=device)
        self.s_live = self.idx < n
        edge = (self.idx == 0) | (self.idx == n)
        self.new_part = edge | _prev_differs(s_part) if s_part else edge
        self._s_order = list(s_order)

    @cached_property
    def _part_bounds(self):
        return _seg_bounds(self.new_part)

    @property
    def seg_start(self) -> torch.Tensor:
        return self._part_bounds[0]

    @property
    def seg_end(self) -> torch.Tensor:
        return self._part_bounds[1]

    @cached_property
    def counts(self) -> torch.Tensor:
        """Rows in each row's partition."""
        return self.seg_end - self.seg_start + 1

    @cached_property
    def new_order(self) -> torch.Tensor:
        if not self._s_order:
            return self.new_part
        return self.new_part | _prev_differs(self._s_order)

    @cached_property
    def _run_bounds(self):
        return _seg_bounds(self.new_order)

    @property
    def run_start(self) -> torch.Tensor:
        return self._run_bounds[0]

    @property
    def run_end(self) -> torch.Tensor:
        """Last row index of each order-key run (RANGE peers)."""
        return self._run_bounds[1]


def _minmax_fill(op, out_t: dt.DType):
    """The value under a null row that leaves a window MIN / MAX as it
    is. Spark orders NaN above every number, so MAX keeps
    ``torch.maximum`` (a NaN wins) while a float MIN takes
    ``torch.fmin``, which passes over a NaN unless both are NaN, and NaN
    is its neutral value."""
    if op is torch.fmin:
        return float("nan")
    return dt.max_value(out_t) if op is torch.minimum else \
        dt.min_value(out_t)


def _agg_inputs(fn: AggregateFunction, col: Optional[Column], live,
                out_t: dt.DType):
    """(op, values with each null row's neutral element, non-null count
    per row) of a window aggregate; ``col`` is None for COUNT(*)."""
    valid_in = live if col is None else col.validity & live
    cnt_vals = valid_in.to(torch.int64)
    if isinstance(fn, (Count, CountStar)):
        return torch.add, cnt_vals, cnt_vals
    if isinstance(fn, (Sum, Average)):
        phys = torch.float64 if isinstance(fn, Average) else out_t.physical
        vals = col.data.to(phys)
        return torch.add, torch.where(valid_in, vals, torch.zeros(
            (), dtype=phys, device=vals.device)), cnt_vals
    if isinstance(fn, (Min, Max)):
        op = torch.maximum if isinstance(fn, Max) else \
            torch.fmin if out_t.is_floating else torch.minimum
        return op, torch.where(valid_in, col.data, torch.full(
            (), _minmax_fill(op, out_t), dtype=col.data.dtype,
            device=col.data.device)), cnt_vals
    raise NotImplementedError(f"window aggregate {type(fn).__name__} is "
                              "not in this port yet")


def _finalize_agg(fn, acc, ncnt, s_live, out_t) -> ColumnVector:
    if isinstance(fn, (Count, CountStar)):
        return make_result(acc.to(torch.int64), s_live, dt.INT64)
    has_vals = (ncnt > 0) & s_live
    if isinstance(fn, Average):
        out = acc / torch.where(ncnt > 0, ncnt, 1).to(torch.float64)
        return make_result(out, has_vals, dt.FLOAT64)
    return make_result(acc.to(out_t.physical), has_vals, out_t)


def _agg_out_type(fn, in_schema) -> dt.DType:
    return dt.INT64 if isinstance(fn, CountStar) else \
        fn.data_type(in_schema)


class WindowExec(TpuExec):
    """Computes window columns for expressions sharing one
    (partition_by, order_by) spec; appends them to the child schema."""

    def __init__(self, child: TpuExec,
                 window_exprs: Sequence[Tuple[WindowExpression, str]]):
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        spec = self.window_exprs[0][0].spec
        self.partition_by = spec.partition_by
        self.order_by = spec.order_fields
        for we, _ in self.window_exprs[1:]:
            if (repr(we.spec.partition_by) != repr(self.partition_by)
                    or repr(we.spec.order_fields) != repr(self.order_by)):
                raise ValueError(
                    "one WindowExec handles one (partition, order) spec; "
                    "the planner must split differing specs")
        self._in_schema = child.output_schema
        self._schema = list(self._in_schema) + [
            (name, we.data_type(self._in_schema))
            for we, name in self.window_exprs]

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _compute(self, batch: ColumnarBatch) -> ColumnarBatch:
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        part_cols = [e.eval(batch) for e in self.partition_by]
        order_cols = [o.expr.eval(batch) for o in self.order_by]
        # sort by (partition, order); dead rows sort last
        asc = [True] * len(part_cols) + [o.ascending for o in self.order_by]
        nf = [True] * len(part_cols) + [o.nulls_first for o in self.order_by]
        perm = K.sort_indices(part_cols + order_cols, asc, nf,
                              batch.live_mask())
        seg = _Segments([c.gather(perm) for c in part_cols],
                        [c.gather(perm) for c in order_cols], n, cap, dev)
        out_cols = [self._one_function(we, batch, perm, seg)
                    for we, _ in self.window_exprs]
        # scatter results back to input order
        inv = torch.empty_like(perm)
        inv[perm] = seg.idx
        restored = [c.gather(inv) for c in out_cols]
        return ColumnarBatch(list(batch.columns) + restored,
                             [nm for nm, _ in self._schema], n, dev)

    def _one_function(self, we: WindowExpression, batch: ColumnarBatch,
                      perm: torch.Tensor, seg: _Segments) -> Column:
        fn = we.func
        idx, s_live = seg.idx, seg.s_live
        if isinstance(fn, RowNumber):
            rn = idx - seg.seg_start + 1
            return make_result(rn.to(torch.int32), s_live, dt.INT32)
        if isinstance(fn, (Rank, PercentRank)):
            rank = seg.run_start - seg.seg_start + 1
            if isinstance(fn, Rank):
                return make_result(rank.to(torch.int32), s_live, dt.INT32)
            counts = seg.counts
            denom = (counts - 1).clamp(min=1).to(torch.float64)
            pr = torch.where(counts > 1, (rank - 1).to(torch.float64) / denom,
                             0.0)
            return make_result(pr, s_live, dt.FLOAT64)
        if isinstance(fn, DenseRank):
            dr = _seg_scan(torch.add, seg.new_order.to(torch.int64),
                           seg.new_part)
            return make_result(dr.to(torch.int32), s_live, dt.INT32)
        if isinstance(fn, NTile):
            cnt = seg.counts
            q, r = cnt // fn.n, cnt % fn.n
            i0 = idx - seg.seg_start
            big_span = r * (q + 1)
            bucket = torch.where(
                i0 < big_span, i0 // (q + 1).clamp(min=1),
                r + torch.where(q > 0, (i0 - big_span) // q.clamp(min=1),
                                i0 - big_span))
            return make_result((bucket + 1).to(torch.int32), s_live,
                               dt.INT32)
        if isinstance(fn, Lead):  # Lag too
            col = fn.children[0].eval(batch).gather(perm)
            k = -fn.offset if isinstance(fn, Lag) else fn.offset
            target = idx + k
            in_seg = (target >= seg.seg_start) & (target <= seg.seg_end) & \
                (target >= 0) & (target < seg.cap)
            target = target.clamp(0, seg.cap - 1)
            if fn.default is None:
                return col.gather(target, in_seg & s_live)
            got = col.gather(target, in_seg)
            d = Literal(fn.default).eval(batch)
            if isinstance(got, StringColumn):
                out = _select_strings(in_seg, got, d)
                return StringColumn(out.offsets, out.chars,
                                    out.validity & s_live, out.pad_bucket)
            data = torch.where(in_seg, got.data, d.data.to(got.data.dtype))
            valid = torch.where(in_seg, got.validity, d.validity) & s_live
            return make_result(data, valid, got.dtype)
        if isinstance(fn, AggregateFunction):
            return self._window_aggregate(we, batch, perm, seg)
        raise NotImplementedError(f"window function {type(fn).__name__} is "
                                  "not in this port yet")

    def _window_aggregate(self, we: WindowExpression, batch, perm,
                          seg: _Segments) -> Column:
        fn, frame = we.func, we.spec.frame
        out_t = _agg_out_type(fn, self._in_schema)
        col = None if isinstance(fn, CountStar) else \
            fn.children[0].eval(batch).gather(perm)
        op, agg_vals, cnt_vals = _agg_inputs(fn, col, seg.s_live, out_t)
        if frame.is_unbounded or frame.is_running:
            acc = _seg_scan(op, agg_vals, seg.new_part)
            ncnt = _seg_scan(torch.add, cnt_vals, seg.new_part)
            if frame.is_unbounded:
                at = seg.seg_end.clamp(0, seg.cap - 1)
            elif not frame.row_based:
                # RANGE running: all peers of the current order key share
                # the value at their run's last row (SQL peer semantics)
                at = seg.run_end
            else:
                at = None
            if at is not None:
                acc, ncnt = acc[at], ncnt[at]
        elif frame.row_based:
            acc, ncnt = self._sliding(frame, op, agg_vals, cnt_vals, seg)
        else:
            acc, ncnt = self._range_sliding(we, batch, perm, op, agg_vals,
                                            cnt_vals, seg, out_t)
        return _finalize_agg(fn, acc, ncnt, seg.s_live, out_t)

    def _range_sliding(self, we, batch, perm, op, agg_vals, cnt_vals,
                       seg: _Segments, out_t):
        """RANGE BETWEEN x PRECEDING AND y FOLLOWING with value offsets:
        per-row frame bounds are binary searches over the
        partition-sorted order key; sums then use prefix differences and
        min/max a doubling sparse table."""
        frame = we.spec.frame
        of = we.spec.order_fields[0]
        key_col = of.expr.eval(batch).gather(perm)
        k = key_col.data.to(torch.float64)
        if not of.ascending:
            k = -k
        # null order keys are their own peer group at the sort's null
        # end: map them to +/-inf so their frames cover exactly the run
        k = torch.where(key_col.validity, k,
                        float("-inf") if of.nulls_first else float("inf"))
        lo_i = seg.seg_start if frame.lo is None else _seg_lower_bound(
            k, seg.seg_start, seg.seg_end, k + frame.lo)
        hi_i = seg.seg_end if frame.hi is None else _seg_upper_bound(
            k, seg.seg_start, seg.seg_end, k + frame.hi)
        width_empty = hi_i < lo_i
        if op is torch.add:
            acc = _range_sum(agg_vals, lo_i, hi_i, width_empty, seg)
        else:
            acc = _rmq(agg_vals, lo_i, hi_i, op, _minmax_fill(op, out_t))
        return acc, _range_count(cnt_vals, lo_i, hi_i, width_empty)

    def _sliding(self, frame: WindowFrame, op, agg_vals, cnt_vals,
                 seg: _Segments):
        """ROWS BETWEEN a AND b with integer bounds: prefix differences
        for sums and counts, an O(width) masked scan for min/max."""
        idx, cap = seg.idx, seg.cap
        lo_i = seg.seg_start if frame.lo is None else \
            torch.maximum(idx + frame.lo, seg.seg_start)
        hi_i = seg.seg_end if frame.hi is None else \
            torch.minimum(idx + frame.hi, seg.seg_end)
        width_empty = hi_i < lo_i
        if op is torch.add:
            return (_range_sum(agg_vals, lo_i, hi_i, width_empty, seg),
                    _range_count(cnt_vals, lo_i, hi_i, width_empty))
        if frame.lo is None or frame.hi is None:
            raise NotImplementedError(
                "min/max sliding frames need bounded ROWS offsets")
        acc = agg_vals[lo_i.clamp(0, cap - 1)]
        ncnt = torch.zeros(cap, dtype=torch.int64, device=idx.device)
        for off in range(frame.hi - frame.lo + 1):
            j = lo_i + off
            ok = j <= hi_i
            jc = j.clamp(0, cap - 1)
            acc = torch.where(ok, op(acc, agg_vals[jc]), acc)
            ncnt = ncnt + torch.where(ok, cnt_vals[jc], 0)
        return acc, ncnt

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # one partition: the whole input is one window partition set,
        # held as spillable runs
        counters = ctx.retry_counters(self.exec_id)
        runs: List[SpillableBatch] = []
        total = 0
        try:
            for b in self.children[0].execute(ctx):
                if b.num_rows == 0:
                    continue
                total += b.num_rows
                runs.append(with_retry_no_split(
                    lambda x=b: SpillableBatch(x), counters=counters))
                del b
            if not runs:
                return
            cap = choose_capacity(total)

            def compute():
                batches = [sb.get() for sb in runs]
                with ctx.semaphore:
                    merged = batches[0] if len(batches) == 1 \
                        else K.concat_batches(batches, cap)
                    del batches
                    return self._compute(merged)
            # RetryOOM: spill and re-run (pure over the held spillables)
            out = with_retry_no_split(compute, counters=counters)
            for sb in runs:
                sb.close()
            yield out
        finally:
            for sb in runs:
                sb.close()

    def node_description(self) -> str:
        fns = ", ".join(type(we.func).__name__
                        for we, _ in self.window_exprs)
        return f"Window[{fns}]"


# ---------------------------------------------------------------------------
# batched running windows (GpuRunningWindowExec + BatchedRunningWindowFixer)
# ---------------------------------------------------------------------------


def running_compatible(window_exprs, in_schema) -> bool:
    """True when every expression can stream batch-at-a-time over a
    (partition, order)-sorted child with carried state: row_number, rank,
    dense_rank, or ROWS running (unbounded-preceding..current-row)
    sum/min/max/count/avg over non-string inputs. RANGE running is
    excluded: its peer rows share the value at the run's last row,
    which can live in the next batch."""
    for we, _name in window_exprs:
        fn = we.func
        if isinstance(fn, (RowNumber, Rank, DenseRank)):
            continue
        frame = we.spec.frame
        if isinstance(fn, (Sum, Count, CountStar, Min, Max, Average)) \
                and frame is not None and frame.is_running \
                and frame.row_based:
            if fn.children and \
                    fn.children[0].data_type(in_schema) == dt.STRING:
                return False
            continue
        return False
    return True


class _RunningState:
    """What one batch hands the next: the last live row's partition and
    order keys, its row number in the partition, and per function the
    rank, dense rank, running accumulator and non-null count at that row
    (1-element device tensors: nothing is read back to the host)."""

    def __init__(self, tail_part, tail_order, rows, fns):
        self.tail_part = tail_part
        self.tail_order = tail_order
        self.rows = rows
        self.fns = fns


class BatchedRunningWindowExec(TpuExec):
    """Running-frame windows over an already (partition, order)-sorted
    stream in O(batch) memory: each batch computes its within-batch
    segmented scans, then its first partition run is fixed up with the
    state carried from the previous batch (rank and row-number bases,
    running accumulator and count), the BatchedRunningWindowFixer
    contract. The planner places a SortExec below that emits
    ``srt.sql.batchSizeRows``-row batches; output rows stream in sorted
    order (Spark's window makes no ordering promise)."""

    def __init__(self, child: TpuExec,
                 window_exprs: Sequence[Tuple[WindowExpression, str]]):
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        spec = self.window_exprs[0][0].spec
        self.partition_by = spec.partition_by
        self.order_by = spec.order_fields
        self._in_schema = child.output_schema
        self._schema = list(self._in_schema) + [
            (name, we.data_type(self._in_schema))
            for we, name in self.window_exprs]

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _compute(self, batch: ColumnarBatch,
                 state: Optional[_RunningState]):
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        part_cols = [e.eval(batch) for e in self.partition_by]
        order_cols = [o.expr.eval(batch) for o in self.order_by]
        seg = _Segments(part_cols, order_cols, n, cap, dev)
        idx, s_live = seg.idx, seg.s_live
        rn = idx - seg.seg_start + 1
        in_seg0 = (seg.seg_start == 0) & s_live
        row0 = torch.zeros(1, dtype=torch.int64, device=dev)
        if state is None:
            cont = cont_order = torch.zeros(1, dtype=torch.bool, device=dev)
        else:
            # grouping equality: a NULL partition key continues the NULL
            # partition
            cont = K._keys_equal(part_cols, row0, state.tail_part, row0,
                                 null_safe=True) if part_cols else \
                torch.ones(1, dtype=torch.bool, device=dev)
            cont_order = cont & K._keys_equal(
                order_cols, row0, state.tail_order, row0, null_safe=True) \
                if order_cols else cont
        prev_rows = torch.where(cont, state.rows, 0) if state else row0
        first = in_seg0 & cont
        last = n - 1

        out_cols: List[Column] = []
        new_fns = []
        for i, (we, _name) in enumerate(self.window_exprs):
            fn = we.func
            fst = state.fns[i] if state else None
            if isinstance(fn, RowNumber):
                out = torch.where(in_seg0, rn + prev_rows, rn)
                out_cols.append(make_result(out.to(torch.int32), s_live,
                                            dt.INT32))
                new_fns.append(None)
                continue
            if isinstance(fn, Rank):
                rank = seg.run_start - seg.seg_start + 1
                if fst is not None:
                    # rows continuing the tail's order run keep its rank;
                    # later runs of the continued partition shift by the
                    # carried partition row count
                    fixed = torch.where((seg.run_start == 0) & cont_order,
                                        fst, rank + prev_rows)
                    rank = torch.where(first, fixed, rank)
                out_cols.append(make_result(rank.to(torch.int32), s_live,
                                            dt.INT32))
                new_fns.append(rank[last:last + 1])
                continue
            if isinstance(fn, DenseRank):
                dr = _seg_scan(torch.add, seg.new_order.to(torch.int64),
                               seg.new_part)
                if fst is not None:
                    dr = torch.where(first, dr + fst - cont_order.to(
                        torch.int64), dr)
                out_cols.append(make_result(dr.to(torch.int32), s_live,
                                            dt.INT32))
                new_fns.append(dr[last:last + 1])
                continue
            # running aggregates
            out_t = _agg_out_type(fn, self._in_schema)
            col = None if isinstance(fn, CountStar) else \
                fn.children[0].eval(batch)
            op, agg_vals, cnt_vals = _agg_inputs(fn, col, s_live, out_t)
            acc = _seg_scan(op, agg_vals, seg.new_part)
            ncnt = _seg_scan(torch.add, cnt_vals, seg.new_part)
            if fst is not None:
                prev_acc, prev_cnt = fst
                prev_cnt = torch.where(cont, prev_cnt, 0)
                if op is torch.add:
                    fix = acc + torch.where(cont, prev_acc,
                                            torch.zeros_like(prev_acc))
                else:
                    fix = torch.where(cont & (prev_cnt > 0),
                                      op(acc, prev_acc), acc)
                acc = torch.where(in_seg0, fix, acc)
                ncnt = torch.where(in_seg0, ncnt + prev_cnt, ncnt)
            out_cols.append(_finalize_agg(fn, acc, ncnt, s_live, out_t))
            new_fns.append((acc[last:last + 1], ncnt[last:last + 1]))

        tail = torch.full((1,), last, dtype=torch.int64, device=dev)
        rows = torch.where(in_seg0, rn + prev_rows, rn)[last:last + 1]
        new_state = _RunningState([c.gather(tail) for c in part_cols],
                                  [c.gather(tail) for c in order_cols],
                                  rows, new_fns)
        out = ColumnarBatch(list(batch.columns) + out_cols,
                            [nm for nm, _ in self._schema], n, dev)
        return out, new_state

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        state = None
        for batch in self.children[0].execute(ctx):
            if batch.num_rows == 0:
                continue
            out, state = self._compute(batch, state)
            yield out

    def node_description(self) -> str:
        fns = ", ".join(type(we.func).__name__
                        for we, _ in self.window_exprs)
        return f"BatchedRunningWindow[{fns}]"
