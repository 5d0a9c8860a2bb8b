"""CPU operators over host tables.

Counterpart of spark_rapids_tpu/plan/cpu_exec.py, copied with its
imports re-pointed: the engine that runs a plan subtree the planner
tagged off the device (the role CPU Spark plays for the reference),
columnar over numpy in the CPU engine's layout (host_table.py
``to_engine``). A ``DeviceRelation`` leaf is read through
``batch_to_table``; ``Range`` and ``Sample`` make the device's rows
(``Sample`` through its keep mask on CPU tensors); FileScan and
CachedRelation are not in the port.

Aggregation/join/sort semantics mirror the device execs:
- group nulls form their own group (Spark GROUP BY semantics),
- min/max skip nulls, NaN sorts greatest, empty-group sum/avg -> null,
- joins are equi hash joins; order of output rows is not part of the
  contract (tests sort before comparing).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..columnar import dtypes as dt
from ..expr import aggregates as Agg
from . import cpu_eval
from .host_table import (HostColumn, HostTable, concat_tables, empty_like,
                         from_pydict)
from .logical import (Aggregate, DeviceRelation, Expand, Filter, Generate,
                      Join, Limit, LocalRelation, LogicalPlan, Project,
                      Range, Sample, Sort, Union, Window)


def execute_cpu(plan: LogicalPlan) -> HostTable:
    """Interpret a logical plan subtree entirely on CPU."""
    return apply_cpu_node(plan, [execute_cpu(c) for c in plan.children])


def apply_cpu_node(plan: LogicalPlan,
                   children: List[HostTable]) -> HostTable:
    """Apply ONE logical node to already-evaluated child tables. The seam
    that lets mixed CPU / device physical trees reuse the CPU engine
    (transitions.py wraps device subtrees so they appear as child
    tables)."""
    if isinstance(plan, LocalRelation):
        return from_pydict(plan.data, plan.schema)
    if isinstance(plan, DeviceRelation):
        from .host_table import batch_to_table, to_engine
        tables = [to_engine(batch_to_table(b)) for b in plan.batches
                  if b.num_rows]
        return concat_tables(tables) if tables else empty_like(plan.schema)
    if isinstance(plan, Project):
        child = children[0]
        cols = [cpu_eval.evaluate(e, child) for e in plan.exprs]
        return HostTable(cols, [n for n, _ in plan.schema])
    if isinstance(plan, Filter):
        child = children[0]
        cond = cpu_eval.evaluate(plan.condition, child)
        return child.select_rows(cond.values & cond.mask)
    if isinstance(plan, Limit):
        child = children[0]
        return child.take(np.arange(min(plan.n, child.num_rows)))
    if isinstance(plan, Union):
        names = [n for n, _ in plan.schema]
        parts = []
        for i, c in enumerate(children):
            exprs = plan.child_casts(i)
            if exprs is not None:
                c = HostTable([cpu_eval.evaluate(e, c) for e in exprs],
                              [n for n, _ in c.schema()])
            parts.append(_normalize(c, names))
        return concat_tables(parts)
    if isinstance(plan, Range):
        ids = plan.start + np.arange(plan.num_rows, dtype=np.int64) * \
            plan.step
        return HostTable([HostColumn(ids, np.ones(len(ids), bool),
                                     dt.INT64)], ["id"])
    if isinstance(plan, Sample):
        import torch

        from ..exec.basic import sample_keep_mask
        child = children[0]
        keep = sample_keep_mask(0, child.num_rows, plan.fraction, plan.seed,
                                torch.device("cpu"))
        return child.select_rows(keep.numpy())
    if isinstance(plan, Expand):
        child = children[0]
        parts = []
        for proj in plan.projections:
            cols = [cpu_eval.evaluate(e, child) for e in proj]
            cols = [_coerce_col(c, t) for c, (_, t) in zip(cols, plan.schema)]
            parts.append(HostTable(cols, [n for n, _ in plan.schema]))
        return concat_tables(parts)
    if isinstance(plan, Generate):
        return _generate_table(children[0], plan)
    if isinstance(plan, Sort):
        return _sort_table(children[0], plan.order)
    if isinstance(plan, Aggregate):
        return _aggregate_table(children[0], plan)
    if isinstance(plan, Join):
        return _join_tables(children[0], children[1], plan)
    if isinstance(plan, Window):
        return _window_table(children[0], plan)
    raise NotImplementedError(f"CPU executor: {type(plan).__name__}")


def _normalize(t: HostTable, names: List[str]) -> HostTable:
    return HostTable(t.columns, names)


def _coerce_col(c: HostColumn, t: dt.DType) -> HostColumn:
    if c.dtype == t or t == dt.STRING:
        return c
    if isinstance(t, dt.DecimalType):
        if isinstance(c.dtype, dt.DecimalType):
            from .cpu_eval import _rescale_np
            return HostColumn(_rescale_np(c.values.astype(np.int64),
                                          c.dtype.scale, t.scale), c.mask, t)
        return HostColumn(c.values.astype(np.int64)
                          * np.int64(10 ** t.scale), c.mask, t)
    return HostColumn(c.values.astype(np.dtype(t.np_physical)), c.mask, t)


# ---------------------------------------------------------------------------
# generate (explode)
# ---------------------------------------------------------------------------

def _generate_table(child: HostTable, plan) -> HostTable:
    """Explode/posexplode oracle (GpuGenerateExec semantics); a map
    gives its key and value columns."""
    gen = plan.generator
    lists = cpu_eval.evaluate(gen.children[0], child)
    et = gen.data_type(child.schema())
    rows, positions, elems = [], [], []
    for i in range(child.num_rows):
        lst = lists.values[i] if lists.mask[i] else None
        if plan.value_name and lst:
            lst = list(lst.items())   # a map's (key, value) entries
        if not lst:
            if gen.outer:
                rows.append(i)
                positions.append(None)
                elems.append(None)
            continue
        for p, e in enumerate(lst):
            rows.append(i)
            positions.append(p)
            elems.append(e)
    idx = np.array(rows, dtype=np.int64)
    out = child.take(idx)
    cols, names = list(out.columns), list(out.names)
    if plan.pos_name:
        pmask = np.array([p is not None for p in positions], dtype=bool)
        pvals = np.array([p if p is not None else 0 for p in positions],
                         dtype=np.int32)
        cols.append(HostColumn(pvals, pmask, dt.INT32))
        names.append(plan.pos_name)
    if plan.value_name:
        (_, kt), (_, vt) = et.fields
        cols += [_element_column([None if e is None else e[0]
                                  for e in elems], kt),
                 _element_column([None if e is None else e[1]
                                  for e in elems], vt)]
        names += [plan.element_name, plan.value_name]
    else:
        cols.append(_element_column(elems, et))
        names.append(plan.element_name)
    return HostTable(cols, names)


def _element_column(elems, et: dt.DType) -> HostColumn:
    """Logical values (None for null) as a column of ``et``."""
    from ..expr.core import literal_physical as _to_physical
    emask = np.array([e is not None for e in elems], dtype=bool)
    if et == dt.STRING or et.is_nested or dt.is_wide_decimal(et):
        evals = np.empty(len(elems), dtype=object)
        for i, e in enumerate(elems):
            evals[i] = _to_physical(e, et) if e is not None and \
                dt.is_wide_decimal(et) else e if e is not None else \
                ("" if et == dt.STRING else 0 if dt.is_wide_decimal(et)
                 else None)
    else:
        evals = np.array([_to_physical(e, et) if e is not None else 0
                          for e in elems], dtype=np.dtype(et.np_physical))
    return HostColumn(evals, emask, et)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def _sort_keys(col: HostColumn, ascending: bool, nulls_first: bool):
    """Build (null_rank, value_key) so np.lexsort matches Spark ordering."""
    n = len(col)
    null_rank = np.where(col.mask, 1, 0 if nulls_first else 2)
    if col.dtype.is_nested:
        # rank nested values by their Spark order; equal values share a
        # rank, so a descending sort negates it
        keys = [_order_key(v) if ok else (0,)
                for v, ok in zip(col.values, col.mask)]
        uniq = {k: r for r, k in enumerate(sorted(set(keys)))}
        key = np.array([uniq[k] for k in keys], np.int64)
    elif col.dtype == dt.STRING:
        # rank strings by sorted order (stable, handles desc via negation)
        order = np.argsort(np.where(col.mask, col.values, ""), kind="stable")
        rank = np.empty(n, np.int64)
        # equal strings must share a rank for desc negation to be correct
        vals = np.where(col.mask, col.values, "")
        sorted_vals = vals[order]
        uniq_rank = np.zeros(n, np.int64)
        if n:
            neq = np.concatenate([[0], (sorted_vals[1:] != sorted_vals[:-1])
                                  .astype(np.int64)])
            uniq_rank = np.cumsum(neq)
        rank[order] = uniq_rank
        key = rank
    elif np.issubdtype(col.values.dtype, np.floating):
        # NaN strictly greatest (> +inf): lift it into the class rank —
        # mapping it onto inf would tie with real infinities. Classes:
        # nulls-first null(0) < values(1) < NaN(2) < nulls-last null(3)
        # ascending; descending flips the value/NaN order (NaN first).
        v = col.values.astype(np.float64)
        nan = np.isnan(v)
        nan_cls = 2 if ascending else 1
        val_cls = 1 if ascending else 2
        null_rank = np.where(col.mask, np.where(nan, nan_cls, val_cls),
                             0 if nulls_first else 3)
        key = np.where(nan, 0.0, v)
        # -0.0 == 0.0 in Spark ordering; np handles that already
    else:
        key = col.values
    if not ascending:
        arr = np.asarray(key)
        if np.issubdtype(arr.dtype, np.floating):
            key = -key
        elif arr.dtype == object:
            # decimal128 unscaled ints exceed int64 — negate as python
            # ints (object lanes already sort via python compare)
            key = np.array([None if x is None else -x for x in key],
                           dtype=object)
        else:
            key = -(key.astype(np.int64))
    return null_rank, key


def _sort_table(table: HostTable, order) -> HostTable:
    if table.num_rows == 0:
        return table
    keys = []
    for o in order:
        col = cpu_eval.evaluate(o.expr, table)
        null_rank, key = _sort_keys(col, o.ascending, o.nulls_first)
        # null placement dominates the value key (nulls sort before/after
        # ALL values, including negatives)
        keys.append(null_rank)
        keys.append(key)
    # lexsort: last key is primary
    idx = np.lexsort(tuple(reversed(keys)))
    return table.take(idx)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

_NAN_KEY = object()  # canonical NaN grouping key: NaN == NaN in keys


def _py(v):
    """A lane value as a Python scalar (wide decimals already are)."""
    return v.item() if hasattr(v, "item") else v


def _freeze(v):
    """A nested value as a hashable key: lists as tuples, structs and
    maps as tuples of (name, value), NaN as one key."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _freeze(x)) for k, x in v.items())
    return _norm_key(v)


def _order_key(v):
    """A nested value as a sort key in Spark's order: NULL first,
    arrays element by element (a prefix first), structs field by field,
    NaN above every number."""
    if v is None:
        return (0,)
    if isinstance(v, list):
        return (1, tuple(_order_key(x) for x in v))
    if isinstance(v, dict):
        return (1, tuple(_order_key(x) for x in v.values()))
    if isinstance(v, float) and v != v:
        return (2,)
    return (1, v)


def _norm_key(v):
    """Spark NormalizeFloatingNumbers for grouping/partition keys:
    every NaN is THE NaN, -0.0 is 0.0."""
    if isinstance(v, float):
        if v != v:
            return _NAN_KEY
        if v == 0.0:
            return 0.0
    return v


def _group_ids(key_cols: List[HostColumn], n: int):
    """Assign group ids; returns (gid array, representative row indices in
    first-seen order)."""
    if not key_cols:
        return np.zeros(n, np.int64), (np.array([0], np.int64) if n
                                       else np.zeros(0, np.int64))
    if n and not any(c.dtype.is_nested for c in key_cols):
        return _group_ids_sorted(key_cols, n)
    seen: Dict[tuple, int] = {}
    gid = np.empty(n, np.int64)
    reps: List[int] = []
    for i in range(n):
        k = tuple((None if not c.mask[i]
                   else (c.values[i] if c.dtype == dt.STRING
                         else _freeze(c.values[i]) if c.dtype.is_nested
                         else _norm_key(_py(c.values[i]))))
                  for c in key_cols)
        g = seen.get(k)
        if g is None:
            g = len(reps)
            seen[k] = g
            reps.append(i)
        gid[i] = g
    return gid, np.asarray(reps, np.int64)


def _group_ids_sorted(key_cols: List[HostColumn], n: int):
    """``_group_ids`` by sorting instead of a Python dict: each key
    column's values ranked by np.unique (NULL its own rank, every NaN one
    value, -0.0 equal to 0.0), the ranks combined, the groups numbered in
    first-seen order."""
    parts = []
    for c in key_cols:
        vals = c.values
        if np.issubdtype(vals.dtype, np.floating):
            nan = np.isnan(vals)
            parts.append((nan.astype(np.int64), c.mask))
            vals = np.where(nan | (vals == 0), 0.0, vals)  # -0.0 is 0.0
        parts.append((vals, c.mask))
    combined = np.zeros(n, np.int64)
    for vals, mask in parts:
        if not mask.all():
            vals = np.where(mask, vals, vals[np.argmax(mask)])
        if vals.dtype == object and isinstance(vals[0], str):
            fixed = vals.astype(str)  # sorts in C, not by Python compares
            # a fixed-width string drops trailing NULs: keep the objects
            # where that would merge two values
            if "\x00" not in "".join(fixed[-1:]) and np.array_equal(
                    np.char.str_len(fixed),
                    np.fromiter(map(len, vals), np.int64, len(vals))):
                vals = fixed
        _, rank = np.unique(vals, return_inverse=True)
        rank = np.where(mask, rank.reshape(-1) + 1, 0)
        _, combined = np.unique(combined * (int(rank.max()) + 1) + rank,
                                return_inverse=True)
        combined = combined.reshape(-1)
    _, first, inv = np.unique(combined, return_index=True,
                              return_inverse=True)
    order = np.argsort(first, kind="stable")   # groups by first row
    renumber = np.empty(len(order), np.int64)
    renumber[order] = np.arange(len(order))
    return renumber[inv.reshape(-1)], first[order].astype(np.int64)


def _ansi_raise(fn: Agg.AggregateFunction, what: str) -> None:
    """ANSI: SUM / AVG overflow raises, as the device's finalize does."""
    if fn.ansi:
        from ..expr import errors as ERR
        raise ERR.SparkArithmeticException(what)


def _agg_cpu(fn: Agg.AggregateFunction, values: Optional[np.ndarray],
             mask: Optional[np.ndarray], rows: np.ndarray,
             in_dtype: Optional[dt.DType], out_t: dt.DType):
    """One aggregate over the rows of one group -> (value, valid)."""
    if isinstance(fn, Agg.CountStar):
        return len(rows), True
    v = values[rows]
    m = mask[rows]
    if isinstance(fn, Agg.Count):
        return int(m.sum()), True
    valid_v = v[m]
    if isinstance(fn, Agg.First):  # Last subclasses First
        is_last = isinstance(fn, Agg.Last)
        if fn.ignore_nulls:
            if len(valid_v) == 0:
                return 0, False
            return valid_v[-1 if is_last else 0], True
        if len(v) == 0:
            return 0, False
        i = -1 if is_last else 0
        return v[i], bool(m[i])
    if isinstance(fn, Agg.CollectList):  # CollectSet subclasses it
        vals = [v.item() if hasattr(v, "item") else v for v in valid_v]
        if isinstance(fn, Agg.CollectSet):
            seen = []
            for v in vals:
                if v not in seen:
                    seen.append(v)
            vals = seen
        return vals, True  # collect of empty group = empty array
    if len(valid_v) == 0:
        return 0, False
    if isinstance(fn, Agg.ApproxPercentile):
        # exact nearest rank (the smallest value whose cumulative count
        # reaches ceil(p * N)): the limit the device sketch approaches
        x = np.sort(valid_v.astype(np.float64))
        if isinstance(in_dtype, dt.DecimalType):
            x = x / (10.0 ** in_dtype.scale)
        outs = [float(x[min(max(int(np.ceil(p * len(x))) - 1, 0),
                            len(x) - 1)]) for p in fn.percentages]
        return (outs if fn.is_array else outs[0]), True
    if isinstance(fn, Agg.Percentile):
        x = valid_v.astype(np.float64)
        if isinstance(in_dtype, dt.DecimalType):
            x = x / (10.0 ** in_dtype.scale)
        return float(np.percentile(x, fn.percentage * 100)), True
    if isinstance(fn, Agg.Sum):
        if isinstance(out_t, dt.DecimalType):
            # exact arbitrary-precision oracle; overflow -> null like
            # the device 128-bit accumulator
            total = sum(int(x) for x in valid_v)
            if abs(total) >= 10 ** out_t.precision:
                _ansi_raise(fn, "Decimal sum overflow")
                return 0, False
            return total, True
        if out_t == dt.INT64:
            if fn.ansi:
                exact = sum(int(x) for x in valid_v)
                if not -(2 ** 63) <= exact < 2 ** 63:
                    _ansi_raise(fn, "long overflow")
                return exact, True
            return int(valid_v.astype(np.int64).sum()), True
        return float(valid_v.astype(np.float64).sum()), True
    if isinstance(fn, Agg.Min) or isinstance(fn, Agg.Max):
        want_max = isinstance(fn, Agg.Max)
        if in_dtype == dt.STRING:
            return (max(valid_v) if want_max else min(valid_v)), True
        x = valid_v
        if np.issubdtype(x.dtype, np.floating):
            # NaN greatest (Spark ordering)
            if want_max:
                return (np.nan if np.isnan(x).any()
                        else float(x.max())), True
            non_nan = x[~np.isnan(x)]
            return ((float(non_nan.min()) if len(non_nan) else np.nan),
                    True)
        return (x.max() if want_max else x.min()), True
    if isinstance(fn, Agg.Average):
        if isinstance(in_dtype, dt.DecimalType):
            # exact decimal average at the (possibly adjusted) result
            # scale, HALF_UP; sum-buffer overflow -> null (the buffer is
            # decimal(min(p+10,38)), like the device accumulator)
            total = sum(int(x) for x in valid_v)
            sum_prec = min(in_dtype.precision + 10,
                           dt.DecimalType.MAX_PRECISION)
            if abs(total) >= 10 ** sum_prec:
                _ansi_raise(fn, "Decimal average overflow")
                return 0, False
            n_v = len(valid_v)
            num = abs(total) * 10 ** (out_t.scale - in_dtype.scale)
            q, r = divmod(num, n_v)
            if 2 * r >= n_v:
                q += 1
            if total < 0:
                q = -q
            if abs(q) >= 10 ** out_t.precision:
                _ansi_raise(fn, "Decimal average overflow")
                return 0, False
            return q, True
        x = valid_v.astype(np.float64)
        return float(x.sum() / len(x)), True
    if isinstance(fn, Agg._M2Base):
        x = valid_v.astype(np.float64)
        if isinstance(in_dtype, dt.DecimalType):
            x = x / (10.0 ** in_dtype.scale)
        n = len(x)
        mean = x.mean()
        m2 = float(((x - mean) ** 2).sum())
        ddof = fn.ddof
        if n - ddof <= 0:
            return 0.0, False
        var = m2 / (n - ddof)
        if isinstance(fn, (Agg.StddevPop, Agg.StddevSamp)):
            return float(np.sqrt(var)), True
        return var, True
    raise NotImplementedError(f"CPU aggregate {type(fn).__name__}")


def _aggregate_table(table: HostTable, plan: Aggregate) -> HostTable:
    schema_in = table.schema()
    key_cols = [cpu_eval.evaluate(e, table) for e in plan.group_exprs]
    n = table.num_rows
    gid, reps = _group_ids(key_cols, n)
    num_groups = len(reps)
    if not plan.group_exprs and n == 0:
        num_groups = 1  # global aggregate over empty input: one null row
        reps = np.zeros(0, np.int64)
        groups_rows = [np.zeros(0, np.int64)]
    else:
        # each group's rows in input order: one stable sort by group
        order = np.argsort(gid, kind="stable")
        bounds = np.searchsorted(gid[order], np.arange(1, num_groups))
        groups_rows = np.split(order, bounds)
    out_cols: List[HostColumn] = []
    names = [nm for nm, _ in plan.schema]
    # key columns: representative row of each group
    for kc in key_cols:
        if len(reps):
            out_cols.append(kc.take(reps))
        else:
            out_cols.append(HostColumn(
                np.zeros(num_groups, kc.values.dtype if
                         kc.dtype != dt.STRING else object),
                np.zeros(num_groups, bool), kc.dtype))
    # aggregates
    for fn, nm in plan.agg_exprs:
        out_t = fn.data_type(schema_in)
        if fn.children:
            in_col = cpu_eval.evaluate(fn.children[0], table)
            in_dtype = in_col.dtype
            values, mask = in_col.values, in_col.mask
        else:
            in_dtype, values, mask = None, None, None
        vals: List = []
        valids: List[bool] = []
        for rows in groups_rows:
            v, ok = _agg_cpu(fn, values, mask, rows, in_dtype, out_t)
            vals.append(v)
            valids.append(ok)
        if out_t == dt.STRING:
            arr = np.array([v if ok else "" for v, ok in zip(vals, valids)],
                           dtype=object)
        elif isinstance(out_t, dt.ArrayType):
            arr = np.empty(len(vals), dtype=object)
            for i, (v, ok) in enumerate(zip(vals, valids)):
                arr[i] = v if ok else []
        elif isinstance(out_t, dt.DecimalType) and out_t.is_wide:
            arr = np.array([int(v) if ok else 0
                            for v, ok in zip(vals, valids)], dtype=object)
        else:
            arr = np.array([v if ok else 0 for v, ok in zip(vals, valids)],
                           dtype=np.dtype(out_t.np_physical))
        out_cols.append(HostColumn(arr, np.asarray(valids, bool), out_t))
    return HostTable(out_cols, names)


# ---------------------------------------------------------------------------
# window (oracle: explicit per-partition python loops)
# ---------------------------------------------------------------------------

def _window_table(table: HostTable, plan: Window) -> HostTable:
    from ..expr.window import (Lag, Lead, DenseRank, NTile, PercentRank,
                               Rank, RowNumber)
    n = table.num_rows
    spec = plan.window_exprs[0][0].spec
    part_cols = [cpu_eval.evaluate(e, table) for e in spec.partition_by]
    # partition grouping
    gid, _reps = _group_ids(part_cols, n)
    # order within partition: global stable sort by order keys, then
    # walk rows partition by partition in that order
    if spec.order_fields:
        keys = []
        for o in spec.order_fields:
            c = cpu_eval.evaluate(o.expr, table)
            null_rank, key = _sort_keys(c, o.ascending, o.nulls_first)
            keys.extend([null_rank, key])
        order_perm = np.lexsort(tuple(reversed(keys)))
    else:
        order_perm = np.arange(n)
    part_rows: Dict[int, List[int]] = {}
    for i in order_perm:
        part_rows.setdefault(int(gid[i]), []).append(int(i))

    order_key_cols = [cpu_eval.evaluate(o.expr, table)
                      for o in spec.order_fields]

    def order_tuple(i):
        return tuple(
            (None if not c.mask[i] else
             (c.values[i] if c.dtype == dt.STRING else _py(c.values[i])))
            for c in order_key_cols)

    out_cols = list(table.columns)
    names = [nm for nm, _ in plan.schema]
    schema_in = table.schema()
    for we, _name in plan.window_exprs:
        fn = we.func
        out_t = we.data_type(schema_in)
        if out_t == dt.STRING:
            vals = np.full(n, "", dtype=object)
        elif out_t.is_nested or dt.is_wide_decimal(out_t):
            vals = np.zeros(n, dtype=object)
        else:
            vals = np.zeros(n, np.dtype(out_t.np_physical))
        mask = np.zeros(n, bool)
        # hoisted RANGE-frame machinery (one column eval per window, not
        # per row): value offsets scale to decimal keys' fixed point
        frame0 = we.spec.frame
        kval = range_lo = range_hi = None
        if frame0 is not None and not frame0.row_based and \
                not (frame0.is_running or frame0.is_unbounded) and \
                we.spec.order_fields:
            of = we.spec.order_fields[0]
            kcol = cpu_eval.evaluate(of.expr, table)
            sign = 1.0 if of.ascending else -1.0
            knull = -np.inf if of.nulls_first else np.inf

            def kval(r, _kcol=kcol, _sign=sign, _knull=knull):
                if not _kcol.mask[r]:
                    return _knull
                return _sign * float(_kcol.values[r])
            scale = 10 ** kcol.dtype.scale \
                if isinstance(kcol.dtype, dt.DecimalType) else 1
            range_lo = None if frame0.lo is None else frame0.lo * scale
            range_hi = None if frame0.hi is None else frame0.hi * scale
        if fn.children:
            in_col = cpu_eval.evaluate(fn.children[0], table)
        else:
            in_col = None
        for rows in part_rows.values():
            cnt = len(rows)
            frames = {}  # (lo, hi) -> the aggregate over those rows
            for pos, i in enumerate(rows):
                if isinstance(fn, RowNumber):
                    vals[i], mask[i] = pos + 1, True
                elif isinstance(fn, (Rank, DenseRank, PercentRank)):
                    r = d = 1
                    for p in range(1, pos + 1):
                        if order_tuple(rows[p]) != order_tuple(rows[p - 1]):
                            r = p + 1
                            d += 1
                    if isinstance(fn, Rank):
                        vals[i], mask[i] = r, True
                    elif isinstance(fn, DenseRank):
                        vals[i], mask[i] = d, True
                    else:
                        vals[i] = (r - 1) / (cnt - 1) if cnt > 1 else 0.0
                        mask[i] = True
                elif isinstance(fn, NTile):
                    q, rr = divmod(cnt, fn.n)
                    big = rr * (q + 1)
                    if pos < big:
                        b = pos // (q + 1)
                    elif q > 0:
                        b = rr + (pos - big) // q
                    else:
                        b = pos - big + rr
                    vals[i], mask[i] = b + 1, True
                elif isinstance(fn, Lead):  # Lag subclasses Lead
                    k = -fn.offset if isinstance(fn, Lag) else fn.offset
                    t = pos + k
                    if 0 <= t < cnt:
                        j = rows[t]
                        vals[i], mask[i] = in_col.values[j], in_col.mask[j]
                    elif fn.default is not None:
                        from ..expr.core import literal_physical as _to_physical
                        vals[i] = fn.default if out_t == dt.STRING else \
                            _to_physical(fn.default, out_t)
                        mask[i] = True
                else:
                    # aggregate over the frame
                    frame = we.spec.frame
                    if frame.is_unbounded:
                        lo, hi = 0, cnt - 1
                    elif frame.is_running:
                        lo, hi = 0, pos
                        if not frame.row_based:
                            # RANGE: include all peers of the current key
                            while hi + 1 < cnt and order_tuple(
                                    rows[hi + 1]) == order_tuple(rows[pos]):
                                hi += 1
                    elif frame.row_based:
                        lo = 0 if frame.lo is None else max(pos + frame.lo, 0)
                        hi = cnt - 1 if frame.hi is None else \
                            min(pos + frame.hi, cnt - 1)
                    else:
                        # RANGE with value offsets over the single
                        # numeric order key; null keys form their own
                        # peer group. kval/range_off are hoisted per
                        # window (see below the function list).
                        me = kval(rows[pos])
                        lo_v = me + range_lo if range_lo is not None \
                            else -np.inf
                        hi_v = me + range_hi if range_hi is not None \
                            else np.inf
                        lo = 0
                        while lo < cnt and kval(rows[lo]) < lo_v:
                            lo += 1
                        hi = cnt - 1
                        while hi >= 0 and kval(rows[hi]) > hi_v:
                            hi -= 1
                    if (lo, hi) not in frames:
                        frame_rows = np.asarray(rows[lo:hi + 1], np.int64) \
                            if hi >= lo else np.zeros(0, np.int64)
                        frames[lo, hi] = _agg_cpu(
                            fn,
                            in_col.values if in_col is not None else None,
                            in_col.mask if in_col is not None else None,
                            frame_rows,
                            in_col.dtype if in_col is not None else None,
                            out_t)
                    v, ok = frames[lo, hi]
                    vals[i], mask[i] = (v if ok else
                                        ("" if out_t == dt.STRING else 0)), ok
        out_cols.append(HostColumn(vals, mask, out_t))
    return HostTable(out_cols, names)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def _key_tuple(cols: List[HostColumn], i: int):
    out = []
    for c in cols:
        if not c.mask[i]:
            return None  # null keys never match (SQL equi-join)
        out.append(c.values[i] if c.dtype == dt.STRING
                   else _freeze(c.values[i]) if c.dtype.is_nested
                   else _py(c.values[i]))
    return tuple(out)


def _join_tables(left: HostTable, right: HostTable, plan: Join) -> HostTable:
    left_keys, right_keys = plan.coerced_keys()
    lk = [cpu_eval.evaluate(e, left) for e in left_keys]
    rk = [cpu_eval.evaluate(e, right) for e in right_keys]
    ln, rn = left.num_rows, right.num_rows
    index: Dict[tuple, List[int]] = {}
    for j in range(rn):
        k = _key_tuple(rk, j)
        if k is not None:
            index.setdefault(k, []).append(j)
    jt = plan.join_type
    li: List[int] = []
    ri: List[int] = []
    for i in range(ln):
        k = _key_tuple(lk, i)
        matches = index.get(k, []) if k is not None else []
        for j in matches:
            li.append(i)
            ri.append(j)
    names = [nm for nm, _ in plan.schema]

    def gather(tbl: HostTable, idx, valid=None) -> List[HostColumn]:
        arr = np.asarray(idx, np.int64)
        return [c.take(arr, valid) for c in tbl.columns]

    # A residual condition restricts which key-matched PAIRS count as
    # matches (SQL ON semantics — affects outer/semi/anti row survival,
    # not just output filtering).
    if plan.condition is not None and li:
        paired = HostTable(gather(left, li) + gather(right, ri),
                           left.names + right.names)
        cond = cpu_eval.evaluate(plan.condition, paired)
        keep = cond.values & cond.mask
        li = [i for i, k in zip(li, keep) if k]
        ri = [j for j, k in zip(ri, keep) if k]
    l_matched = np.zeros(ln, bool)
    r_matched = np.zeros(rn, bool)
    for i in li:
        l_matched[i] = True
    for j in ri:
        r_matched[j] = True

    if jt == "inner" or jt == "cross":
        return HostTable(gather(left, li) + gather(right, ri), names)
    if jt == "left_semi":
        return left.select_rows(l_matched)
    if jt == "left_anti":
        return left.select_rows(~l_matched)
    if jt == "left_outer":
        un = np.nonzero(~l_matched)[0]
        all_li = np.concatenate([np.asarray(li, np.int64), un])
        all_ri = np.concatenate([np.asarray(ri, np.int64),
                                 np.zeros(len(un), np.int64)])
        rvalid = np.concatenate([np.ones(len(li), bool),
                                 np.zeros(len(un), bool)])
        cols = gather(left, all_li) + gather(right, all_ri, rvalid)
        return HostTable(cols, names)
    if jt == "right_outer":
        un = np.nonzero(~r_matched)[0]
        all_li = np.concatenate([np.asarray(li, np.int64),
                                 np.zeros(len(un), np.int64)])
        all_ri = np.concatenate([np.asarray(ri, np.int64), un])
        lvalid = np.concatenate([np.ones(len(li), bool),
                                 np.zeros(len(un), bool)])
        cols = gather(left, all_li, lvalid) + gather(right, all_ri)
        return HostTable(cols, names)
    if jt == "full_outer":
        lun = np.nonzero(~l_matched)[0]
        run = np.nonzero(~r_matched)[0]
        all_li = np.concatenate([np.asarray(li, np.int64), lun,
                                 np.zeros(len(run), np.int64)])
        all_ri = np.concatenate([np.asarray(ri, np.int64),
                                 np.zeros(len(lun), np.int64), run])
        lvalid = np.concatenate([np.ones(len(li) + len(lun), bool),
                                 np.zeros(len(run), bool)])
        rvalid = np.concatenate([np.ones(len(li), bool),
                                 np.zeros(len(lun), bool),
                                 np.ones(len(run), bool)])
        cols = gather(left, all_li, lvalid) + gather(right, all_ri, rvalid)
        return HostTable(cols, names)
    raise NotImplementedError(f"CPU join type {jt}")
