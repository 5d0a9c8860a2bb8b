"""Collection (array / struct) expressions.

Counterpart of spark_rapids_tpu/expr/collections.py. The JAX package
lowers each list function onto a dense ``(capacity, pad_bucket)`` lane
block; here every function works over the flat child with segment
operations (columnar/nested.py): each element knows its row
(``element_rows``) and its place in the row (``element_within``),
per-row reductions are prefix sums read at the offsets or scatter
min / max, and a function that drops elements compacts the child
(``compact``). Work and memory follow the element count, whatever the
longest list.

Null semantics follow Spark:
- size(null) -> null, element access out of bounds -> null,
- array_contains: true if found; null if not found and the array holds
  a null element (three-valued membership, like IN),
- array_min / array_max skip nulls (NaN above every number);
  all-null / empty -> null,
- element equality (contains, position, remove, the set functions)
  holds NaN equal to NaN and -0.0 equal to 0.0,
- struct field access of a null struct -> null.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.nested import (ListColumn, StructColumn, compact,
                               offsets_from_lengths, seg_count, seg_first)
from ..columnar.vector import (ColumnVector, ColumnarBatch, StringColumn,
                               round_pow2, rows_from_offsets)
from .core import Expression, Schema, cpu_fallback, make_result


def _element_type(expr: Expression, schema: Schema) -> dt.DType:
    t = expr.data_type(schema)
    if not isinstance(t, dt.ArrayType):
        raise TypeError(f"expected array input, got {t}")
    return t.element_type


def _primitive_child(lc: ListColumn, what: str) -> ColumnVector:
    """The child of a list whose functions compare elements: a flat
    primitive column (string and nested elements run on the CPU engine:
    the planner's gates send them there)."""
    if not isinstance(lc.child, ColumnVector):
        raise cpu_fallback(f"{what} over {lc.element_type} elements",
                           "nested gate")
    return lc.child


def _fold(d: torch.Tensor) -> torch.Tensor:
    """Element values as compared: -0.0 folded into 0.0, booleans as
    int8."""
    if d.dtype == torch.bool:
        return d.to(torch.int8)
    if d.is_floating_point():
        return torch.where(d == 0, torch.zeros((), dtype=d.dtype,
                                                device=d.device), d)
    return d


def values_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark's element equality: NaN equals NaN, -0.0 equals 0.0."""
    eq = a == b
    if a.is_floating_point() or b.is_floating_point():
        eq = eq | (torch.isnan(a.to(torch.float64)) &
                   torch.isnan(b.to(torch.float64)))
    return eq


def _stable_argsort(key: torch.Tensor, descending: bool = False):
    return torch.sort(key, stable=True, descending=descending).indices


def row_sorted(lc: ListColumn, child: ColumnVector, ascending: bool = True,
               nulls_first: bool = True) -> torch.Tensor:
    """A permutation of the element positions that orders each row's
    elements by value (NaN above every number, -0.0 equal to 0.0), nulls
    first or last, ties in position order; rows in order, dead positions
    last."""
    rows = lc.element_rows()
    live = lc.element_live()
    perm = _stable_argsort(_fold(child.data), descending=not ascending)
    valid = child.validity[perm]
    cls = valid if nulls_first else ~valid
    perm = perm[_stable_argsort(cls.to(torch.int8))]
    perm = perm[_stable_argsort(rows[perm])]
    return perm[_stable_argsort((~live[perm]).to(torch.int8))]


def _equal_runs(lc: ListColumn, child: ColumnVector):
    """(perm, same): ``row_sorted``'s permutation and, per sorted
    position, whether it equals its predecessor (same row, same value,
    or both null)."""
    perm = row_sorted(lc, child)
    rows = lc.element_rows()[perm]
    vals = _fold(child.data)[perm]
    ok = child.validity[perm]
    same = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    same[1:] = (rows[1:] == rows[:-1]) & (
        (ok[1:] & ok[:-1] & values_equal(vals[1:], vals[:-1])) |
        (~ok[1:] & ~ok[:-1]))
    return perm, same


def first_occurrence(lc: ListColumn, child: ColumnVector) -> torch.Tensor:
    """bool[child_capacity]: the element is the first of its value in
    its row (nulls count as one value)."""
    perm, same = _equal_runs(lc, child)
    keep = torch.empty_like(same)
    keep[perm] = ~same
    return keep & lc.element_live()


class CreateArray(Expression):
    """array(e1, e2, ...): k elements per live row, in argument order;
    the arguments meet at their common type."""

    def __init__(self, *children: Expression):
        super().__init__(*children)

    def data_type(self, schema: Schema) -> dt.DType:
        from .conditional import _common_type
        return dt.ArrayType(_common_type([c.data_type(schema)
                                          for c in self.children]))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        from ..ops.kernels import _concat_columns
        from .cast import Cast
        et = self.data_type(batch.schema()).element_type
        if et == dt.NULL:
            et = dt.INT32
        cols = [(c if c.data_type(batch.schema()) == et else Cast(c, et))
                .eval(batch) for c in self.children]
        k, n, dev = len(cols), batch.num_rows, batch.device
        stacked = _concat_columns(cols, [n] * k, round_pow2(n * k))
        cap = round_pow2(n * k)
        pos = torch.arange(cap, device=dev)
        src = (pos % k) * n + pos // k  # row-major: row i at [i*k, i*k+k)
        child = stacked.gather(src, pos < n * k)
        live = batch.live_mask()
        lens = torch.where(live, k, 0)
        return ListColumn(offsets_from_lengths(lens), child, live, et)

    def __repr__(self):
        return f"array({', '.join(map(repr, self.children))})"


class Size(Expression):
    """size(array) or size(map): the element count; null -> null."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not isinstance(t, (dt.ArrayType, dt.MapType)):
            raise TypeError(f"size() needs an array, got {t}")
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        return make_result(lc.lengths().to(torch.int32), lc.validity,
                           dt.INT32)


def _element_at(lc: ListColumn, zero_based: torch.Tensor,
                ok: torch.Tensor):
    lens = lc.lengths().to(torch.int64)
    ok = ok & lc.validity & (zero_based >= 0) & (zero_based < lens)
    src = lc.offsets[:-1].to(torch.int64) + zero_based.clamp(min=0)
    return lc.child.gather(src, ok)


class GetArrayItem(Expression):
    """arr[i]: zero-based element access; out of bounds -> null."""

    def __init__(self, child: Expression, ordinal: Expression):
        super().__init__(child, ordinal)

    def data_type(self, schema: Schema) -> dt.DType:
        return _element_type(self.children[0], schema)

    def eval(self, batch: ColumnarBatch):
        lc = self.children[0].eval(batch)
        idx = self.children[1].eval(batch)
        return _element_at(lc, idx.data.to(torch.int64), idx.validity)


class ElementAt(Expression):
    """element_at(arr, i): 1-based, negative counts from the end; 0 and
    out of bounds -> null. element_at(map, key) is the map lookup."""

    def __init__(self, child: Expression, ordinal: Expression):
        super().__init__(child, ordinal)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if isinstance(t, dt.MapType):
            return t.value_type
        if isinstance(t, dt.ArrayType):
            return t.element_type
        raise TypeError(f"element_at on {t}")

    def eval(self, batch: ColumnarBatch):
        if isinstance(self.children[0].data_type(batch.schema()),
                      dt.MapType):
            from .higher_order import GetMapValue
            return GetMapValue(*self.children).eval(batch)
        lc = self.children[0].eval(batch)
        idx = self.children[1].eval(batch)
        i = idx.data.to(torch.int64)
        lens = lc.lengths().to(torch.int64)
        zero_based = torch.where(i > 0, i - 1, lens + i)
        return _element_at(lc, zero_based, idx.validity & (i != 0))


class ArrayContains(Expression):
    """array_contains(arr, v) with three-valued membership."""

    def __init__(self, child: Expression, value: Expression):
        super().__init__(child, value)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        needle = self.children[1].eval(batch)
        child = _primitive_child(lc, "array_contains")
        rows, live = lc.element_rows(), lc.element_live()
        nd = needle.data[rows]
        ok = child.validity & live
        found = seg_count(ok & values_equal(child.data, nd), lc.offsets) > 0
        has_null = seg_count(~child.validity & live, lc.offsets) > 0
        return make_result(found, lc.validity & needle.validity &
                           (found | ~has_null), dt.BOOL)


class _ArrayExtreme(Expression):
    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return _element_type(self.children[0], schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        child = _primitive_child(lc, type(self).__name__)
        rows, live = lc.element_rows(), lc.element_live()
        d = child.data
        ok = child.validity & live
        as_bool = d.dtype == torch.bool
        if as_bool:
            d = d.to(torch.int8)
        nan = torch.isnan(d) if d.is_floating_point() else \
            torch.zeros_like(ok)
        take = ok & ~nan
        if d.is_floating_point():
            fill = float("inf") if self.is_min else float("-inf")
        else:
            info = torch.iinfo(d.dtype)
            fill = info.max if self.is_min else info.min
        out = torch.full((lc.capacity,), fill, dtype=d.dtype,
                         device=d.device)
        out.scatter_reduce_(0, rows, torch.where(take, d, fill),
                            "amin" if self.is_min else "amax")
        any_num = seg_count(take, lc.offsets) > 0
        any_nan = seg_count(ok & nan, lc.offsets) > 0
        # NaN is above every number: max of a row holding one is NaN,
        # min is NaN only where nothing else is there
        to_nan = (~any_num if self.is_min else any_nan) & any_nan
        if d.is_floating_point():
            out = torch.where(to_nan, torch.full((), float("nan"),
                                                 dtype=d.dtype,
                                                 device=d.device), out)
        if as_bool:
            out = out.to(torch.bool)
        return make_result(out, lc.validity & (any_num | any_nan),
                           lc.element_type)


class ArrayMin(_ArrayExtreme):
    """array_min: nulls skipped."""

    is_min = True


class ArrayMax(_ArrayExtreme):
    """array_max: nulls skipped."""

    is_min = False


class SortArray(Expression):
    """sort_array(arr, asc): nulls first ascending, last descending
    (Spark); NaN above every number."""

    def __init__(self, child: Expression, ascending: bool = True):
        super().__init__(child)
        self.ascending = ascending

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        child = _primitive_child(lc, "sort_array")
        perm = row_sorted(lc, child, self.ascending, self.ascending)
        return ListColumn(lc.offsets, child.gather(perm, lc.element_live()),
                          lc.validity, lc.element_type)

    def __repr__(self):
        return (f"sort_array({self.children[0]!r}, "
                f"{'asc' if self.ascending else 'desc'})")


class ArrayDistinct(Expression):
    """array_distinct: the first occurrence of each value, in order."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_element_type(self.children[0], schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        child = _primitive_child(lc, "array_distinct")
        return compact(lc, first_occurrence(lc, child))


class _PairBase(Expression):
    """(array, array) -> ... functions: the two rows' elements side by
    side in one list (a's then b's), tagged by side."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__(left, right)

    def _elem_type(self, schema: Schema) -> dt.DType:
        from .conditional import _common_type
        return _common_type([_element_type(self.children[0], schema),
                             _element_type(self.children[1], schema)])

    def _joined(self, batch: ColumnarBatch):
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        ac = _primitive_child(a, type(self).__name__)
        bc = _primitive_child(b, type(self).__name__)
        validity = a.validity & b.validity
        la = torch.where(validity, a.lengths(), 0).to(torch.int64)
        lb = torch.where(validity, b.lengths(), 0).to(torch.int64)
        offsets = offsets_from_lengths(la + lb)
        total = int(offsets[-1])
        cap = round_pow2(total)
        dev = a.device
        pos = torch.arange(cap, device=dev)
        rows = rows_from_offsets(offsets[:-1], la + lb, cap)
        within = pos - offsets[:-1].to(torch.int64)[rows]
        is_b = within >= la[rows]
        live = pos < total
        src_a = (a.offsets[:-1].to(torch.int64)[rows] + within).clamp(
            0, a.child_capacity - 1)
        src_b = (b.offsets[:-1].to(torch.int64)[rows] + within -
                 la[rows]).clamp(0, b.child_capacity - 1)
        phys = torch.promote_types(ac.data.dtype, bc.data.dtype)
        data = torch.where(is_b, bc.data[src_b].to(phys),
                           ac.data[src_a].to(phys))
        ok = torch.where(is_b, bc.validity[src_b], ac.validity[src_a]) & live
        et = self._elem_type(batch.schema())
        both = ListColumn(offsets, make_result(data, ok, et), validity, et)
        return both, is_b & live

    def _membership(self, batch: ColumnarBatch):
        """(both, is_b, first, hit, b_has_null): per element of the
        joined list, whether it is its row's first of its value, whether
        b's side of the row holds its value, and per row whether b holds
        a null."""
        both, is_b = self._joined(batch)
        child = both.child
        perm, same = _equal_runs(both, child)
        run = torch.cumsum((~same).to(torch.int64), 0) - 1
        has_b = torch.zeros(perm.shape[0], dtype=torch.int64,
                            device=perm.device)
        has_b.scatter_reduce_(0, run, is_b[perm].to(torch.int64), "amax")
        hit = torch.empty_like(is_b)
        hit[perm] = has_b[run] > 0
        first = torch.empty_like(is_b)
        first[perm] = ~same
        b_has_null = seg_count(is_b & ~child.validity, both.offsets) > 0
        return both, is_b, first, hit, b_has_null


class ArrayUnion(_PairBase):
    """array_union(a, b): a's distinct elements, then b's unseen ones."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(self._elem_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        both, _ = self._joined(batch)
        return compact(both, first_occurrence(both, both.child))


class ArrayIntersect(_PairBase):
    """array_intersect: a's distinct elements present in b (a null
    kept when both sides hold one)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(self._elem_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        both, is_b, first, hit, b_null = self._membership(batch)
        ok = both.child.validity
        rows = both.element_rows()
        keep = ~is_b & first & ((ok & hit) | (~ok & b_null[rows]))
        return compact(both, keep)


class ArrayExcept(_PairBase):
    """array_except: a's distinct elements absent from b."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(self._elem_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        both, is_b, first, hit, b_null = self._membership(batch)
        ok = both.child.validity
        rows = both.element_rows()
        keep = ~is_b & first & ((ok & ~hit) | (~ok & ~b_null[rows]))
        return compact(both, keep)


class ArraysOverlap(_PairBase):
    """arrays_overlap: true if a non-null element is common; null when
    none is but both are non-empty and either holds a null."""

    def data_type(self, schema: Schema) -> dt.DType:
        self._elem_type(schema)
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        both, is_b, _, hit, b_null = self._membership(batch)
        ok = both.child.validity
        live = both.element_live()
        found = seg_count(~is_b & ok & hit, both.offsets) > 0
        a_null = seg_count(~is_b & ~ok & live, both.offsets) > 0
        a_any = seg_count(~is_b & live, both.offsets) > 0
        b_any = seg_count(is_b, both.offsets) > 0
        nullish = a_any & b_any & (a_null | b_null)
        return make_result(found, both.validity & (found | ~nullish),
                           dt.BOOL)


class ArrayRemove(Expression):
    """array_remove(arr, v): drop the elements equal to v (null elements
    stay); a null v -> null."""

    def __init__(self, child: Expression, value: Expression):
        super().__init__(child, value)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_element_type(self.children[0], schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        v = self.children[1].eval(batch)
        child = _primitive_child(lc, "array_remove")
        nd = v.data[lc.element_rows()]
        drop = child.validity & values_equal(child.data, nd)
        return compact(lc, ~drop, lc.validity & v.validity)


class ArrayPosition(Expression):
    """array_position(arr, v): the 1-based first index, 0 when absent;
    null inputs -> null."""

    def __init__(self, child: Expression, value: Expression):
        super().__init__(child, value)

    def data_type(self, schema: Schema) -> dt.DType:
        _element_type(self.children[0], schema)
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        v = self.children[1].eval(batch)
        child = _primitive_child(lc, "array_position")
        rows = lc.element_rows()
        nd = v.data[rows]
        hit = child.validity & lc.element_live() & values_equal(child.data,
                                                                nd)
        first = seg_first(hit, rows, lc.capacity)
        pos = torch.where(first >= 0,
                          first - lc.offsets[:-1].to(torch.int64) + 1, 0)
        return make_result(pos, lc.validity & v.validity, dt.INT64)


class Slice(Expression):
    """slice(arr, start, length): 1-based, a negative start counts from
    the end; a start outside the array gives an empty array (Spark;
    the JAX package keeps elements a start before the array's first
    reaches); start 0 or a negative length -> null (Spark raises)."""

    def __init__(self, child: Expression, start: Expression,
                 length: Expression):
        super().__init__(child, start, length)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_element_type(self.children[0], schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        s = self.children[1].eval(batch)
        n = self.children[2].eval(batch)
        lens = lc.lengths().to(torch.int64)
        start = s.data.to(torch.int64)
        count = n.data.to(torch.int64)
        zb = torch.where(start > 0, start - 1, lens + start)
        rows = lc.element_rows()
        within = lc.element_within(rows)
        zr = zb[rows]
        keep = (within >= zr) & (within < zr + count[rows]) & (zr >= 0)
        ok = s.validity & n.validity & (start != 0) & (count >= 0)
        return compact(lc, keep, lc.validity & ok)


class ArrayReverse(Expression):
    """reverse(array): the elements of each row in reverse order."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_element_type(self.children[0], schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        rows = lc.element_rows()
        within = lc.element_within(rows)
        lens = lc.lengths().to(torch.int64)
        src = lc.offsets[:-1].to(torch.int64)[rows] + lens[rows] - 1 - \
            within
        live = lc.element_live()
        return ListColumn(lc.offsets, lc.child.gather(src.clamp(min=0), live),
                          lc.validity, lc.element_type)


class ArrayRepeat(Expression):
    """array_repeat(v, n) with a literal count (a column count runs on
    the CPU engine: the planner's gate sends it there)."""

    def __init__(self, value: Expression, count: Expression):
        super().__init__(value, count)

    def _count(self):
        from .core import Literal
        c = self.children[1]
        return c.value if isinstance(c, Literal) else None

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(self.children[0].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        n = self._count()
        if n is None:
            raise cpu_fallback("array_repeat with a column count",
                               "nested gate")
        n = max(int(n), 0)
        v = self.children[0].eval(batch)
        live = batch.live_mask()
        lens = torch.where(live, n, 0)
        total = batch.num_rows * n
        cap = round_pow2(total)
        pos = torch.arange(cap, device=batch.device)
        child = v.gather(pos // max(n, 1), pos < total)
        return ListColumn(offsets_from_lengths(lens), child, live, v.dtype)


class Flatten(Expression):
    """flatten(array<array<T>>) -> array<T>: an offsets relabel and one
    range gather of the inner child; a null inner array nulls the row
    (Spark)."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not (isinstance(t, dt.ArrayType) and
                isinstance(t.element_type, dt.ArrayType)):
            raise TypeError(f"flatten of {t}")
        return t.element_type

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        outer = self.children[0].eval(batch)
        inner = outer.child
        has_null = seg_count(~inner.validity & outer.element_live(),
                             outer.offsets) > 0
        validity = outer.validity & ~has_null
        io = inner.offsets.to(torch.int64)
        o = outer.offsets.to(torch.int64)
        starts = io[o[:-1]]
        lens = torch.where(validity, io[o[1:]] - starts, 0)
        offsets = offsets_from_lengths(lens)
        total = int(offsets[-1])
        cap = round_pow2(total)
        pos = torch.arange(cap, device=outer.device)
        rows = rows_from_offsets(offsets[:-1], lens, cap)
        src = starts[rows] + pos - offsets[:-1].to(torch.int64)[rows]
        return ListColumn(offsets, inner.child.gather(src, pos < total),
                          validity, inner.element_type)


class ArraysZip(Expression):
    """arrays_zip(a, b, ...) -> array<struct<0, 1, ...>>: each row as
    long as its longest input; a shorter input's missing fields are
    null; any null input nulls the row (Spark)."""

    def __init__(self, *children: Expression):
        super().__init__(*children)

    def data_type(self, schema: Schema) -> dt.DType:
        fields = []
        for i, c in enumerate(self.children):
            t = c.data_type(schema)
            if not isinstance(t, dt.ArrayType):
                raise TypeError(f"arrays_zip of {t}")
            fields.append((str(i), t.element_type))
        return dt.ArrayType(dt.StructType(tuple(fields)))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lists = [c.eval(batch) for c in self.children]
        validity = batch.live_mask()
        for lc in lists:
            validity = validity & lc.validity
        lens = torch.zeros(batch.capacity, dtype=torch.int64,
                           device=batch.device)
        for lc in lists:
            lens = torch.maximum(lens, lc.lengths().to(torch.int64))
        lens = torch.where(validity, lens, 0)
        offsets = offsets_from_lengths(lens)
        total = int(offsets[-1])
        cap = round_pow2(total)
        pos = torch.arange(cap, device=batch.device)
        rows = rows_from_offsets(offsets[:-1], lens, cap)
        within = pos - offsets[:-1].to(torch.int64)[rows]
        live = pos < total
        fields = []
        for lc in lists:
            in_range = live & (within < lc.lengths().to(torch.int64)[rows])
            src = lc.offsets[:-1].to(torch.int64)[rows] + within
            fields.append(lc.child.gather(src.clamp(min=0), in_range))
        st = self.data_type(batch.schema()).element_type
        return ListColumn(offsets, StructColumn(fields, live, st), validity,
                          st)


class ArrayJoin(Expression):
    """array_join(array<string>, sep[, null_replacement]): null elements
    skipped, or replaced when a replacement is given. One pass over the
    output bytes: each element's extent is its bytes then the separator
    (none after a row's last kept element)."""

    def __init__(self, child: Expression, sep: str,
                 null_replacement: Optional[str] = None):
        super().__init__(child)
        self.sep = sep
        self.null_replacement = null_replacement

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not (isinstance(t, dt.ArrayType) and
                t.element_type == dt.STRING):
            raise TypeError(f"array_join of {t}")
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        lc = self.children[0].eval(batch)
        sc: StringColumn = lc.child
        dev = lc.device
        sep = torch.tensor(list(self.sep.encode()), dtype=torch.uint8,
                           device=dev)
        repl = None if self.null_replacement is None else torch.tensor(
            list(self.null_replacement.encode()), dtype=torch.uint8,
            device=dev)
        live = lc.element_live()
        e_valid = sc.validity & live
        kept = live if repl is not None else e_valid
        slen = sc.lengths().to(torch.int64)
        body = torch.where(e_valid, slen,
                           repl.shape[0] if repl is not None else 0)
        body = torch.where(kept, body, 0)
        rows = lc.element_rows()
        # kept elements after this one in its row: a separator follows
        pref = torch.zeros(kept.shape[0] + 1, dtype=torch.int64,
                           device=dev)
        pref[1:] = torch.cumsum(kept.to(torch.int64), 0)
        o = lc.offsets.to(torch.int64)
        after = pref[o[1:]][rows] - pref[1:]
        ext = torch.where(kept, body + torch.where(after > 0,
                                                   sep.shape[0], 0), 0)
        e_off = torch.zeros(ext.shape[0] + 1, dtype=torch.int64, device=dev)
        e_off[1:] = torch.cumsum(ext, 0)
        out_offsets = e_off[o].to(torch.int32)
        total = int(e_off[-1])
        nbytes = max(-(-total // 128) * 128, 128)
        chars = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        if total:
            b = torch.arange(total, device=dev)
            e = rows_from_offsets(e_off[:-1], ext, total)
            w = b - e_off[e]
            in_body = w < body[e]
            src = (sc.offsets[:-1].to(torch.int64)[e] + w).clamp(
                0, sc.char_capacity - 1)
            byte = sc.chars[src]
            if repl is not None and repl.shape[0]:
                byte = torch.where(e_valid[e], byte,
                                   repl[w.clamp(0, repl.shape[0] - 1)])
            if sep.shape[0]:
                sb = sep[(w - body[e]).clamp(0, sep.shape[0] - 1)]
                byte = torch.where(in_body, byte, sb)
            chars[:total] = byte
        lens = out_offsets[1:] - out_offsets[:-1]
        longest = int(lens.max()) if lens.numel() else 0
        return StringColumn(out_offsets, chars, lc.validity,
                            pad_bucket=round_pow2(longest))


class ZipWith(Expression):
    """zip_with(a, b, (x, y) -> f): the lambda over the two rows'
    elements side by side, each row as long as its longer input (the
    shorter side's missing elements bind as null)."""

    def __init__(self, left: Expression, right: Expression, x_var, y_var,
                 body: Expression):
        super().__init__(left, right, body)
        self.x_var = x_var
        self.y_var = y_var
        self.lambda_vars = (x_var, y_var)

    def references(self) -> set:
        refs = set()
        for c in self.children:
            refs |= c.references()
        return refs - {self.x_var.name, self.y_var.name}

    def data_type(self, schema: Schema) -> dt.DType:
        lt = self.children[0].data_type(schema)
        rt = self.children[1].data_type(schema)
        if not (isinstance(lt, dt.ArrayType) and
                isinstance(rt, dt.ArrayType)):
            raise TypeError("zip_with needs two arrays")
        self.x_var._dtype = lt.element_type
        self.y_var._dtype = rt.element_type
        return dt.ArrayType(self.children[2].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        from .higher_order import lambda_batch
        la = self.children[0].eval(batch)
        lb = self.children[1].eval(batch)
        self.data_type(batch.schema())
        validity = batch.live_mask() & la.validity & lb.validity
        lens = torch.where(validity, torch.maximum(la.lengths(),
                                                   lb.lengths()), 0)
        offsets = offsets_from_lengths(lens)
        total = int(offsets[-1])
        cap = round_pow2(total)
        pos = torch.arange(cap, device=batch.device)
        rows = rows_from_offsets(offsets[:-1], lens, cap)
        within = pos - offsets[:-1].to(torch.int64)[rows]
        live = pos < total

        def side(lc):
            ok = live & (within < lc.lengths().to(torch.int64)[rows])
            src = lc.offsets[:-1].to(torch.int64)[rows] + within
            return lc.child.gather(src.clamp(min=0), ok)
        lanes = lambda_batch(batch, {self.x_var.name: side(la),
                                     self.y_var.name: side(lb)},
                             rows, total, self.children[2],
                             self.lambda_vars)
        out = self.children[2].eval(lanes)
        return ListColumn(offsets, out, validity, out.dtype)


class MapConcat(Expression):
    """map_concat(m1, m2, ...): runs on the CPU engine (the planner's
    gate sends it there, as the JAX planner does)."""

    def __init__(self, *children: Expression):
        super().__init__(*children)

    def data_type(self, schema: Schema) -> dt.DType:
        ts_ = [c.data_type(schema) for c in self.children]
        for t in ts_:
            if not isinstance(t, dt.MapType):
                raise TypeError(f"map_concat of {t}")
        return ts_[0]

    def eval(self, batch: ColumnarBatch):
        raise cpu_fallback("map_concat", "nested gate")


def zip_with(a, b, fn):
    from .core import _lit
    from .higher_order import LambdaVariable
    x, y = LambdaVariable(), LambdaVariable()
    return ZipWith(_lit(a), _lit(b), x, y, _lit(fn(x, y)))


class CreateNamedStruct(Expression):
    """named_struct(n1, v1, ...): never null itself."""

    def __init__(self, names: Sequence[str], values: Sequence[Expression]):
        super().__init__(*values)
        self.names = list(names)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.StructType(tuple(
            (n, v.data_type(schema))
            for n, v in zip(self.names, self.children)))

    def eval(self, batch: ColumnarBatch) -> StructColumn:
        kids = [c.eval(batch) for c in self.children]
        st = dt.StructType(tuple((n, k.dtype)
                                 for n, k in zip(self.names, kids)))
        return StructColumn(kids, batch.live_mask(), st)

    def __repr__(self):
        inner = ", ".join(f"{n}={v!r}"
                          for n, v in zip(self.names, self.children))
        return f"named_struct({inner})"


class GetStructField(Expression):
    """struct.field; a null struct -> null."""

    def __init__(self, child: Expression, field: str):
        super().__init__(child)
        self.field = field

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not isinstance(t, dt.StructType):
            raise TypeError(f"field access on {t}")
        for n, ft in t.fields:
            if n == self.field:
                return ft
        raise KeyError(self.field)

    def eval(self, batch: ColumnarBatch):
        sc: StructColumn = self.children[0].eval(batch)
        child = sc.field(self.field)
        v = child.validity & sc.validity
        if isinstance(child, ColumnVector):
            return make_result(child.data, v, child.dtype)
        # a gather under the combined validity keeps the zero-length
        # extents of null rows
        return child.gather(torch.arange(child.capacity, device=v.device),
                            v)

    def __repr__(self):
        return f"{self.children[0]!r}.{self.field}"


class Explode(Expression):
    """Marker generator: one output row per array element. Never
    evaluated row-wise: the session pulls it out of a projection into a
    Generate node (plan/logical.py, exec/generate.py)."""

    def __init__(self, child: Expression, outer: bool = False,
                 with_position: bool = False):
        super().__init__(child)
        self.outer = outer
        self.with_position = with_position

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if isinstance(t, dt.MapType):
            # Spark gives a key and a value column; the port's Generate
            # has one element column (the JAX CPU engine explodes a map
            # into its keys alone)
            raise NotImplementedError(f"explode of {t} is not in this "
                                      "port yet")
        return _element_type(self.children[0], schema)

    def eval(self, batch: ColumnarBatch):
        raise RuntimeError("Explode must be planned as Generate, not "
                           "evaluated as a row expression")

    def __repr__(self):
        kind = "posexplode" if self.with_position else "explode"
        return f"{kind}{'_outer' if self.outer else ''}" \
            f"({self.children[0]!r})"


def explode(e) -> Explode:
    from .core import _lit
    return Explode(_lit(e))


def explode_outer(e) -> Explode:
    from .core import _lit
    return Explode(_lit(e), outer=True)


def posexplode(e) -> Explode:
    from .core import _lit
    return Explode(_lit(e), with_position=True)


def array(*exprs) -> CreateArray:
    from .core import _lit
    return CreateArray(*[_lit(e) for e in exprs])


def struct(**kw) -> CreateNamedStruct:
    from .core import _lit
    return CreateNamedStruct(list(kw), [_lit(v) for v in kw.values()])
