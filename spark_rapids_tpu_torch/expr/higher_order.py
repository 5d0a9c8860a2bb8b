"""Higher-order functions (lambdas over arrays and maps) and the map
expressions.

Counterpart of spark_rapids_tpu/expr/higher_order.py. A lambda body is
an ordinary Expression evaluated once over a batch of elements: the
lambda variables are bound to the list's flat child (one row per
element), and every outer column the body reads is gathered by each
element's row (``rows_from_offsets``). The JAX package binds over its
padded ``(capacity, pad_bucket)`` lanes instead (JAX :117-165); here the
batch has exactly as many live rows as there are elements.
``aggregate`` is a left fold: it steps by element position over the
rows still holding an element there, so a float accumulator adds in
element order, bit for bit the JAX package's scan on the CPU.

Maps are ``list<struct<key,value>>`` (columnar/nested.py), so every map
function works on the key and value children.

Null semantics follow Spark:
- transform of a null array -> null; the lambda sees null elements,
- exists: true if any true, else null if any null, else false
  (three-valued); forall: false if any false, else null if any null,
  else true,
- filter drops the elements whose predicate is null or false,
- aggregate threads nulls through the merge lambda,
- element_at(map, k) of a missing key -> null,
- map_from_arrays, map() and transform_keys raise on a null key, on
  duplicate keys (spark.sql.mapKeyDedupPolicy=EXCEPTION, Spark's
  default) and on key and value arrays of different lengths.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.nested import (ListColumn, StructColumn, compact,
                               seg_count, seg_first)
from ..columnar.vector import Column, ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result

_VAR_IDS = itertools.count()

#: launches of the merge body by ``aggregate``'s fold since the last
#: reset: one per element position of the longest list
FOLD_STEPS = {"steps": 0}


class LambdaVariable(Expression):
    """A named lambda parameter. Its type is bound by the enclosing
    higher-order function when that function is typed; eval reads the
    element batch."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or f"lambda_x#{next(_VAR_IDS)}"
        self._dtype: Optional[dt.DType] = None

    def data_type(self, schema: Schema) -> dt.DType:
        if self._dtype is None:
            raise TypeError(f"unbound lambda variable {self.name} (typed "
                            "outside its higher-order function?)")
        return self._dtype

    def references(self) -> set:
        return set()  # bound, not free: never read from the input

    def eval(self, batch: ColumnarBatch) -> Column:
        return batch.column(self.name)

    def __repr__(self):
        return self.name


def outer_refs(body: Expression, vars_: Sequence[LambdaVariable]) -> set:
    """Names of the input columns a lambda body reads."""
    from .core import ColumnRef
    bound = {v.name for v in vars_}
    refs = set()

    def walk(e: Expression):
        if isinstance(e, LambdaVariable):
            return
        if isinstance(e, ColumnRef):
            refs.add(e.name)
        for c in e.children:
            walk(c)
    walk(body)
    return refs - bound


def lambda_batch(batch: ColumnarBatch, bindings: Dict[str, Column],
                 rows: torch.Tensor, total: int, bodies,
                 lambda_vars: Sequence[LambdaVariable]) -> ColumnarBatch:
    """The element batch a lambda body evaluates over: ``total`` live
    rows, the lambda variables' columns, and each outer column the
    bodies read gathered by element row."""
    if isinstance(bodies, Expression):
        bodies = (bodies,)
    names, cols = list(bindings), list(bindings.values())
    outer = set()
    for body in bodies:
        outer |= outer_refs(body, lambda_vars)
    if outer:
        live = torch.arange(rows.shape[0], device=rows.device) < total
        for name in batch.names:
            if name in outer and name not in names:
                names.append(name)
                cols.append(batch.column(name).gather(rows, live))
    return ColumnarBatch(cols, names, total, batch.device)


class HigherOrderFunction(Expression):
    """Common machinery: typing of the input and the element batch."""

    #: the lambda variables, in binding order
    lambda_vars: Sequence[LambdaVariable] = ()

    def references(self) -> set:
        refs = set()
        for c in self.children:
            refs |= c.references()
        return refs - {v.name for v in self.lambda_vars}

    def _array_type(self, schema: Schema) -> dt.ArrayType:
        t = self.children[0].data_type(schema)
        if isinstance(t, dt.MapType):
            return dt.ArrayType(t.element_type)
        if not isinstance(t, dt.ArrayType):
            raise TypeError(f"{type(self).__name__} expects an array, "
                            f"got {t}")
        return t

    def bodies(self) -> Sequence[Expression]:
        return (self.children[1],)

    def _element_batch(self, batch: ColumnarBatch, lc: ListColumn,
                       bindings: Dict[str, Column]) -> ColumnarBatch:
        return lambda_batch(batch, bindings, lc.element_rows(), lc.total(),
                            self.bodies(), self.lambda_vars)


class ArrayTransform(HigherOrderFunction):
    """transform(arr, x -> body) / transform(arr, (x, i) -> body)."""

    def __init__(self, child: Expression, var: LambdaVariable,
                 body: Expression,
                 idx_var: Optional[LambdaVariable] = None):
        super().__init__(child, body)
        self.var = var
        self.idx_var = idx_var
        self.lambda_vars = (var,) + ((idx_var,) if idx_var else ())

    def data_type(self, schema: Schema) -> dt.DType:
        at = self._array_type(schema)
        self.var._dtype = at.element_type
        if self.idx_var:
            self.idx_var._dtype = dt.INT32
        return dt.ArrayType(self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        self.data_type(batch.schema())
        bind = {self.var.name: lc.child}
        if self.idx_var is not None:
            rows = lc.element_rows()
            bind[self.idx_var.name] = ColumnVector(
                lc.element_within(rows).to(torch.int32),
                lc.element_live(), dt.INT32)
        out = self.children[1].eval(self._element_batch(batch, lc, bind))
        return ListColumn(lc.offsets, out, lc.validity, out.dtype)

    def __repr__(self):
        v = f"({self.var!r}, {self.idx_var!r})" if self.idx_var \
            else repr(self.var)
        return f"transform({self.children[0]!r}, {v} -> " \
               f"{self.children[1]!r})"


class ArrayExists(HigherOrderFunction):
    """exists(arr, x -> pred) with Spark's three-valued logic: true if
    any element satisfies, else null if any predicate was null, else
    false."""

    def __init__(self, child: Expression, var: LambdaVariable,
                 body: Expression):
        super().__init__(child, body)
        self.var = var
        self.lambda_vars = (var,)

    def data_type(self, schema: Schema) -> dt.DType:
        self.var._dtype = self._array_type(schema).element_type
        self.children[1].data_type(schema)
        return dt.BOOL

    def _predicate(self, batch: ColumnarBatch):
        lc = self.children[0].eval(batch)
        self.data_type(batch.schema())
        out = self.children[1].eval(
            self._element_batch(batch, lc, {self.var.name: lc.child}))
        live = lc.element_live()
        return lc, out.data & out.validity & live, \
            ~out.data & out.validity & live, ~out.validity & live

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc, true, _, null = self._predicate(batch)
        any_true = seg_count(true, lc.offsets) > 0
        any_null = seg_count(null, lc.offsets) > 0
        return make_result(any_true, lc.validity & (any_true | ~any_null),
                           dt.BOOL)


class ArrayForAll(ArrayExists):
    """forall(arr, x -> pred): false if any false, else null if any
    null, else true."""

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc, _, false, null = self._predicate(batch)
        any_false = seg_count(false, lc.offsets) > 0
        any_null = seg_count(null, lc.offsets) > 0
        return make_result(~any_false,
                           lc.validity & (any_false | ~any_null), dt.BOOL)


class ArrayFilter(HigherOrderFunction):
    """filter(arr, x -> pred): the elements whose predicate is true."""

    def __init__(self, child: Expression, var: LambdaVariable,
                 body: Expression):
        super().__init__(child, body)
        self.var = var
        self.lambda_vars = (var,)

    def data_type(self, schema: Schema) -> dt.DType:
        at = self._array_type(schema)
        self.var._dtype = at.element_type
        self.children[1].data_type(schema)
        return at

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        self.data_type(batch.schema())
        out = self.children[1].eval(
            self._element_batch(batch, lc, {self.var.name: lc.child}))
        return compact(lc, out.data & out.validity)


class ArrayAggregate(HigherOrderFunction):
    """aggregate(arr, zero, (acc, x) -> merge[, acc -> finish]): a left
    fold. Step k folds the k-th element of every row that has one; the
    rows are ordered by length once, so step k's rows are a prefix of
    that order. The merge body launches once a step: as many steps as
    the longest list (``FOLD_STEPS``)."""

    def __init__(self, child: Expression, zero: Expression,
                 acc_var: LambdaVariable, elem_var: LambdaVariable,
                 merge: Expression,
                 finish: Optional[Expression] = None):
        children = [child, zero, merge] + ([finish] if finish else [])
        super().__init__(*children)
        self.acc_var = acc_var
        self.elem_var = elem_var
        self.has_finish = finish is not None
        self.lambda_vars = (acc_var, elem_var)

    def data_type(self, schema: Schema) -> dt.DType:
        at = self._array_type(schema)
        self.elem_var._dtype = at.element_type
        self.acc_var._dtype = self.children[1].data_type(schema)
        merged = self.children[2].data_type(schema)
        if merged != self.acc_var._dtype:
            # the accumulator takes the merge body's type, as in the JAX
            # package (an INT zero under acc + x * 0.5 folds in DOUBLE)
            self.acc_var._dtype = merged
        if self.has_finish:
            return self.children[3].data_type(schema)
        return merged

    def bodies(self) -> Sequence[Expression]:
        return tuple(self.children[2:])

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .cast import cast_column
        lc = self.children[0].eval(batch)
        self.data_type(batch.schema())
        acc_t = self.acc_var._dtype
        zero = self.children[1].eval(batch)
        if zero.dtype != acc_t:
            zero = cast_column(zero, acc_t)
        acc_data, acc_ok = zero.data.clone(), zero.validity.clone()
        merge = self.children[2]
        dev = lc.device
        lens = torch.where(lc.validity, lc.lengths(), 0).to(torch.int64)
        order = torch.sort(lens, descending=True, stable=True).indices
        sorted_lens = lens[order]
        longest = int(sorted_lens[0]) if lens.numel() else 0
        # rows with more than k elements: counts[k], read once
        hist = torch.bincount(lens, minlength=longest + 1)
        counts = (lens.numel() - torch.cumsum(hist, 0))[:longest].tolist()
        starts = lc.offsets[:-1].to(torch.int64)
        names = [self.acc_var.name, self.elem_var.name]
        for k, m in enumerate(counts):
            rows = order[:m]
            x = lc.child.gather(starts[rows] + k)
            acc = ColumnVector(acc_data[rows], acc_ok[rows], acc_t)
            out = merge.eval(ColumnarBatch([acc, x], names, m, dev))
            acc_data[rows] = out.data.to(acc_data.dtype)
            acc_ok[rows] = out.validity
            FOLD_STEPS["steps"] += 1
        result = make_result(acc_data, acc_ok & lc.validity, acc_t)
        if self.has_finish:
            out = self.children[3].eval(ColumnarBatch(
                [result], [self.acc_var.name], batch.num_rows, dev))
            return make_result(out.data, out.validity & lc.validity,
                               out.dtype)
        return result


# ---------------------------------------------------------------------------
# maps (list<struct<key,value>>)
# ---------------------------------------------------------------------------


def _map_type(expr: Expression, schema: Schema) -> dt.MapType:
    t = expr.data_type(schema)
    if not isinstance(t, dt.MapType):
        raise TypeError(f"expected map input, got {t}")
    return t


def _keys(lc: ListColumn) -> ListColumn:
    return ListColumn(lc.offsets, lc.child.field("key"), lc.validity,
                      lc.child.dtype.fields[0][1])


def _values(lc: ListColumn) -> ListColumn:
    return ListColumn(lc.offsets, lc.child.field("value"), lc.validity,
                      lc.child.dtype.fields[1][1])


def _make_map(offsets: torch.Tensor, keys: Column, values: Column,
              validity: torch.Tensor, live: torch.Tensor) -> ListColumn:
    mt = dt.MapType(keys.dtype, values.dtype)
    return ListColumn(offsets, StructColumn([keys, values], live,
                                            mt.element_type),
                      validity, mt.element_type, mt)


def check_map_keys(lc: ListColumn, what: str) -> None:
    """Spark's map key rules: no null key, no key twice in a map
    (spark.sql.mapKeyDedupPolicy=EXCEPTION, the default)."""
    from .collections import _primitive_child, first_occurrence
    keys = _keys(lc)
    child = _primitive_child(keys, what)
    live = keys.element_live()
    if bool((~child.validity & live).any()):
        raise ValueError(f"{what}: cannot use null as map key")
    if bool((live & ~first_occurrence(keys, child)).any()):
        raise ValueError(f"{what}: duplicate map key (Spark's "
                         "spark.sql.mapKeyDedupPolicy=EXCEPTION)")


class MapKeys(Expression):
    """map_keys(m)."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_map_type(self.children[0], schema).key_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        return _keys(self.children[0].eval(batch))


class MapValues(Expression):
    """map_values(m)."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_map_type(self.children[0], schema).value_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        return _values(self.children[0].eval(batch))


class MapEntries(Expression):
    """map_entries(m) -> array<struct<key,value>>: the physical layout
    under an array type."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(_map_type(self.children[0], schema)
                            .element_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc = self.children[0].eval(batch)
        return ListColumn(lc.offsets, lc.child, lc.validity,
                          lc.child.dtype)


def _key_hits(lc: ListColumn, needle: ColumnVector, what: str):
    from .collections import _primitive_child, values_equal
    keys = _primitive_child(_keys(lc), what)
    rows = lc.element_rows()
    hit = keys.validity & lc.element_live() & \
        values_equal(keys.data, needle.data[rows])
    return hit, rows


class GetMapValue(Expression):
    """m[key] / element_at(m, key): the value of the matching key, null
    if absent."""

    def __init__(self, child: Expression, key: Expression):
        super().__init__(child, key)

    def data_type(self, schema: Schema) -> dt.DType:
        return _map_type(self.children[0], schema).value_type

    def eval(self, batch: ColumnarBatch):
        lc = self.children[0].eval(batch)
        needle = self.children[1].eval(batch)
        hit, rows = _key_hits(lc, needle, "element_at on a map")
        first = seg_first(hit, rows, lc.capacity)
        ok = lc.validity & needle.validity & (first >= 0)
        return lc.child.field("value").gather(first.clamp(min=0), ok)


class MapContainsKey(Expression):
    """map_contains_key(m, k)."""

    def __init__(self, child: Expression, key: Expression):
        super().__init__(child, key)

    def data_type(self, schema: Schema) -> dt.DType:
        _map_type(self.children[0], schema)
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        needle = self.children[1].eval(batch)
        hit, _ = _key_hits(lc, needle, "map_contains_key")
        return make_result(seg_count(hit, lc.offsets) > 0,
                           lc.validity & needle.validity, dt.BOOL)


class _MapLambda(HigherOrderFunction):
    """A lambda over a map's (key, value) entries."""

    def __init__(self, child: Expression, key_var: LambdaVariable,
                 val_var: LambdaVariable, body: Expression):
        super().__init__(child, body)
        self.key_var = key_var
        self.val_var = val_var
        self.lambda_vars = (key_var, val_var)

    def _bind(self, schema: Schema) -> dt.MapType:
        mt = _map_type(self.children[0], schema)
        self.key_var._dtype = mt.key_type
        self.val_var._dtype = mt.value_type
        return mt

    def _eval_body(self, batch: ColumnarBatch):
        lc = self.children[0].eval(batch)
        self.data_type(batch.schema())
        out = self.children[1].eval(self._element_batch(
            batch, lc, {self.key_var.name: lc.child.field("key"),
                        self.val_var.name: lc.child.field("value")}))
        return lc, out


class TransformValues(_MapLambda):
    """transform_values(m, (k, v) -> body): keys kept, values mapped."""

    def data_type(self, schema: Schema) -> dt.DType:
        mt = self._bind(schema)
        return dt.MapType(mt.key_type, self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc, out = self._eval_body(batch)
        return _make_map(lc.offsets, lc.child.field("key"), out,
                         lc.validity, lc.element_live())


class TransformKeys(_MapLambda):
    """transform_keys(m, (k, v) -> body): values kept, keys mapped; a
    null or repeated new key raises (Spark)."""

    def data_type(self, schema: Schema) -> dt.DType:
        mt = self._bind(schema)
        return dt.MapType(self.children[1].data_type(schema),
                          mt.value_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc, out = self._eval_body(batch)
        m = _make_map(lc.offsets, out, lc.child.field("value"),
                      lc.validity, lc.element_live())
        check_map_keys(m, "transform_keys")
        return m


class MapFilter(_MapLambda):
    """map_filter(m, (k, v) -> pred)."""

    def data_type(self, schema: Schema) -> dt.DType:
        mt = self._bind(schema)
        self.children[1].data_type(schema)
        return mt

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        lc, out = self._eval_body(batch)
        return compact(lc, out.data & out.validity)


class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...)."""

    def __init__(self, *children: Expression):
        if not children or len(children) % 2:
            raise ValueError("map() needs key / value pairs")
        super().__init__(*children)

    def data_type(self, schema: Schema) -> dt.DType:
        from .collections import CreateArray
        kt = CreateArray(*self.children[0::2]).data_type(schema)
        vt = CreateArray(*self.children[1::2]).data_type(schema)
        return dt.MapType(kt.element_type, vt.element_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        from .collections import CreateArray
        keys = CreateArray(*self.children[0::2]).eval(batch)
        vals = CreateArray(*self.children[1::2]).eval(batch)
        m = _make_map(keys.offsets, keys.child, vals.child, keys.validity,
                      keys.element_live())
        check_map_keys(m, "map()")
        return m


class MapFromArrays(Expression):
    """map_from_arrays(keys, values): key i pairs with value i. Arrays
    of different lengths raise, as in Spark (the JAX package nulls the
    row)."""

    def __init__(self, keys: Expression, values: Expression):
        super().__init__(keys, values)

    def data_type(self, schema: Schema) -> dt.DType:
        kt = self.children[0].data_type(schema)
        vt = self.children[1].data_type(schema)
        if not (isinstance(kt, dt.ArrayType) and
                isinstance(vt, dt.ArrayType)):
            raise TypeError("map_from_arrays needs two arrays")
        return dt.MapType(kt.element_type, vt.element_type)

    def eval(self, batch: ColumnarBatch) -> ListColumn:
        keys = self.children[0].eval(batch)
        vals = self.children[1].eval(batch)
        validity = keys.validity & vals.validity
        if bool((validity & (keys.lengths() != vals.lengths())).any()):
            raise ValueError("map_from_arrays: the key and value arrays "
                             "of a row differ in length")
        if not bool((keys.validity == validity).all()):
            keys = keys.gather(torch.arange(keys.capacity,
                                            device=keys.device), validity)
        if not bool((vals.validity == validity).all()) or \
                not torch.equal(vals.offsets, keys.offsets):
            vals = vals.gather(torch.arange(vals.capacity,
                                            device=vals.device), validity)
        m = _make_map(keys.offsets, keys.child, vals.child, validity,
                      keys.element_live())
        check_map_keys(m, "map_from_arrays")
        return m


# ---------------------------------------------------------------------------
# the DataFrame-side lambda API
# ---------------------------------------------------------------------------


def _one_arg(fn: Callable):
    v = LambdaVariable()
    return v, fn(v)


def transform(arr, fn: Callable) -> ArrayTransform:
    """transform(col, x -> expr), or (x, i) -> expr by arity."""
    import inspect
    from .core import _lit
    if len(inspect.signature(fn).parameters) == 2:
        x, i = LambdaVariable(), LambdaVariable()
        return ArrayTransform(_lit(arr), x, _lit(fn(x, i)), idx_var=i)
    x, body = _one_arg(fn)
    return ArrayTransform(_lit(arr), x, _lit(body))


def exists(arr, fn: Callable) -> ArrayExists:
    from .core import _lit
    x, body = _one_arg(fn)
    return ArrayExists(_lit(arr), x, _lit(body))


def forall(arr, fn: Callable) -> ArrayForAll:
    from .core import _lit
    x, body = _one_arg(fn)
    return ArrayForAll(_lit(arr), x, _lit(body))


def filter_(arr, fn: Callable) -> ArrayFilter:
    from .core import _lit
    x, body = _one_arg(fn)
    return ArrayFilter(_lit(arr), x, _lit(body))


def aggregate(arr, zero, merge: Callable,
              finish: Optional[Callable] = None) -> ArrayAggregate:
    from .core import _lit
    acc, x = LambdaVariable(), LambdaVariable()
    fin = None if finish is None else _lit(finish(acc))
    return ArrayAggregate(_lit(arr), _lit(zero), acc, x,
                          _lit(merge(acc, x)), fin)


def map_keys(m) -> MapKeys:
    from .core import _lit
    return MapKeys(_lit(m))


def map_values(m) -> MapValues:
    from .core import _lit
    return MapValues(_lit(m))


def map_entries(m) -> MapEntries:
    from .core import _lit
    return MapEntries(_lit(m))


def map_contains_key(m, k) -> MapContainsKey:
    from .core import _lit
    return MapContainsKey(_lit(m), _lit(k))


def get_map_value(m, k) -> GetMapValue:
    from .core import _lit
    return GetMapValue(_lit(m), _lit(k))


def transform_values(m, fn: Callable) -> TransformValues:
    from .core import _lit
    k, v = LambdaVariable(), LambdaVariable()
    return TransformValues(_lit(m), k, v, _lit(fn(k, v)))


def transform_keys(m, fn: Callable) -> TransformKeys:
    from .core import _lit
    k, v = LambdaVariable(), LambdaVariable()
    return TransformKeys(_lit(m), k, v, _lit(fn(k, v)))


def map_filter(m, fn: Callable) -> MapFilter:
    from .core import _lit
    k, v = LambdaVariable(), LambdaVariable()
    return MapFilter(_lit(m), k, v, _lit(fn(k, v)))


def create_map(*kv) -> CreateMap:
    from .core import _lit
    return CreateMap(*[_lit(e) for e in kv])


def map_from_arrays(keys, values) -> MapFromArrays:
    from .core import _lit
    return MapFromArrays(_lit(keys), _lit(values))
