"""Window expressions: specs, frames, ranking and aggregate functions.

Counterpart of spark_rapids_tpu/expr/window.py, copied (its body uses no
JAX) with its imports re-pointed at this port. Window functions are
declared here; the execs (exec/window.py) sort by (partition, order)
keys and lower every function to segmented scans and gathers over the
sorted batch.

Frame model (Spark): ROWS BETWEEN <lo> AND <hi> where lo/hi are
UNBOUNDED (None) or integer offsets relative to the current row
(negative = preceding); RANGE frames take value offsets of the single
order key. With an ORDER BY and no frame an aggregate gets RANGE
UNBOUNDED PRECEDING..CURRENT ROW (peers share their run's value),
without an ORDER BY the whole partition.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from .aggregates import AggregateFunction
from .core import Expression, Schema

UNBOUNDED = None
CURRENT_ROW = 0


class WindowFrame:
    """(lo, hi) row offsets; None = unbounded on that side."""

    def __init__(self, lo=UNBOUNDED, hi=CURRENT_ROW, row_based: bool = True):
        self.lo = lo
        self.hi = hi
        self.row_based = row_based

    @property
    def is_running(self) -> bool:
        return self.lo is UNBOUNDED and self.hi == 0

    @property
    def is_unbounded(self) -> bool:
        return self.lo is UNBOUNDED and self.hi is UNBOUNDED

    def __repr__(self):
        def b(v, side):
            if v is None:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
        kind = "ROWS" if self.row_based else "RANGE"
        return f"{kind} BETWEEN {b(self.lo, 'PRECEDING')} AND " \
               f"{b(self.hi, 'FOLLOWING')}"


RUNNING = WindowFrame(UNBOUNDED, CURRENT_ROW)
WHOLE_PARTITION = WindowFrame(UNBOUNDED, UNBOUNDED)


class WindowSpec:
    """PARTITION BY ... ORDER BY ... frame. ``order_fields`` holds the
    SortFields; ``order_by(...)`` is the builder method."""

    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_fields: Sequence = (),
                 frame: Optional[WindowFrame] = None):
        from ..plan.logical import SortField
        self.partition_by = list(partition_by)
        self.order_fields = [o if isinstance(o, SortField) else SortField(o)
                             for o in order_fields]
        self.frame = frame

    def order_by(self, *cols) -> "WindowSpec":
        from ..plan.logical import SortField
        from .core import col as colref
        fields = []
        for c in cols:
            if isinstance(c, SortField):
                fields.append(c)
            elif isinstance(c, str):
                fields.append(SortField(colref(c)))
            else:
                fields.append(SortField(c))
        return WindowSpec(self.partition_by, fields, self.frame)

    def with_frame(self, frame: WindowFrame) -> "WindowSpec":
        return WindowSpec(self.partition_by, self.order_fields, frame)


class Window:
    """Spec builder: Window.partition_by(...).order_by(...)."""

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        from .core import col as colref
        exprs = [colref(c) if isinstance(c, str) else c for c in cols]
        return WindowSpec(exprs)


class WindowFunction(Expression):
    """Base for ranking/offset functions (frames do not apply)."""

    needs_order = True

    def data_type(self, schema: Schema) -> dt.DType:
        raise NotImplementedError

    def over(self, spec: WindowSpec) -> "WindowExpression":
        return WindowExpression(self, spec)


class RowNumber(WindowFunction):
    name = "row_number"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32


class Rank(WindowFunction):
    name = "rank"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32


class DenseRank(WindowFunction):
    name = "dense_rank"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32


class PercentRank(WindowFunction):
    name = "percent_rank"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.FLOAT64


class NTile(WindowFunction):
    name = "ntile"

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32


class Lead(WindowFunction):
    """lead(x, k): value k rows after, null past the partition edge."""

    name = "lead"

    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__(child)
        self.offset = offset
        self.default = default

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)


class Lag(Lead):
    name = "lag"

    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__(child, offset, default)


class WindowExpression(Expression):
    """A window function (or aggregate) bound to a spec — the unit the
    Window logical node carries (Catalyst WindowExpression)."""

    def __init__(self, func: Expression, spec: WindowSpec):
        super().__init__()
        self.func = func
        self.spec = spec
        if isinstance(func, AggregateFunction) and spec.frame is None:
            # Spark default: with ORDER BY -> RANGE UNBOUNDED..CURRENT
            # (peers share their run's value); without -> whole partition
            self.spec = spec.with_frame(
                WindowFrame(UNBOUNDED, CURRENT_ROW, row_based=False)
                if spec.order_fields else WHOLE_PARTITION)
        elif spec.frame is None:
            self.spec = spec.with_frame(RUNNING)

    def data_type(self, schema: Schema) -> dt.DType:
        return self.func.data_type(schema)

    def references(self) -> set:
        refs = set()
        for e in self.func.children:
            refs |= e.references()
        for e in self.spec.partition_by:
            refs |= e.references()
        for o in self.spec.order_fields:
            refs |= o.expr.references()
        return refs

    def __repr__(self):
        return f"{type(self.func).__name__}().over(...)"
