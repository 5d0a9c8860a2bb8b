"""Logical plan nodes.

Counterpart of spark_rapids_tpu/plan/logical.py for the nodes the ported
queries build (q6/q1/q3, the NDS queries: joins of every type, set
operations, windows, grouping sets; explode as ``Generate``; ``Range``
and ``Sample``), plus ``DeviceRelation``: a leaf over batches already
on the device (the JAX package reaches the same leaf through
CachedRelation).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from ..expr.aggregates import AggregateFunction
from ..expr.core import Expression, output_name

Schema = List  # [(name, DType), ...]


class LogicalPlan:
    def __new__(cls, *args, **kwargs):
        node = super().__new__(cls)
        node._built_from = (args, kwargs)   # for with_children
        return node

    def __init__(self, *children: "LogicalPlan"):
        self.children: List[LogicalPlan] = list(children)

    def with_children(self, children) -> "LogicalPlan":
        """The node built again from its own arguments over other
        children, whose schemas may differ (every node takes its
        children first)."""
        args, kwargs = self._built_from
        return type(self)(*children, *args[len(self.children):], **kwargs)

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def expressions(self) -> List[Expression]:
        """The expressions this node holds (for tagging)."""
        return []

    def expressions_with_schemas(self):
        """[(expression, the schema it resolves against)]; a Join's
        condition resolves against both children."""
        schema = self.children[0].schema if self.children else self.schema
        return [(e, schema) for e in self.expressions()]

    def node_description(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + "* " + self.node_description()
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children])

    def __repr__(self):
        return self.tree_string()


class DeviceRelation(LogicalPlan):
    """Leaf over pre-built device batches."""

    def __init__(self, batches, schema: Schema):
        super().__init__()
        self.batches = list(batches)
        self._schema = list(schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def node_description(self) -> str:
        return (f"DeviceRelation[{', '.join(n for n, _ in self._schema)}; "
                f"{len(self.batches)} batches]")


class LocalRelation(LogicalPlan):
    """In-memory host data: {name: [Python values]} with its schema
    (JAX logical.py LocalRelation). The CPU engine reads it; on the
    device it enters through a HostToDevice seam."""

    def __init__(self, data: dict, schema: Schema):
        super().__init__()
        self.data = data
        self._schema = list(schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def node_description(self) -> str:
        return f"LocalRelation[{', '.join(n for n, _ in self._schema)}]"


class Range(LogicalPlan):
    """``id`` BIGINT from ``start`` to ``end`` (exclusive) by ``step``
    (Spark's Range; TpuSession.range)."""

    def __init__(self, start: int, end: int, step: int = 1):
        super().__init__()
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = start, end, step

    @property
    def num_rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    @property
    def schema(self) -> Schema:
        return [("id", dt.INT64)]

    def node_description(self) -> str:
        return f"Range[{self.start}, {self.end}, {self.step}]"


class Sample(LogicalPlan):
    """Bernoulli sample by a hash of each row's stream position
    (GpuSampleExec's role): the same rows on the device, on the CPU
    engine and in the JAX package, whatever the batch sizes."""

    def __init__(self, child: LogicalPlan, fraction: float, seed: int = 42):
        super().__init__(child)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("sample fraction must be in [0, 1]")
        self.fraction = fraction
        self.seed = seed

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def node_description(self) -> str:
        return f"Sample[{self.fraction}, seed={self.seed}]"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        super().__init__(child)
        self.exprs = list(exprs)
        self._schema = [(output_name(e, i), e.data_type(child.schema))
                        for i, e in enumerate(self.exprs)]

    @property
    def schema(self) -> Schema:
        return self._schema

    def expressions(self) -> List[Expression]:
        return list(self.exprs)

    def node_description(self) -> str:
        return f"Project[{', '.join(n for n, _ in self._schema)}]"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        super().__init__(child)
        self.condition = condition
        if condition.data_type(child.schema) != dt.BOOL:
            raise TypeError("filter condition must be boolean, got "
                            f"{condition.data_type(child.schema)}")

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def expressions(self) -> List[Expression]:
        return [self.condition]

    def node_description(self) -> str:
        return f"Filter[{self.condition!r}]"


class Aggregate(LogicalPlan):
    """groupBy(group_exprs).agg(agg_exprs); no group_exprs = global."""

    def __init__(self, child: LogicalPlan, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Tuple[AggregateFunction, str]]):
        super().__init__(child)
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        in_schema = child.schema
        self._schema = (
            [(output_name(e, i), e.data_type(in_schema))
             for i, e in enumerate(self.group_exprs)] +
            [(name, fn.data_type(in_schema)) for fn, name in self.agg_exprs])

    @property
    def schema(self) -> Schema:
        return self._schema

    def expressions(self) -> List[Expression]:
        return list(self.group_exprs) + [fn for fn, _ in self.agg_exprs]

    def node_description(self) -> str:
        keys = ", ".join(repr(e) for e in self.group_exprs)
        aggs = ", ".join(f"{fn.name}->{n}" for fn, n in self.agg_exprs)
        return f"Aggregate[keys=({keys}), aggs=({aggs})]"


class SortField:
    """(expr, ascending, nulls_first) at the logical level."""

    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        self.nulls_first = ascending if nulls_first is None else nulls_first

    def __repr__(self):
        return (f"{self.expr!r} {'ASC' if self.ascending else 'DESC'} "
                f"{'NULLS FIRST' if self.nulls_first else 'NULLS LAST'}")


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, order: Sequence[SortField]):
        super().__init__(child)
        self.order = list(order)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def expressions(self) -> List[Expression]:
        return [o.expr for o in self.order]

    def node_description(self) -> str:
        return f"Sort[{', '.join(repr(o) for o in self.order)}]"


class Join(LogicalPlan):
    """Equi-join on key expression pairs, with an optional residual
    condition; a ``cross`` join takes no keys."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        if len(self.left_keys) != len(self.right_keys):
            raise ValueError("left/right key counts differ")
        if join_type == "cross" and self.left_keys:
            raise ValueError("cross join takes no keys (use inner, or "
                             "cross_join with a condition)")

    @property
    def schema(self) -> Schema:
        if self.join_type in ("left_semi", "left_anti"):
            return self.children[0].schema
        # an outer join's null-supplied side keeps its types
        return self.children[0].schema + self.children[1].schema

    def expressions(self) -> List[Expression]:
        out = self.left_keys + self.right_keys
        if self.condition is not None:
            out.append(self.condition)
        return out

    def coerced_keys(self):
        """Each key pair at its common type (expr/conditional.py
        ``_common_type``) through a Cast, as Spark's analyzer meets
        them: murmur3 is width-sensitive, and a DECIMAL(18,0) and a
        DECIMAL(12,3) key compare as DECIMAL(21,3), not as their
        unscaled ints."""
        from ..expr.cast import Cast
        from ..expr.conditional import _common_type
        ls, rs = self.children[0].schema, self.children[1].schema
        lk, rk = [], []
        for l, r in zip(self.left_keys, self.right_keys):
            lt, rt = l.data_type(ls), r.data_type(rs)
            ct = lt if lt == rt else _common_type([lt, rt])
            lk.append(l if lt == ct else Cast(l, ct))
            rk.append(r if rt == ct else Cast(r, ct))
        return lk, rk

    def expressions_with_schemas(self):
        ls = self.children[0].schema
        rs = self.children[1].schema
        out = ([(e, ls) for e in self.left_keys] +
               [(e, rs) for e in self.right_keys])
        if self.condition is not None:
            out.append((self.condition, ls + rs))
        return out

    def node_description(self) -> str:
        keys = ", ".join(f"{l!r}={r!r}" for l, r in
                         zip(self.left_keys, self.right_keys))
        cond = f", cond={self.condition!r}" if self.condition is not None \
            else ""
        return f"Join[{self.join_type}, {keys}{cond}]"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        super().__init__(child)
        self.n = n

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def node_description(self) -> str:
        return f"Limit[{self.n}]"


class Window(LogicalPlan):
    """Append window-function columns; all entries share one
    (partition_by, order_by) spec (the DataFrame splits differing specs
    into a chain of Window nodes, like Spark's Window exec)."""

    def __init__(self, child: LogicalPlan, window_exprs):
        super().__init__(child)
        self.window_exprs = list(window_exprs)  # [(WindowExpression, name)]
        in_schema = child.schema
        self._schema = list(in_schema) + [
            (name, we.data_type(in_schema)) for we, name in self.window_exprs]

    @property
    def schema(self) -> Schema:
        return self._schema

    def expressions(self) -> List[Expression]:
        out = []
        for we, _ in self.window_exprs:
            out.extend(we.func.children)
            out.extend(we.spec.partition_by)
            out.extend(o.expr for o in we.spec.order_fields)
        return out

    def node_description(self) -> str:
        fns = ", ".join(f"{type(we.func).__name__}->{n}"
                        for we, n in self.window_exprs)
        return f"Window[{fns}]"


class Union(LogicalPlan):
    """UNION ALL of children with equal column counts, named as the
    first child. A column where a decimal meets another type takes
    Spark's widening (``DecimalPrecision.widerDecimalType``: the larger
    scale and the larger integral digits, at most 38; an integral meets
    as its exact decimal, a float makes it DOUBLE), and each child is
    cast to it before the union (the JAX package raises). Other columns
    keep the first child's type and are not cast, as in the JAX
    package; a string column facing a non-string one (which the JAX
    package passes on as a mixed column) is refused."""

    def __init__(self, *children: LogicalPlan):
        super().__init__(*children)
        from ..expr.arithmetic import _least_greatest_type
        first = children[0].schema
        self._schema = list(first)
        self._widened = set()
        for c in children[1:]:
            if len(c.schema) != len(first):
                raise ValueError("UNION children column counts differ")
            for i, ((name, a), (_, b)) in enumerate(zip(self._schema,
                                                        c.schema)):
                if (a == dt.STRING) != (b == dt.STRING):
                    raise NotImplementedError(
                        f"a UNION of {a} and {b} in column {name!r} is "
                        "not in this port yet")
                if a != b and dt.NULL not in (a, b) and (
                        dt.is_decimal(a) or dt.is_decimal(b)):
                    self._schema[i] = (name, _least_greatest_type([a, b]))
                    self._widened.add(i)

    @property
    def schema(self) -> Schema:
        return self._schema

    def child_casts(self, index: int):
        """The projection that brings child ``index`` to the union's
        types, or None where it has them."""
        from ..expr.cast import Cast
        from ..expr.core import Alias, col
        child = self.children[index].schema
        cast = [i for i in self._widened if child[i][1] != self._schema[i][1]]
        if not cast:
            return None
        return [Alias(Cast(col(n), self._schema[i][1]), n) if i in cast
                else col(n) for i, (n, _) in enumerate(child)]


class Expand(LogicalPlan):
    """GROUPING SETS / ROLLUP / CUBE pre-projection: every input row once
    per projection list; each output column takes the common type of
    its slot across the lists."""

    def __init__(self, child: LogicalPlan,
                 projections: Sequence[Sequence[Expression]],
                 names: Sequence[str]):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        in_schema = child.schema
        from ..expr.conditional import _common_type
        self._schema = [
            (n, _common_type([p[i].data_type(in_schema)
                              for p in self.projections]))
            for i, n in enumerate(names)]

    @property
    def schema(self) -> Schema:
        return self._schema

    def node_description(self) -> str:
        return f"Expand[{len(self.projections)} projections]"

    def expressions(self) -> List[Expression]:
        return [e for p in self.projections for e in p]


class Generate(LogicalPlan):
    """explode / explode_outer / posexplode (JAX logical.py:323): the
    child's columns (+ the position) + the element column, one row per
    list element. A map gives two element columns, its entry's key
    (``element_name``) and value (``value_name``, the element name with
    ``_value``), as Spark's ``key`` and ``value``."""

    def __init__(self, child: LogicalPlan, generator, element_name: str,
                 pos_name: Optional[str] = None):
        super().__init__(child)
        from ..expr.collections import Explode
        if not isinstance(generator, Explode):
            raise TypeError(f"Generate needs an Explode, got {generator!r}")
        self.generator = generator
        self.element_name = element_name
        self.pos_name = pos_name if generator.with_position else None
        in_t = generator.children[0].data_type(child.schema)
        self.value_name = f"{element_name}_value" \
            if isinstance(in_t, dt.MapType) else None
        self._schema = list(child.schema)
        if self.pos_name:
            self._schema.append((self.pos_name, dt.INT32))
        if self.value_name:
            self._schema += [(element_name, in_t.key_type),
                             (self.value_name, in_t.value_type)]
        else:
            self._schema.append((element_name,
                                 generator.data_type(child.schema)))

    @property
    def schema(self) -> Schema:
        return self._schema

    def node_description(self) -> str:
        return f"Generate[{self.generator!r} -> {self.element_name}]"

    def expressions(self) -> List[Expression]:
        return [self.generator]
