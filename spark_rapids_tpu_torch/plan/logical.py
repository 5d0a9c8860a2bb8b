"""Logical plan nodes.

Counterpart of spark_rapids_tpu/plan/logical.py for the nodes the ported
queries build (q6/q1/q3, the NDS queries: joins of every type, set
operations, windows, grouping sets), plus ``DeviceRelation``: a leaf over batches
already on the device (the JAX package reaches the same leaf through
CachedRelation).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from ..expr.aggregates import AggregateFunction
from ..expr.core import Expression, output_name

Schema = List  # [(name, DType), ...]


class LogicalPlan:
    def __init__(self, *children: "LogicalPlan"):
        self.children: List[LogicalPlan] = list(children)

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

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


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        super().__init__(child)
        self.exprs = list(exprs)
        self._schema = [(output_name(e, i), e.data_type(child.schema))
                        for i, e in enumerate(self.exprs)]

    @property
    def schema(self) -> Schema:
        return self._schema


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

    def node_description(self) -> str:
        fns = ", ".join(f"{type(we.func).__name__}->{n}"
                        for we, n in self.window_exprs)
        return f"Window[{fns}]"


class Union(LogicalPlan):
    """UNION ALL of children with equal column counts; the schema is the
    first child's. As in the JAX package no column is cast; a string
    column facing a non-string one (which the JAX package passes on as
    a mixed column) is refused."""

    def __init__(self, *children: LogicalPlan):
        super().__init__(*children)
        first = children[0].schema
        for c in children[1:]:
            if len(c.schema) != len(first):
                raise ValueError("UNION children column counts differ")
            for (name, a), (_, b) in zip(first, c.schema):
                if (a == dt.STRING) != (b == dt.STRING):
                    raise NotImplementedError(
                        f"a UNION of {a} and {b} in column {name!r} is "
                        "not in this port yet")

    @property
    def schema(self) -> Schema:
        return self.children[0].schema


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
