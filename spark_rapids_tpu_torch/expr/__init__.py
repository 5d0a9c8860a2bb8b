from .core import Alias, ColumnRef, Expression, Literal, col, lit  # noqa: F401
