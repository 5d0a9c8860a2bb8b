from .core import Alias, ColumnRef, Expression, Literal, col, lit  # noqa: F401
from .window import (DenseRank, Lag, Lead, NTile, PercentRank,  # noqa: F401
                     Rank, RowNumber, Window, WindowFrame, WindowSpec)
