from .core import Alias, ColumnRef, Expression, Literal, col, lit  # noqa: F401
from .collections import (ArrayContains, ArrayDistinct,  # noqa: F401
                          ArrayExcept, ArrayIntersect, ArrayJoin, ArrayMax,
                          ArrayMin, ArrayPosition, ArrayRemove, ArrayRepeat,
                          ArrayReverse, ArraysOverlap, ArraysZip, ArrayUnion,
                          CreateArray, CreateNamedStruct, ElementAt, Explode,
                          Flatten, GetArrayItem, GetStructField, Size, Slice,
                          SortArray, ZipWith, array, explode, explode_outer,
                          posexplode, struct, zip_with)
from .higher_order import (aggregate, create_map, exists,  # noqa: F401
                           filter_, forall, get_map_value, map_contains_key,
                           map_entries, map_filter, map_from_arrays,
                           map_keys, map_values, transform, transform_keys,
                           transform_values)
from .window import (DenseRank, Lag, Lead, NTile, PercentRank,  # noqa: F401
                     Rank, RowNumber, Window, WindowFrame, WindowSpec)
