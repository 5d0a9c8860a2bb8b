"""State carried in from outside the port: plain numpy lanes and
settings dicts, so a test can run the same data under the same settings
through both packages without this package importing the other."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .columnar import dtypes as dt
from .columnar.vector import HostStrings
from .conf import SrtConf
from .plan.host_table import HostColumn, HostTable


def host_table_from_lanes(
        lanes: Dict[str, Tuple[np.ndarray, np.ndarray, str]]) -> HostTable:
    """{name: (values, mask, dtype_name)} -> HostTable. ``dtype_name``
    is the type's SQL name (its repr in either package); string values
    are an object array of str or HostStrings."""
    cols, names = [], []
    for name, (values, mask, type_name) in lanes.items():
        t = dt.from_name(type_name)
        if t == dt.STRING:
            if not isinstance(values, HostStrings):
                values = HostStrings.from_objects(values)
        else:
            values = np.asarray(values).astype(t.np_physical, copy=False)
        cols.append(HostColumn(values, np.asarray(mask, bool), t))
        names.append(name)
    return HostTable(cols, names)


def lanes_of(table) -> Dict[str, Tuple[np.ndarray, np.ndarray, str]]:
    """{name: (values, mask, dtype_name)} of a host table of either
    package: anything with ``names`` and ``columns`` whose entries carry
    ``values``, ``mask`` and a ``dtype`` whose repr is its SQL name."""
    return {n: (c.values, c.mask, repr(c.dtype))
            for n, c in zip(table.names, table.columns)}


def host_tables_from(tables: Dict[str, object]) -> Dict[str, HostTable]:
    """{name: host table of either package} -> {name: HostTable}, e.g.
    the JAX package's generated lineitem, orders and customer."""
    return {name: host_table_from_lanes(lanes_of(t))
            for name, t in tables.items()}


def conf_from_dict(settings: Dict[str, object]) -> SrtConf:
    """The port's conf from a {key: value} dict."""
    return SrtConf(dict(settings))
