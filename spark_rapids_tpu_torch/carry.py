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
    are an object array of str."""
    cols, names = [], []
    for name, (values, mask, type_name) in lanes.items():
        t = dt.from_name(type_name)
        if t == dt.STRING:
            values = HostStrings.from_objects(values)
        else:
            values = np.asarray(values).astype(t.np_physical, copy=False)
        cols.append(HostColumn(values, np.asarray(mask, bool), t))
        names.append(name)
    return HostTable(cols, names)


def conf_from_dict(settings: Dict[str, object]) -> SrtConf:
    """The port's conf from a {key: value} dict."""
    return SrtConf(dict(settings))
