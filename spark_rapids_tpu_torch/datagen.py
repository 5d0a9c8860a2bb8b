"""Scale-test data generation (TPC-H and NDS table shapes).

Counterpart of spark_rapids_tpu/datagen.py: declarative table specs with
per-(table, column, chunk) seeding, so any chunk regenerates on its own
and equals the JAX package's chunk value for value (same crc32 seed,
same numpy ``default_rng`` draws in the same order). ``choice`` string
columns are built vectorised, offsets and bytes taken straight from the
drawn indices, so a 60M-row table generates without a Python object per
row; a string column of any other distribution formats each drawn value
through ``fmt`` as the JAX package does (floats too: a ``uniform``
string column draws floats). ``generate_table`` writes a table as one
Parquet file per chunk through the port's writer
(io/parquet_writer.py), named as the JAX package names them.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .columnar import dtypes as dt
from .columnar.vector import HostStrings
from .plan.host_table import HostColumn, HostTable


@dataclass
class ColumnSpec:
    name: str
    dtype: dt.DType
    dist: str = "uniform"     # uniform | normal | zipf | seq | choice
    lo: float = 0
    hi: float = 100
    mean: float = 0.0
    std: float = 1.0
    alpha: float = 1.5        # zipf skew
    cardinality: int = 1000   # zipf key space
    choices: Optional[List] = None
    null_prob: float = 0.0
    fmt: Optional[str] = None  # string format template, {} = value


@dataclass
class TableSpec:
    name: str
    columns: List[ColumnSpec]
    num_rows: int


def _choice_strings(spec: ColumnSpec, idx: np.ndarray) -> HostStrings:
    fmt = spec.fmt or "{}"
    encoded = [fmt.format(c).encode("utf-8") for c in spec.choices]
    pool = np.frombuffer(b"".join(encoded), np.uint8)
    clen = np.array([len(e) for e in encoded], np.int64)
    cstart = np.concatenate([[0], np.cumsum(clen)[:-1]]).astype(np.int64)
    lens = clen[idx]
    offsets = np.zeros(idx.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if int(clen.max()) == 1:
        chars = pool[cstart[idx]]  # one byte per row: a plain gather
    else:
        row = np.repeat(np.arange(idx.shape[0]), lens)
        chars = pool[cstart[idx][row] + (np.arange(offsets[-1])
                                         - offsets[:-1][row])]
    return HostStrings(offsets.astype(np.int32), chars)


def _gen_column(spec: ColumnSpec, table: str, chunk: int, start_row: int,
                n: int) -> HostColumn:
    # crc32, not hash(): hash() is salted per process
    seed = zlib.crc32(f"{table}\x00{spec.name}\x00{chunk}".encode())
    rng = np.random.default_rng(seed)
    idx = None
    if spec.dist == "seq":
        vals = np.arange(start_row, start_row + n, dtype=np.int64)
    elif spec.dist == "uniform":
        if spec.dtype.is_integral or spec.dtype == dt.DATE:
            vals = rng.integers(int(spec.lo), int(spec.hi) + 1, n)
        else:
            vals = rng.uniform(spec.lo, spec.hi, n)
    elif spec.dist == "normal":
        vals = rng.normal(spec.mean, spec.std, n)
    elif spec.dist == "zipf":
        raw = rng.zipf(spec.alpha, n)
        vals = (raw - 1) % spec.cardinality
    elif spec.dist == "choice":
        idx = rng.integers(0, len(spec.choices), n)
        vals = None
    else:
        raise ValueError(spec.dist)

    mask = np.ones(n, bool)
    if spec.null_prob > 0:
        mask = rng.random(n) >= spec.null_prob

    t = spec.dtype
    if t == dt.STRING:
        if idx is not None:
            return HostColumn(_choice_strings(spec, idx), mask, t)
        # any other distribution: the drawn values (floats included)
        # through ``fmt``, one Python string per row; only dimension
        # tables hold such columns
        fmt = spec.fmt or "{}"
        return HostColumn(HostStrings.from_objects(
            [fmt.format(v) for v in vals]), mask, t)
    phys = t.np_physical
    if idx is not None:
        vals = np.asarray(spec.choices)[idx]
    if dt.is_decimal(t):
        # the unscaled lane: x 10^scale in float64, truncated toward
        # zero (the JAX package's bytes)
        out = (np.asarray(vals, np.float64) * 10 ** t.scale).astype(
            np.int64)
    else:
        out = np.asarray(vals).astype(phys)
    out = np.where(mask, out, np.zeros(1, phys))
    return HostColumn(out, mask, t)


def generate_chunk(spec: TableSpec, chunk: int,
                   chunk_rows: int) -> HostTable:
    start = chunk * chunk_rows
    n = min(chunk_rows, spec.num_rows - start)
    cols = [_gen_column(c, spec.name, chunk, start, n)
            for c in spec.columns]
    return HostTable(cols, [c.name for c in spec.columns])


def chunk_path(out_dir: str, spec: TableSpec, chunk: int) -> str:
    return os.path.join(out_dir, f"{spec.name}-{chunk:05d}.parquet")


def generate_table(session, spec: TableSpec, out_dir: str,
                   chunk_rows: int = 1 << 20,
                   compression: str = "snappy") -> List[str]:
    """Write the table as chunked Parquet; returns the file paths.
    ``session`` is unused (the JAX package's signature)."""
    from .io.writer import write_file
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for c in range(-(-spec.num_rows // chunk_rows)):
        path = chunk_path(out_dir, spec, c)
        write_file(generate_chunk(spec, c, chunk_rows), path,
                   {"compression": compression})
        paths.append(path)
    return paths


def lineitem_spec(scale_rows: int) -> TableSpec:
    """TPC-H lineitem as the JAX package generates it (the q6/q1 table)."""
    return TableSpec("lineitem", [
        ColumnSpec("l_orderkey", dt.INT64, "zipf",
                   cardinality=scale_rows // 4 + 1),
        ColumnSpec("l_partkey", dt.INT64, "uniform", lo=1, hi=200_000),
        ColumnSpec("l_quantity", dt.FLOAT64, "uniform", lo=1, hi=50),
        ColumnSpec("l_extendedprice", dt.FLOAT64, "uniform", lo=900,
                   hi=105_000),
        ColumnSpec("l_discount", dt.FLOAT64, "choice",
                   choices=[round(x * 0.01, 2) for x in range(11)]),
        ColumnSpec("l_tax", dt.FLOAT64, "choice",
                   choices=[round(x * 0.01, 2) for x in range(9)]),
        ColumnSpec("l_returnflag", dt.STRING, "choice",
                   choices=["A", "N", "R"]),
        ColumnSpec("l_linestatus", dt.STRING, "choice",
                   choices=["O", "F"]),
        ColumnSpec("l_shipdate", dt.DATE, "uniform", lo=8036, hi=10561),
    ], scale_rows)


def orders_spec(scale_rows: int) -> TableSpec:
    """TPC-H orders as the JAX package generates it (a q3 table)."""
    return TableSpec("orders", [
        ColumnSpec("o_orderkey", dt.INT64, "seq"),
        ColumnSpec("o_custkey", dt.INT64, "zipf", cardinality=150_000),
        ColumnSpec("o_totalprice", dt.FLOAT64, "uniform", lo=800,
                   hi=600_000),
        ColumnSpec("o_orderdate", dt.DATE, "uniform", lo=8036, hi=10561),
        ColumnSpec("o_orderpriority", dt.STRING, "choice",
                   choices=["1-URGENT", "2-HIGH", "3-MEDIUM",
                            "4-NOT SPECIFIED", "5-LOW"]),
        ColumnSpec("o_shippriority", dt.INT32, "choice", choices=[0]),
    ], scale_rows)
