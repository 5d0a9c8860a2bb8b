"""TPC-H queries q6, q1 and q3 and the customer table spec (copied
from spark_rapids_tpu/models/tpch.py).

Dates are physical int32 days (1994-01-01 = 8766). ``tpch_table_specs``
sizes the three-table subset as the JAX package's ``tpch_tables`` does;
``tpch_tables`` writes it as chunked Parquet once and opens it with
``session.read.parquet`` (JAX models/tpch.py:32).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List

from ..columnar import dtypes as dt
from ..datagen import (ColumnSpec, TableSpec, generate_table, lineitem_spec,
                       orders_spec)
from ..expr.aggregates import Average, CountStar, Sum
from ..expr.core import col, lit


def customer_spec(scale_rows: int) -> TableSpec:
    return TableSpec("customer", [
        ColumnSpec("c_custkey", dt.INT64, "seq"),
        ColumnSpec("c_mktsegment", dt.STRING, "choice",
                   choices=["AUTOMOBILE", "BUILDING", "FURNITURE",
                            "HOUSEHOLD", "MACHINERY"]),
    ], scale_rows)


def tpch_table_specs(scale_rows: int) -> List[TableSpec]:
    """lineitem, orders and customer at one scale: orders a quarter and
    customer a fortieth of lineitem's rows."""
    return [lineitem_spec(scale_rows), orders_spec(max(scale_rows // 4, 1)),
            customer_spec(max(scale_rows // 40, 1))]


def tpch_tables(session, data_dir: str, scale_rows: int = 100_000,
                chunk_rows: int = 1 << 18) -> Dict[str, object]:
    """Generate (once: a table whose directory holds files is not
    written again) and open the three-table subset, one DataFrame a
    table over ``data_dir/<table>/``."""
    tables = {}
    for spec in tpch_table_specs(scale_rows):
        out = os.path.join(data_dir, spec.name)
        if not os.path.isdir(out) or not os.listdir(out):
            generate_table(session, spec, out, chunk_rows)
        tables[spec.name] = session.read.parquet(out)
    return tables


def q6(lineitem):
    """Forecasting revenue change."""
    return (lineitem
            .filter((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                    & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                    & (col("l_discount") >= 0.05)
                    & (col("l_discount") <= 0.07)
                    & (col("l_quantity") < 24.0))
            .agg(Sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


def q1(lineitem):
    """Pricing summary report."""
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (lineitem
            .filter(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .group_by("l_returnflag", "l_linestatus")
            .agg(Sum(col("l_quantity")).alias("sum_qty"),
                 Sum(col("l_extendedprice")).alias("sum_base_price"),
                 Sum(disc_price).alias("sum_disc_price"),
                 Sum(charge).alias("sum_charge"),
                 Average(col("l_quantity")).alias("avg_qty"),
                 Average(col("l_extendedprice")).alias("avg_price"),
                 Average(col("l_discount")).alias("avg_disc"),
                 CountStar().alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q3(customer, orders, lineitem):
    """Shipping priority: 3-way join + aggregate + top-N."""
    cutoff = lit(datetime.date(1995, 3, 15))
    c = customer.filter(col("c_mktsegment") == "BUILDING")
    o = orders.filter(col("o_orderdate") < cutoff)
    l = lineitem.filter(col("l_shipdate") > cutoff)
    joined = (c.join(o, on=([col("c_custkey")], [col("o_custkey")]))
               .join(l, on=([col("o_orderkey")], [col("l_orderkey")])))
    revenue = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (joined
            .group_by("o_orderkey", "o_orderdate")
            .agg(Sum(revenue).alias("revenue"))
            .sort("revenue", ascending=False)
            .limit(10))
