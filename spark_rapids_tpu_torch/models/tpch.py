"""TPC-H queries q6 and q1 (copied from spark_rapids_tpu/models/tpch.py).

Dates are physical int32 days (1994-01-01 = 8766).
"""

from __future__ import annotations

import datetime

from ..expr.aggregates import Average, CountStar, Sum
from ..expr.core import col, lit


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
