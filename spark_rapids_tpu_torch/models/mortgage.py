"""Mortgage-ETL-shaped pipeline (mortgage/MortgageSpark.scala role,
BASELINE.md config 5): join performance records to acquisitions,
derive delinquency features, aggregate per loan, the classic
ETL-then-ML-features benchmark, ending in ``to_device_arrays()`` for the
ML hand-off (ColumnarRdd -> XGBoost in the reference).

Counterpart of spark_rapids_tpu/models/mortgage.py, copied: the same
specs, so ``mortgage_tables`` writes the JAX package's rows, in
262,144-row Parquet files through the port's writer.
"""

from __future__ import annotations

import os

from ..columnar import dtypes as dt
from ..datagen import ColumnSpec, TableSpec, generate_table
from ..expr.aggregates import Average, CountStar, Max, Sum
from ..expr.conditional import If
from ..expr.core import col, lit


def acquisitions_spec(n: int) -> TableSpec:
    return TableSpec("acquisitions", [
        ColumnSpec("loan_id", dt.INT64, "seq"),
        ColumnSpec("orig_rate", dt.FLOAT64, "uniform", lo=2.0, hi=9.0),
        ColumnSpec("orig_amount", dt.FLOAT64, "uniform", lo=50_000,
                   hi=800_000),
        ColumnSpec("credit_score", dt.INT32, "uniform", lo=300, hi=850),
        ColumnSpec("state", dt.STRING, "choice",
                   choices=["CA", "TX", "NY", "FL", "WA", "IL"]),
    ], n)


def performance_spec(n_loans: int, months: int = 12) -> TableSpec:
    return TableSpec("performance", [
        ColumnSpec("loan_id", dt.INT64, "uniform", lo=0, hi=n_loans - 1),
        ColumnSpec("age_months", dt.INT32, "uniform", lo=0, hi=months),
        ColumnSpec("current_upb", dt.FLOAT64, "uniform", lo=10_000,
                   hi=800_000),
        ColumnSpec("days_delinquent", dt.INT32, "zipf", cardinality=120),
    ], n_loans * months)


def mortgage_tables(session, data_dir: str, n_loans: int = 20_000):
    """Generate (once: a table whose directory holds files is not
    written again) and open the two tables under ``data_dir``."""
    tables = {}
    for spec in (acquisitions_spec(n_loans),
                 performance_spec(n_loans)):
        out = os.path.join(data_dir, spec.name)
        if not os.path.isdir(out) or not os.listdir(out):
            generate_table(session, spec, out, 1 << 18)
        tables[spec.name] = session.read.parquet(out)
    return tables


def mortgage_etl(acquisitions, performance):
    """Per-loan features: delinquency events, ever-90-days flag, UPB
    trajectory, joined to origination attributes."""
    perf = performance.with_column(
        "delinq_90", If(col("days_delinquent") >= 90, lit(1), lit(0)))
    per_loan = (perf.group_by("loan_id").agg(
        CountStar().alias("n_reports"),
        Sum(col("delinq_90")).alias("n_delinq_90"),
        Max(col("days_delinquent")).alias("max_delinq"),
        Average(col("current_upb")).alias("avg_upb")))
    feats = per_loan.join(acquisitions, on="loan_id")
    return feats.with_column(
        "ever_90", If(col("n_delinq_90") > 0, lit(1), lit(0)))
