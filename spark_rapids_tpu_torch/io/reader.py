"""DataFrameReader: ``session.read.parquet`` and ``session.read.delta``.

Counterpart of spark_rapids_tpu/io/reader.py (the role Spark's
DataFrameReader plays) for Parquet and standard-format Delta tables: a
DataFrame over a FileScan (io/scan.py). The schema is the first file's
unless given, with the hive partition columns of a directory layout
after it. The other formats of the JAX package's reader raise
NotImplementedError naming the ROADMAP item that holds them.
"""

from __future__ import annotations

from typing import List, Optional

from .scan import FileScan


class DataFrameReader:
    def __init__(self, session):
        self.session = session
        self._options: dict = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **kw) -> "DataFrameReader":
        self._options.update(kw)
        return self

    def parquet(self, *paths, schema: Optional[List] = None):
        """Parquet files, directories (hive ``key=value`` partitions
        included) or globs; ``schema`` is [(name, DType)]."""
        from ..plan.session import DataFrame
        return DataFrame(self.session, FileScan(
            list(paths) if len(paths) > 1 else paths[0], "parquet", schema,
            dict(self._options)))

    def _not_ported(self, fmt: str, item: str):
        raise NotImplementedError(f"session.read.{fmt}: the {fmt} reader is "
                                  f"not in this port yet (ROADMAP {item})")

    def orc(self, *paths, schema=None):
        self._not_ported("orc", "A7")

    def csv(self, *paths, schema=None, **kw):
        self._not_ported("csv", "A9")

    def json(self, *paths, schema=None):
        self._not_ported("json", "A9")

    def avro(self, *paths, schema=None):
        self._not_ported("avro", "A9")

    def delta(self, path: str, version_as_of: Optional[int] = None):
        """Standard-format Delta Lake table (io/delta_format.py):
        _delta_log JSON replay with time travel."""
        from .delta_format import read_delta
        return read_delta(self.session, path, version_as_of)

    def iceberg(self, path, snapshot_id=None, as_of_timestamp_ms=None):
        self._not_ported("iceberg", "A9")

    def hive_text(self, *paths, schema=None, sep="\x01"):
        self._not_ported("hive_text", "A9")
