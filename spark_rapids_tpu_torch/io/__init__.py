"""I/O: the Parquet and ORC scans and writers, without the Arrow library.

Counterpart of spark_rapids_tpu/io/ for Parquet and ORC: the Parquet
footer in thrift.py, the schema mapping in parquet_schema.py (nested
columns in parquet_nested.py), the host decode and encode in the port's
C++ (csrc/host/, built and bound by host_lib.py), the file readers in
native_parquet.py and native_orc.py and the writers in
parquet_writer.py and orc_writer.py; row-group pruning from statistics
in pruning.py; FileScan / FileSourceScanExec (scan.py) with the
reference's three reader types and runtime partition pruning,
``session.read`` (reader.py) and ``df.write`` (writer.py). Host threads
decode files without the device semaphore and uploads take it
(GpuParquetScan.scala:1862,2057).
"""
