"""I/O: the Parquet scan and writer, without the Arrow library.

Counterpart of spark_rapids_tpu/io/ for Parquet: the footer in
thrift.py, the schema mapping in parquet_schema.py, the host decode and
encode in the port's C++ (csrc/host/, built and bound by host_lib.py),
the file reader in native_parquet.py and the writer in
parquet_writer.py; FileScan / FileSourceScanExec (scan.py) with the
reference's three reader types, ``session.read`` (reader.py) and
``df.write`` (writer.py). Host threads decode files without the device
semaphore and uploads take it (GpuParquetScan.scala:1862,2057).
"""
