"""ORC through the port's reader and writer (io/native_orc.py,
io/orc_writer.py, csrc/host/orc.cpp), held against the JAX package and
pyarrow.

Files pyarrow writes, every flat type with NULLs, under each codec
(NONE, ZLIB, SNAPPY, ZSTD), file versions 0.11 (integer RLE v1) and 0.12
(RLE v2, dictionary strings), read through ``session.read.orc`` equal to
the JAX package's ``read.orc`` of them and to pyarrow. Files the port
writes (``df.write.orc``, partitioned, each codec) read back identically
through pyarrow and the port, timestamps before 1970 included. TPC-H q6
over ORC files equals the JAX package's q6 over the same files, and a
nested ORC column raises naming itself. The JAX side runs its CPU engine
(``srt.sql.enabled=false``) under ``patch_jax_compiles`` (C1).
"""

import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.io.native_orc import file_schema
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.plan.session import TpuSession

ROWS = 3000
CODECS = ["uncompressed", "zlib", "snappy", "zstd"]


def port(**conf):
    return TpuSession(SrtConf(conf), device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.models import tpch as jtpch
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        yield JSession(JConf({"srt.sql.enabled": False})), jtpch


def flat_table(seed=3, n=ROWS) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    epoch = datetime.datetime(1970, 1, 1)
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "b": pa.array(nulls(rng.integers(0, 2, n).astype(bool).tolist())),
        "i8": pa.array(nulls(rng.integers(-128, 128, n).tolist()), pa.int8()),
        "i16": pa.array(nulls(rng.integers(-2**15, 2**15, n).tolist()),
                        pa.int16()),
        "i32": pa.array(nulls(rng.integers(-2**31, 2**31, n).tolist()),
                        pa.int32()),
        "run": pa.array(nulls((np.arange(n) // 50 * 3).tolist()), pa.int64()),
        "i64": pa.array(nulls(rng.integers(-2**62, 2**62, n).tolist()),
                        pa.int64()),
        "f32": pa.array(nulls(rng.standard_normal(n).astype(np.float32)
                              .tolist()), pa.float32()),
        "f64": pa.array(nulls(rng.standard_normal(n).tolist())),
        "s": pa.array(nulls([f"k{x}" for x in rng.integers(0, 12, n)])),
        "u": pa.array(nulls(["é" * int(x) for x in rng.integers(0, 5, n)])),
        "d": pa.array(nulls([datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(x)) for x in rng.integers(-150000, 30000, n)]),
            pa.date32()),
        "ts": pa.array(nulls([epoch + datetime.timedelta(microseconds=int(x))
                              for x in rng.integers(-10**15, 10**15, n)]),
                       pa.timestamp("us")),
        "dec": pa.array(nulls([decimal.Decimal(int(x)).scaleb(-2) for x in
                               rng.integers(-10**12, 10**12, n)]),
                        pa.decimal128(14, 2)),
        "wdec": pa.array(nulls([decimal.Decimal(int(x) * 10**12 + 7)
                                .scaleb(-4) for x in
                                rng.integers(-10**12, 10**12, n)]),
                         pa.decimal128(30, 4)),
    })


def _plain(d):
    """Values as Python compares them: timestamps without a zone."""
    return {c: [v.replace(tzinfo=None) if isinstance(v, datetime.datetime)
                else v for v in vals] for c, vals in d.items()}


@pytest.mark.parametrize("version", ["0.11", "0.12"])
@pytest.mark.parametrize("codec", CODECS)
def test_pyarrow_orc_reads_as_the_jax_package(tmp_path, jax_side, codec,
                                              version):
    t = flat_table()
    path = str(tmp_path / "t.orc")
    po.write_table(t, path, compression=codec, file_version=version,
                   stripe_size=64 * 1024)
    want = _plain(t.to_pydict())
    got = _plain(port().read.orc(path).to_pydict())
    assert got == want
    jax = _plain(jax_side[0].read.orc(path).to_pydict())
    for c in want:
        assert jax[c] == want[c], c


@pytest.mark.parametrize("codec", ["none", "zlib", "snappy", "zstd"])
def test_port_written_orc_reads_back_through_pyarrow(tmp_path, codec):
    t = flat_table(seed=4)
    src = str(tmp_path / "src.orc")
    po.write_table(t, src)
    s = port()
    out = str(tmp_path / "out")
    st = s.read.orc(src).write.option("compression", codec) \
        .option("stripeRows", 1000).partition_by("b").orc(out)
    assert st.num_rows == ROWS and st.num_files == 3
    want = _plain(t.to_pydict())
    # a partition value reads back as Spark infers it: here a string
    want["b"] = [None if v is None else str(v).lower() for v in want["b"]]
    order = np.argsort(want["k"])
    for part in os.listdir(out):
        assert part.startswith("b=")
    back = {}
    for dirpath, _, files in os.walk(out):
        for f in files:
            b = os.path.basename(dirpath)[2:]
            tb = _plain(po.read_table(os.path.join(dirpath, f)).to_pydict())
            tb["b"] = [None if b == "__HIVE_DEFAULT_PARTITION__" else
                       b] * len(tb["s"])
            for c, v in tb.items():
                back.setdefault(c, []).extend(v)
    border = np.argsort(back["k"])
    for c in want:
        assert [back[c][i] for i in border] == [want[c][i] for i in order], c
    got = _plain(s.read.orc(out).to_pydict())
    gorder = np.argsort(got["k"])
    for c in want:
        assert [got[c][i] for i in gorder] == [want[c][i] for i in order], c


def test_tpch_q6_over_orc_equals_the_jax_package(tmp_path, jax_side):
    s = port()
    li = tpch.tpch_tables(s, str(tmp_path / "pq"), 20_000)["lineitem"]
    path = str(tmp_path / "li")
    li.write.option("stripeRows", 4096).orc(path)
    got = tpch.q6(s.read.orc(path)).collect()[0]["revenue"]
    jsess, jtpch = jax_side
    jax = jtpch.q6(jsess.read.orc(path)).collect()[0]["revenue"]
    assert got == pytest.approx(jax, rel=1e-9)
    assert got == pytest.approx(tpch.q6(li).collect()[0]["revenue"],
                                rel=1e-12)


def test_nested_orc_column_raises_naming_itself(tmp_path):
    path = str(tmp_path / "n.orc")
    po.write_table(pa.table({"a": [1, 2], "l": [[1], [2, 3]]}), path)
    with pytest.raises(NotImplementedError, match="'l'.*LIST.*A7.4"):
        file_schema(path)
    got = port().read.orc(path, schema=[("a", dt.INT64)]).to_pydict()
    assert got == {"a": [1, 2]}
    with pytest.raises(NotImplementedError, match="A7.4"):
        port().create_dataframe({"l": [[1]]}, [("l", dt.ArrayType(
            dt.INT64))]).write.orc(str(tmp_path / "w"))
    assert port().read.orc(path, schema=[("a", dt.INT64)]) \
        .filter(col("a") > 1).to_pydict() == {"a": [2]}
