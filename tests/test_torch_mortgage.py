"""The port's mortgage ETL (models/mortgage.py) and ML hand-off
(``DataFrame.to_device_arrays``) held against the JAX package's over
2,000 loans (24,000 performance rows): the generated files decode to the
same rows, ``mortgage_etl`` gives the same per-loan features, and
``to_device_arrays`` the same names, ``num_rows`` and values, through
the port's device path and through its CPU engine (the host-to-device
seam). Floats at rtol 1e-9, the rest exact. The JAX side runs its CPU
engine (``srt.sql.enabled=false``) under ``patch_jax_compiles`` (C1).
"""

import numpy as np
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.models import mortgage
from spark_rapids_tpu_torch.plan.session import DeviceColumns, TpuSession

LOANS = 2_000
RTOL = 1e-9
FLOATS = ("avg_upb", "orig_rate", "orig_amount")


@pytest.fixture(scope="module")
def jax_etl(tmp_path_factory):
    """The JAX package's tables, features (rows by loan) and
    ``to_device_arrays`` as numpy, over its own generated files."""
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.models import mortgage as jm
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        s = JSession(JConf({"srt.sql.enabled": False}))
        t = jm.mortgage_tables(s, str(tmp_path_factory.mktemp("jm")),
                               n_loans=LOANS)
        feats = jm.mortgage_etl(t["acquisitions"], t["performance"])
        arrs = feats.to_device_arrays()
        lanes = {}
        for name, (data, valid) in arrs.items():
            if isinstance(data, tuple):   # strings: (offsets, chars)
                data = tuple(np.asarray(a) for a in data)
            else:
                data = np.asarray(data)[:arrs.num_rows]
            lanes[name] = (data, np.asarray(valid)[:arrs.num_rows])
        return ({n: sorted(_rows(df.collect())) for n, df in t.items()},
                sorted(_rows(feats.collect())), lanes, arrs.num_rows)


def _rows(rows):
    return [tuple(r.items()) for r in rows]


@pytest.fixture(scope="module")
def port_tables(tmp_path_factory):
    s = TpuSession(SrtConf({}), device="cpu")
    return s, mortgage.mortgage_tables(
        s, str(tmp_path_factory.mktemp("pm")), n_loans=LOANS)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, a), (_, b) in zip(g, w):
            if k in FLOATS:
                assert a == pytest.approx(b, rel=RTOL, abs=0.0), k
            else:
                assert a == b, k


def test_generated_tables_equal_jax(port_tables, jax_etl):
    _, tables = port_tables
    for name, df in tables.items():
        assert sorted(_rows(df.collect())) == jax_etl[0][name], name
    assert len(jax_etl[0]["performance"]) == 12 * LOANS


def test_mortgage_etl_equals_jax(port_tables, jax_etl):
    _, t = port_tables
    feats = mortgage.mortgage_etl(t["acquisitions"], t["performance"])
    got = sorted(_rows(feats.collect()))
    _same(got, jax_etl[1])
    assert len(got) == LOANS
    assert [k for k, _ in got[0]] == [
        "loan_id", "n_reports", "n_delinq_90", "max_delinq", "avg_upb",
        "orig_rate", "orig_amount", "credit_score", "state", "ever_90"]


def _by_loan(arrs):
    """The DeviceColumns' lanes as numpy, rows ordered by loan_id."""
    n = arrs.num_rows
    order = np.argsort(arrs["loan_id"][0][:n].numpy(), kind="stable")
    out = {}
    for name, (data, valid) in arrs.items():
        if isinstance(data, tuple):
            offsets, chars = (a.numpy() for a in data)
            strs = [bytes(chars[offsets[i]:offsets[i + 1]]).decode()
                    for i in range(n)]
            out[name] = ([strs[i] for i in order],
                         valid[:n].numpy()[order])
        else:
            out[name] = (data[:n].numpy()[order], valid[:n].numpy()[order])
    return out


def _jax_by_loan(lanes, n):
    order = np.argsort(lanes["loan_id"][0], kind="stable")
    out = {}
    for name, (data, valid) in lanes.items():
        if isinstance(data, tuple):
            offsets, chars = data
            strs = [bytes(chars[offsets[i]:offsets[i + 1]]).decode()
                    for i in range(n)]
            out[name] = ([strs[i] for i in order], valid[order])
        else:
            out[name] = (data[order], valid[order])
    return out


@pytest.mark.parametrize("engine", ["device", "cpu_engine"])
def test_to_device_arrays_equal_jax(port_tables, jax_etl, engine, tmp_path):
    s, t = port_tables
    if engine == "cpu_engine":
        s = TpuSession(SrtConf({"srt.sql.enabled": False}), device="cpu")
        t = mortgage.mortgage_tables(s, str(tmp_path), n_loans=LOANS)
    arrs = mortgage.mortgage_etl(t["acquisitions"],
                                 t["performance"]).to_device_arrays()
    assert isinstance(arrs, DeviceColumns)
    _, _, lanes, n = jax_etl
    assert arrs.num_rows == n == LOANS
    assert list(arrs) == list(lanes)
    got, want = _by_loan(arrs), _jax_by_loan(lanes, n)
    for name in want:
        (g, gv), (w, wv) = got[name], want[name]
        assert np.array_equal(gv, wv), name
        if name in FLOATS:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0)
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), name


def test_to_device_arrays_shapes():
    s = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4}), device="cpu")
    df = s.create_dataframe({"x": [1.0, None, 3.0, 4.0, 5.0, 6.0],
                             "s": ["a", "bc", None, "", "d", "ef"]},
                            [("x", dt.FLOAT64), ("s", dt.STRING)])
    arrs = df.to_device_arrays()      # two batches, one concat
    assert arrs.num_rows == 6
    data, valid = arrs["x"]
    assert data.shape[0] >= 6 and valid[:6].tolist() == \
        [True, False, True, True, True, True]
    (offsets, chars), svalid = arrs["s"]
    assert bytes(chars[:int(offsets[6])].numpy()) == b"abcdef"
    assert svalid[:6].tolist() == [True, True, False, True, True, True]
    empty = df.filter(col("x") > 100.0)
    assert empty.to_device_arrays() == {} and \
        empty.to_device_arrays().num_rows == 0
    dec = s.create_dataframe({"d": [1]}, [("d", dt.DecimalType(24, 4))])
    with pytest.raises(TypeError, match="no flat device array"):
        dec.to_device_arrays()
