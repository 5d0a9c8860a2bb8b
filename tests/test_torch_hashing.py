"""The port's Murmur3 (expr/hashing.py) held bit for bit against the JAX
package's ``murmur3_column`` / ``murmur3_row_hash`` on the same seeded
columns with nulls, on the CPU. Tolerance: none (bit-exact).

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.expr import hashing as H
from spark_rapids_tpu_torch.plan import host_table

CAP = 4096


@pytest.fixture(scope="module", autouse=True)
def _jax_cache_miss():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
        global jnp, JH, jdt, jhost
        import jax.numpy as jnp
        import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.expr import hashing as JH
        from spark_rapids_tpu.plan import host_table as jhost
        yield


def _lanes(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-5, 5, n)
    f[::7] = -0.0
    f[::11] = np.nan
    f[::13] = np.inf
    f[::17] = -np.inf
    pool = ["", "a", "ab", "abc", "abcd", "abcde", "héllo wörld", "x" * 33,
            "ÿ\u0080z", "R", "1-URGENT", "4-NOT SPECIFIED"]
    strings = np.array([pool[i] for i in rng.integers(0, len(pool), n)],
                       dtype=object)

    def mask():
        return rng.random(n) > 0.1
    return {
        "i32": (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), mask(),
                "int"),
        "i64": (rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64), mask(),
                "bigint"),
        "f64": (f, mask(), "double"),
        "date": (rng.integers(-1000, 20000, n).astype(np.int32), mask(),
                 "date"),
        "str": (strings, mask(), "string"),
    }


def _batches(lanes):
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=CAP)
    jt = {"int": jdt.INT32, "bigint": jdt.INT64, "double": jdt.FLOAT64,
          "date": jdt.DATE, "string": jdt.STRING}
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), CAP)
    return batch, jbatch


@pytest.mark.parametrize("name", ["i32", "i64", "f64", "date", "str"])
@pytest.mark.parametrize("seed", [42, 0xDEADBEEF])
def test_murmur3_column_bit_exact(name, seed):
    batch, jbatch = _batches(_lanes())
    got = H.murmur3_column(batch.column(name), seed)
    ref = JH.murmur3_column(jbatch.column(name),
                            jnp.full((CAP,), seed, jnp.uint32))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))


def test_murmur3_float_normalization():
    """-0.0 hashes as 0.0 and every NaN as the canonical NaN."""
    lanes = {"x": (np.array([0.0, -0.0, np.nan,
                             np.frombuffer(np.uint64(0x7FF8000000000001)
                                           .tobytes(), np.float64)[0]]),
                   np.ones(4, bool), "double")}
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8)
    h = H.murmur3_column(batch.column("x"), 42).numpy()
    assert h[0] == h[1] and h[2] == h[3]


def test_murmur3_row_hash_chain_bit_exact():
    lanes = _lanes(seed=5)
    batch, jbatch = _batches(lanes)
    got = H.murmur3_row_hash([batch.column(n) for n in lanes])
    ref = JH.murmur3_row_hash([jbatch.column(n) for n in lanes])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_null_rows_keep_the_seed():
    batch, _ = _batches(_lanes(seed=3))
    col = batch.column("str")
    seed = torch.arange(CAP, dtype=torch.int64) * 977 & 0xFFFFFFFF
    h = H.murmur3_column(col, seed)
    null = ~col.validity
    assert bool(null.any())
    assert torch.equal(h[null], seed[null])
