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

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.expr import hashing as H
from spark_rapids_tpu_torch.plan import host_table

CAP = 4096


@pytest.fixture(scope="module", autouse=True)
def _jax_cache_miss():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
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
                                      capacity=CAP, device="cpu")
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
                                      capacity=8, device="cpu")
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


# --- a DECIMAL(p>18): Spark hashes its unscaled value's bytes ----------------

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
_P = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
      0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def _rotl(x, r, bits):
    mask = (1 << bits) - 1
    return ((x << r) | (x >> (bits - r))) & mask


def _murmur3_bytes(b: bytes, seed: int) -> int:
    """Spark's Murmur3_x86_32.hashUnsafeBytes, in plain Python."""
    def mix_k1(k):
        return (_rotl((k * 0xCC9E2D51) & M32, 15, 32) * 0x1B873593) & M32

    def mix_h1(h, k):
        return (_rotl(h ^ k, 13, 32) * 5 + 0xE6546B64) & M32
    h = seed & M32
    aligned = len(b) - len(b) % 4
    for i in range(0, aligned, 4):
        h = mix_h1(h, mix_k1(int.from_bytes(b[i:i + 4], "little")))
    for i in range(aligned, len(b)):
        h = mix_h1(h, mix_k1((b[i] - 256 if b[i] >= 128 else b[i]) & M32))
    h ^= len(b)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _xxhash64_bytes(b: bytes, seed: int) -> int:
    """Spark's XXH64.hashUnsafeBytes below 32 bytes, in plain Python."""
    p1, p2, p3, p4, p5 = _P
    n, at = len(b), 0
    h = (seed + p5 + n) & M64
    while at + 8 <= n:
        k = (_rotl((int.from_bytes(b[at:at + 8], "little") * p2) & M64, 31,
                   64) * p1) & M64
        h = (_rotl(h ^ k, 27, 64) * p1 + p4) & M64
        at += 8
    if at + 4 <= n:
        h ^= (int.from_bytes(b[at:at + 4], "little") * p1) & M64
        h = (_rotl(h, 23, 64) * p2 + p3) & M64
        at += 4
    for i in range(at, n):
        h ^= (b[i] * p5) & M64
        h = (_rotl(h, 11, 64) * p1) & M64
    h ^= h >> 33
    h = (h * p2) & M64
    h ^= h >> 29
    h = (h * p3) & M64
    return h ^ (h >> 32)


def _to_byte_array(v: int) -> bytes:
    """java.math.BigInteger.toByteArray: minimal big-endian two's
    complement."""
    bits = v.bit_length() if v >= 0 else (~v).bit_length()
    return v.to_bytes(bits // 8 + 1, "big", signed=True)


def _wide_values(n=400, seed=5):
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 127, 128, -128, -129, 255, 256, 2 ** 63, -(2 ** 63),
             2 ** 64, 10 ** 37, -(10 ** 37) + 3, 2 ** 126, -(2 ** 127),
             10 ** 38 - 1, -(10 ** 38 - 1), None]
    rand = [int(a) * 10 ** 12 + int(b) for a, b in zip(
        rng.integers(-10 ** 15, 10 ** 15, n), rng.integers(0, 10 ** 12, n))]
    return edges + [None if i % 17 == 0 else v for i, v in enumerate(rand)]


@pytest.mark.parametrize("fn", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("scale", [0, 4])
def test_wide_decimal_hash_is_sparks_byte_hash(fn, scale):
    """murmur3 and xxhash64 of a DECIMAL(38, s) column, through
    ``hash()`` / ``xxhash64()`` on the device path and the CPU engine,
    against plain-Python ports of Spark's hashUnsafeBytes over
    BigInteger.toByteArray; the JAX package hashes the value as a long
    (ROADMAP C20), so its murmur3 differs."""
    import decimal

    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expr.core import col
    from spark_rapids_tpu_torch.plan.cpu_exec import execute_cpu
    from spark_rapids_tpu_torch.plan.host_table import from_engine, to_pydict
    from spark_rapids_tpu_torch.plan.session import TpuSession
    vals = _wide_values()
    t = dt.DecimalType(38, scale)
    s = TpuSession(device="cpu")
    df = s.create_dataframe(
        {"w": [None if v is None else decimal.Decimal(v).scaleb(
            -scale, context=decimal.Context(prec=80)) for v in vals]},
        [("w", t)])
    expr = H.Murmur3Hash(col("w")) if fn == "murmur3" else \
        H.XxHash64(col("w"))
    q = df.select(expr.alias("h"))
    assert "!" not in q.explain("NOT_ON_TPU").split("\n")[0]
    got = [r["h"] for r in q.collect()]
    cpu = to_pydict(from_engine(execute_cpu(q.plan)))["h"]
    if fn == "murmur3":
        want = [42 if v is None else _murmur3_bytes(_to_byte_array(v), 42)
                for v in vals]
        want = [w - (1 << 32) if w >= 1 << 31 else w for w in want]
    else:
        want = [42 if v is None else _xxhash64_bytes(_to_byte_array(v), 42)
                for v in vals]
        want = [w - (1 << 64) if w >= 1 << 63 else w for w in want]
    assert got == cpu == want
    if fn == "murmur3" and scale == 0:
        small = torch.tensor([v for v in vals if v is not None and
                              -(2 ** 63) <= v < 2 ** 63], dtype=torch.int64)
        jcol = JH.murmur3_column(jdt_column(small.numpy()),
                                 jnp.uint32(42))
        as_bytes = [_murmur3_bytes(_to_byte_array(int(v)), 42)
                    for v in small]
        assert np.asarray(jcol).astype(np.int64).tolist() != as_bytes


def jdt_column(vals):
    from spark_rapids_tpu.columnar.vector import ColumnVector
    return ColumnVector(jnp.asarray(vals), jnp.ones(len(vals), bool),
                        jdt.DecimalType(38, 0))
