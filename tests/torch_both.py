"""One case written once for both packages: ``Api`` holds a package's
names (the port's ``spark_rapids_tpu_torch`` or the JAX package's
``spark_rapids_tpu``), so a test builds the same DataFrame through each
and compares. The JAX package is imported only when its ``Api`` is
made, inside a test's ``patch_jax_compiles`` fixture."""

import importlib

import pytest

from jax_reference import patch_jax_compiles


class Api:
    """One package's names; ``port`` tells which package it is."""

    def __init__(self, root: str):
        def m(sub):
            return importlib.import_module(f"{root}.{sub}")
        self.dt = m("columnar.dtypes")
        core = m("expr.core")
        self.col, self.lit, self.Alias = core.col, core.lit, core.Alias
        self.Cast = m("expr.cast").Cast
        self.A = m("expr.arithmetic")
        self.Agg = m("expr.aggregates")
        self.B = m("expr.bitwise")
        self.H = m("expr.hashing")
        self.MX = m("expr.misc")
        self.Cond = m("expr.conditional")
        self.P = m("expr.predicates")
        self.ERR = m("expr.errors")
        self.bloom = m("ops.bloom")
        self.SrtConf = m("conf").SrtConf
        self.TpuSession = m("plan.session").TpuSession
        self.rewrite_plan = m("expr.ansi").rewrite_plan
        self.execute_cpu = m("plan.cpu_exec").execute_cpu
        self.port = root == "spark_rapids_tpu_torch"

    def session(self, ansi: bool = False, **conf):
        c = self.SrtConf({"srt.sql.ansi.enabled": ansi, **conf})
        return self.TpuSession(c, device="cpu") if self.port else \
            self.TpuSession(c)

    def df(self, s, data, types):
        """``types``: [(name, a dtypes attribute name or a DType)]."""
        return s.create_dataframe(data, [(n, getattr(self.dt, t) if
                                          isinstance(t, str) else t)
                                         for n, t in types])


PORT = Api("spark_rapids_tpu_torch")


@pytest.fixture(scope="module")
def jax_api():
    """The JAX package's ``Api``, its compiles patched (C1)."""
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        import spark_rapids_tpu  # noqa: F401  (x64 and the jax config)
        yield Api("spark_rapids_tpu")
