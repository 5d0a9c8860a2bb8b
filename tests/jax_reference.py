"""The JAX side of the port's differential tests (tests/test_torch_*.py).

tests/conftest.py wraps jax's ``_cache_read`` with four arguments and
this jax passes five, so a JAX compile inside pytest fails unless every
cache read is a miss: the JAX side compiles each of its programs afresh,
and that compiling is most of its time. XLA's CPU backend compiles about
a quarter faster at optimization level 0, without its expensive LLVM
passes, and computes the same values (the tests compare at 1e-9).
"""

#: the same settings for a JAX side run as a subprocess
SUBPROCESS_XLA_FLAGS = ("--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true")


def patch_jax_compiles(mp) -> None:
    """Within the ``pytest.MonkeyPatch`` context ``mp``: every JAX cache
    read a miss, and every compile at XLA's optimization level 0."""
    from jax._src import compiler
    mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
    orig = compiler.get_compile_options

    def get_compile_options(*args, **kwargs):
        opts = orig(*args, **kwargs)
        debug = opts.executable_build_options.debug_options
        debug.xla_backend_optimization_level = 0
        debug.xla_llvm_disable_expensive_passes = True
        return opts
    mp.setattr(compiler, "get_compile_options", get_compile_options)
