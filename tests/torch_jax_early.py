"""Early starts of the port suites' JAX subprocesses.

tests/test_torch_nds.py and the nested, higher-order and JSON files run
their JAX side in subprocesses that compile for minutes. The first port
file that a session collects (tests/test_torch_columnar.py) calls
``start_for`` once, so that those subprocesses compile on the cores the
port's single-threaded files leave idle. Each suite still starts its own
subprocesses when it runs without that file.
"""


def start_for(session, tmp_path_factory) -> None:
    """Start the JAX side of every suite in ``session`` that has one."""
    names = {item.path.name for item in session.items}
    if "test_torch_nds.py" in names:
        import test_torch_nds
        test_torch_nds.start_jax_chunks(tmp_path_factory)
    import torch_nested_jax
    if names & set(torch_nested_jax.FILES):
        torch_nested_jax.start(tmp_path_factory)
