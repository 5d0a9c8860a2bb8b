"""Observability: the structured JSONL event log (events.py).

Counterpart of spark_rapids_tpu/obs/ for its event log; the metrics
registry, the resource sampler, the roofline ledger and the span tracer
are not in this port yet (ROADMAP A11).
"""

from . import events  # noqa: F401
