"""Robustness: deterministic fault injection (faults.py) at the Delta
commit protocol's sites and the scan's, and the integrity layer
(integrity.py: the checksum envelope and ``DataCorruption``, which the
spill tiers raise too). Counterpart of spark_rapids_tpu/robustness/
(its admission control is not in this port)."""

from .faults import (FaultPlan, FaultSpec, active_plan, arm_fault_plan,
                     arm_from_conf, corrupt_point, current_op,
                     disarm_fault_plan, fault_point, op_scope)
from .integrity import (DataCorruption, checksum, unwrap, verify_framed,
                        wrap)

__all__ = ["FaultPlan", "FaultSpec", "fault_point", "corrupt_point",
           "arm_fault_plan", "disarm_fault_plan", "arm_from_conf",
           "active_plan", "op_scope", "current_op",
           "DataCorruption", "checksum", "wrap", "unwrap",
           "verify_framed"]
