"""Memory management: device budget, tiered spill, split-and-retry.

Counterpart of spark_rapids_tpu/memory/ (the reference's
RapidsBufferCatalog / stores / RmmRapidsRetryIterator /
SpillableColumnarBatch), over the CUDA caching allocator.
"""

from .budget import (MemoryBudget, OutOfDeviceMemory, RetryOOM,
                     SplitAndRetryOOM, TaskContext, device_budget,
                     expandable_segments_enabled, task_context)
from .retry import (DeviceOOM, split_spillable_in_half_by_rows,
                    with_restore_on_retry, with_retry, with_retry_no_split)
from .spill import (DataCorruption, SpillableBatch, SpillCatalog,
                    SpillPriority, spill_catalog)

__all__ = [
    "MemoryBudget", "OutOfDeviceMemory", "RetryOOM", "SplitAndRetryOOM",
    "TaskContext", "device_budget", "expandable_segments_enabled",
    "task_context",
    "DataCorruption", "SpillableBatch", "SpillCatalog", "SpillPriority",
    "spill_catalog", "DeviceOOM", "split_spillable_in_half_by_rows",
    "with_restore_on_retry", "with_retry", "with_retry_no_split",
]
