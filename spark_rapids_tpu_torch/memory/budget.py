"""Device budget accounting and the OOM exception contract.

Counterpart of spark_rapids_tpu/memory/budget.py. Batches are
*accounted* against a logical device budget when they are registered as
spillable, and crossing the budget spills colder batches (spill.py) and
then raises ``RetryOOM``, before the device allocator would fail. On the
card the allocator itself can fail too: retry.py turns a
``torch.cuda.OutOfMemoryError`` raised inside a retry block into the
same contract.

OOM *injection* for tests lives here as in the JAX package: the
analogue of ``RmmSpark.forceRetryOOM``; tests arm a countdown and the
Nth allocation attempt throws.

The JAX package resolves a reservation's owner through its admission
module (not ported); here the session names the thread's current query
with :func:`query_scope`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Optional


class OutOfDeviceMemory(RuntimeError):
    """Base for device-memory pressure errors (GpuOOM in the JNI)."""


class RetryOOM(OutOfDeviceMemory):
    """Roll back to the last checkpoint and try again at the same size."""


class SplitAndRetryOOM(OutOfDeviceMemory):
    """Roll back, split the input, retry the halves (SplitAndRetryOOM)."""


class TaskContext:
    """Per-task bookkeeping: retry counters and the forced-OOM hooks."""

    def __init__(self, task_id: int):
        self.task_id = task_id
        self.reset_counters()
        # test-only injection counters (None = disarmed)
        self._inject_retry_after: Optional[int] = None
        self._inject_split_after: Optional[int] = None

    def reset_counters(self) -> None:
        """Zero the counters (a new query); an armed injection stays."""
        self.retry_count = 0
        self.split_count = 0
        self.spilled_bytes = 0
        self.alloc_attempts = 0
        # GpuTaskMetrics.scala:81-146 accumulators
        self.semaphore_wait_ns = 0
        self.spill_time_ns = 0

    def metrics(self) -> dict:
        """Snapshot (surfaced per task, like GpuTaskMetrics in the UI)."""
        return {"retryCount": self.retry_count,
                "splitAndRetryCount": self.split_count,
                "spilledBytes": self.spilled_bytes,
                "semaphoreWaitTimeNs": self.semaphore_wait_ns,
                "spillTimeNs": self.spill_time_ns,
                "allocAttempts": self.alloc_attempts}

    # --- fault injection (RmmSpark.forceRetryOOM analogue) ---
    def force_retry_oom(self, num_allocs_before: int = 0) -> None:
        self._inject_retry_after = num_allocs_before

    def force_split_and_retry_oom(self, num_allocs_before: int = 0) -> None:
        self._inject_split_after = num_allocs_before

    def on_alloc_attempt(self) -> None:
        self.alloc_attempts += 1
        if self._inject_retry_after is not None:
            if self._inject_retry_after == 0:
                self._inject_retry_after = None
                raise RetryOOM("injected RetryOOM")
            self._inject_retry_after -= 1
        if self._inject_split_after is not None:
            if self._inject_split_after == 0:
                self._inject_split_after = None
                raise SplitAndRetryOOM("injected SplitAndRetryOOM")
            self._inject_split_after -= 1


_TL = threading.local()


def task_context() -> TaskContext:
    ctx = getattr(_TL, "ctx", None)
    if ctx is None:
        ctx = TaskContext(task_id=threading.get_ident())
        _TL.ctx = ctx
    return ctx


def reset_task_context() -> TaskContext:
    _TL.ctx = TaskContext(task_id=threading.get_ident())
    return _TL.ctx


def current_query_id() -> Optional[str]:
    """The query this thread runs (set by the session), or None."""
    return getattr(_TL, "query_id", None)


@contextlib.contextmanager
def query_scope(query_id: str):
    """Charge this thread's reservations to ``query_id`` inside the
    block."""
    prev = current_query_id()
    _TL.query_id = query_id
    try:
        yield
    finally:
        _TL.query_id = prev


#: sentinel: "resolve the owner from the thread's current query" —
#: distinct from None, which means an explicitly untagged reservation
_RESOLVE_OWNER = object()


class _QuerySlice:
    """Per-query partition of the device budget: equal ``share`` of
    the pool, plus whatever idle-slot capacity the query borrows."""

    __slots__ = ("query_id", "share", "used")

    def __init__(self, query_id: str, share: int):
        self.query_id = query_id
        self.share = share
        self.used = 0


class MemoryBudget:
    """Logical byte budget over device memory.

    ``reserve`` is called before a batch is registered as spillable; if
    the budget would overflow it first asks the spill catalog to release
    bytes (synchronousSpill, RapidsBufferCatalog.scala:589) and only then
    raises RetryOOM. Thread-safe; shared across tasks like one device
    pool.

    While queries are registered (``register_query``) the pool is carved
    into ``slots`` equal slices and a query's reservations are checked
    against its own slice plus the idle pool (capacity no registered
    query claims); it never eats into another registered query's share.
    Spill pressure is scoped the same way: ``reserve`` hands the
    requesting query's id and the live-owner set to the spill callback,
    which then leaves other live queries' batches alone. With no query
    registered every check is the plain global budget.
    """

    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        self.used = 0
        self._lock = threading.Lock()
        self._spill_fn = None  # wired by the spill catalog
        self._slices: dict = {}  # query_id -> _QuerySlice
        self._nslots = 1

    def set_spill_callback(self, fn) -> None:
        self._spill_fn = fn

    # --- per-query slices -------------------------------------------------
    def register_query(self, query_id: str,
                       slots: Optional[int] = None) -> None:
        """Claim a budget slice for a query. ``slots`` (the slice count)
        is sticky across calls."""
        with self._lock:
            if slots is not None:
                self._nslots = max(int(slots), 1)
            share = self.limit // self._nslots
            self._slices[query_id] = _QuerySlice(query_id, share)

    def unregister_query(self, query_id: str) -> None:
        """Release a finished query's slice. Bytes it still holds stay
        accounted globally and become fair spill victims for everyone."""
        with self._lock:
            self._slices.pop(query_id, None)

    def active_owners(self) -> set:
        with self._lock:
            return set(self._slices)

    def _slice_cap_locked(self, sl: "_QuerySlice") -> int:
        """Effective byte cap for one slice: its own share plus the idle
        pool, minus what other queries already borrowed from it."""
        idle_pool = self.limit - sum(
            s.share for s in self._slices.values())
        borrowed_others = sum(
            max(0, s.used - s.share)
            for s in self._slices.values() if s is not sl)
        return sl.share + max(0, idle_pool - borrowed_others)

    def _try_reserve_locked(self, nbytes: int, owner) -> int:
        """Commit the reservation if it fits; else return the byte
        deficit the spill pass must free (>= 1)."""
        sl = self._slices.get(owner) if owner else None
        if self.used + nbytes > self.limit:
            deficit = self.used + nbytes - self.limit
        elif sl is not None and len(self._slices) > 1:
            cap = self._slice_cap_locked(sl)
            deficit = max(0, sl.used + nbytes - cap)
        else:
            # unpartitioned, untagged, or sole tenant: whole pool
            deficit = 0
        if deficit:
            return deficit
        self.used += nbytes
        if sl is not None:
            sl.used += nbytes
        return 0

    def reserve(self, nbytes: int, owner=_RESOLVE_OWNER) -> None:
        task_context().on_alloc_attempt()
        if owner is _RESOLVE_OWNER:
            # spill.py passes the batch's recorded owner explicitly so
            # reserve/release pair up on the same slice whichever thread
            # re-materializes
            owner = current_query_id()
        with self._lock:
            needed = self._try_reserve_locked(nbytes, owner)
            if not needed:
                return
        # Out of budget: spill-then-recheck in a loop (outside the lock:
        # spilling calls back into release()). One pass can free less
        # than asked, so keep asking until the reservation fits or the
        # catalog frees nothing more.
        while self._spill_fn is not None:
            freed = self._spill_fn(needed, owner, self.active_owners())
            with self._lock:
                needed = self._try_reserve_locked(nbytes, owner)
                if not needed:
                    return
            if freed <= 0:
                break
        with self._lock:
            sl = self._slices.get(owner) if owner else None
            slice_info = (f" slice[{owner}]={sl.used}/"
                          f"{self._slice_cap_locked(sl)}"
                          if sl is not None else "")
        raise RetryOOM(
            f"device budget exhausted: used={self.used} request={nbytes} "
            f"limit={self.limit}{slice_info}")

    def release(self, nbytes: int, owner: Optional[str] = None) -> None:
        with self._lock:
            self.used = max(0, self.used - nbytes)
            if owner:
                sl = self._slices.get(owner)
                if sl is not None:
                    sl.used = max(0, sl.used - nbytes)


_DEVICE_BUDGET: Optional[MemoryBudget] = None
_BUDGET_LOCK = threading.Lock()

#: the JAX package's pool when a device reports no memory size (the CPU)
_DEFAULT_POOL = 16 << 30


def expandable_segments_enabled() -> bool:
    """Whether the CUDA caching allocator grows its segments in place
    (``expandable_segments:True`` in ``PYTORCH_CUDA_ALLOC_CONF`` or
    ``PYTORCH_ALLOC_CONF``, which the allocator reads when CUDA starts).
    Without it, the fixed segments it carves keep part of a capped
    process's memory reserved but unallocated, and a query that would
    spill under the cap can die instead."""
    for var in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF"):
        for opt in os.environ.get(var, "").split(","):
            key, _, value = opt.partition(":")
            if key.strip() == "expandable_segments":
                return value.strip().lower() == "true"
    return False


def device_budget(conf=None, device=None) -> MemoryBudget:
    """Process-wide device budget, sized on first use from ``conf``
    (``srt.memory.tpu.poolSize``, else ``allocFraction`` of the free
    memory ``torch.cuda.mem_get_info`` reports on ``device``; a CPU
    device takes the JAX package's 16 GiB default)."""
    global _DEVICE_BUDGET
    with _BUDGET_LOCK:
        if _DEVICE_BUDGET is None:
            from ..conf import (DEVICE_MEMORY_FRACTION, DEVICE_MEMORY_LIMIT,
                                SrtConf)
            conf = conf or SrtConf()
            import torch
            dev = torch.device("cuda" if device is None else device)
            if dev.type == "cuda" and not expandable_segments_enabled():
                warnings.warn(
                    "PYTORCH_CUDA_ALLOC_CONF does not hold "
                    "expandable_segments:True: under a memory cap the "
                    "caching allocator's fixed segments keep part of the "
                    "cap reserved, so a query may die where it would "
                    "spill. Set it before CUDA starts.", RuntimeWarning,
                    stacklevel=2)
            limit = conf.get(DEVICE_MEMORY_LIMIT)
            if limit <= 0:
                free = torch.cuda.mem_get_info(dev)[0] \
                    if dev.type == "cuda" else _DEFAULT_POOL
                limit = int(free * conf.get(DEVICE_MEMORY_FRACTION))
            _DEVICE_BUDGET = MemoryBudget(limit)
        return _DEVICE_BUDGET


def reset_device_budget(limit_bytes: Optional[int] = None
                        ) -> Optional[MemoryBudget]:
    """Replace the global budget (None: re-derived at the next use)."""
    global _DEVICE_BUDGET
    with _BUDGET_LOCK:
        _DEVICE_BUDGET = None if limit_bytes is None \
            else MemoryBudget(limit_bytes)
        return _DEVICE_BUDGET
