"""Tiered spill: device -> pinned host -> disk.

Counterpart of spark_rapids_tpu/memory/spill.py (the reference's
RapidsBufferCatalog, its device / host / disk stores and
SpillableColumnarBatch). A batch's "buffers" are the tensors of its
columns: data and validity of a ``ColumnVector``, hi, lo and validity
of a ``Decimal128Column``, offsets, chars and validity of a
``StringColumn``, offsets and validity of a
``ListColumn`` (a list or a map) plus its child's buffers, the validity
of a ``StructColumn`` plus its children's.

- Device -> host copies each buffer of a CUDA batch into a pinned host
  tensor with ``non_blocking=True`` and records a CUDA event after the
  copies; whatever reads the host copy first (the checksum, the disk
  writer, the way back) waits on that event. A CPU batch has nothing to
  pin: its buffers are copied into plain host tensors.
- Host -> disk writes one file per buffer under a per-process session
  directory of ``srt.memory.spill.dir``.
- Host / disk -> device verifies each buffer against the checksum taken
  when it left the device (``srt.integrity.checksum.enabled``); a
  mismatch drops the entry and raises ``DataCorruption``, so the caller
  recomputes instead of reading garbage.

Every device byte is accounted against the shared MemoryBudget, so
spilling relieves device pressure. Not carried from the JAX package: its
native host pool (``_PooledLeaves`` over ``native/``) and the raw
O_DIRECT slab files of its disk tier (ROADMAP A7 / A9 queue both), and
the session's map-count guard, which clears XLA executable caches (eager
torch maps no executable per program).
"""

from __future__ import annotations

import atexit
import logging
import os
import re
import shutil
import tempfile
import threading
import time
import traceback
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.decimal128 import Decimal128Column
from ..columnar.nested import ListColumn, StructColumn
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from ..robustness.integrity import DataCorruption, array_checksum
from .budget import MemoryBudget, current_query_id, device_budget, \
    task_context

# ---------------------------------------------------------------------------
# batches as flat buffer lists
# ---------------------------------------------------------------------------


class SpillPriority(IntEnum):
    """Lower spills first (SpillPriorities.scala ordering)."""

    SHUFFLE_OUTPUT = 0       # regeneratable / long-lived, cold
    CACHED = 10
    ACTIVE_ON_DECK = 50      # input batches queued behind an operator
    ACTIVE_WORKING = 100     # spills last


def _column_buffers(col, out: List[torch.Tensor]):
    """Append ``col``'s buffers to ``out``; return the spec that
    rebuilds the column from them."""
    if isinstance(col, ColumnVector):
        out += [col.data, col.validity]
        return ("vec", col.dtype)
    if isinstance(col, StringColumn):
        out += [col.offsets, col.chars, col.validity]
        return ("str", col.pad_bucket)
    if isinstance(col, Decimal128Column):
        out += [col.hi, col.lo, col.validity]
        return ("d128", col.dtype)
    if isinstance(col, ListColumn):
        out += [col.offsets, col.validity]
        return ("list", col.dtype, _column_buffers(col.child, out))
    if isinstance(col, StructColumn):
        out.append(col.validity)
        return ("struct", col.dtype,
                [_column_buffers(c, out) for c in col.children])
    raise TypeError(f"cannot spill a {type(col).__name__}")


def _column_from(spec, bufs):
    kind = spec[0]
    if kind == "vec":
        return ColumnVector(next(bufs), next(bufs), spec[1])
    if kind == "str":
        return StringColumn(next(bufs), next(bufs), next(bufs), spec[1])
    if kind == "d128":
        return Decimal128Column(next(bufs), next(bufs), next(bufs), spec[1])
    if kind == "struct":
        validity = next(bufs)
        return StructColumn([_column_from(k, bufs) for k in spec[2]],
                            validity, spec[1])
    offsets, validity = next(bufs), next(bufs)
    t = spec[1]
    return ListColumn(offsets, _column_from(spec[2], bufs), validity,
                      t.element_type, t if isinstance(t, dt.MapType) else None)


def _flatten(batch: ColumnarBatch) -> Tuple[List[torch.Tensor], tuple]:
    bufs: List[torch.Tensor] = []
    specs = [_column_buffers(c, bufs) for c in batch.columns]
    return bufs, (specs, list(batch.names), batch.num_rows, batch.capacity)


def _unflatten(bufs: List[torch.Tensor], spec, device) -> ColumnarBatch:
    specs, names, num_rows, capacity = spec
    it = iter(bufs)
    cols = [_column_from(s, it) for s in specs]
    return ColumnarBatch(cols, names, num_rows, device, capacity=capacity)


def batch_nbytes(batch: ColumnarBatch) -> int:
    """Bytes of every buffer of the batch."""
    bufs, _ = _flatten(batch)
    return sum(t.numel() * t.element_size() for t in bufs)


def _to_host(bufs: List[torch.Tensor]):
    """Host copies of the buffers and the CUDA event that says they are
    complete (None for a CPU batch, whose copies are done on return)."""
    if not bufs or bufs[0].device.type != "cuda":
        return [t.clone() for t in bufs], None
    host = []
    for t in bufs:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return host, done


class SpillableBatch:
    """A columnar batch registered for spill (SpillableColumnarBatch).

    States: device (accounted against the budget), host (pinned tensors
    for a CUDA batch), disk (one file per buffer). ``get()``
    re-materializes on the batch's device; ``close()`` releases
    whatever tier holds it.
    """

    __slots__ = ("_batch", "_host", "_host_done", "_spec", "_paths",
                 "_nbytes", "priority", "_lock", "_catalog", "handle",
                 "closed", "_device", "creation_stack", "_crcs", "owner")

    def __init__(self, batch: ColumnarBatch,
                 priority: SpillPriority = SpillPriority.ACTIVE_ON_DECK,
                 catalog: Optional["SpillCatalog"] = None):
        self._nbytes = batch_nbytes(batch)
        self._catalog = catalog or spill_catalog()
        # budget-slice owner: the query whose thread registered this
        # batch; reserve and release always pair on it
        self.owner: Optional[str] = current_query_id()
        self._catalog.budget.reserve(self._nbytes, owner=self.owner)
        self._batch: Optional[ColumnarBatch] = batch
        self._device = batch.device
        self._host: Optional[List[torch.Tensor]] = None
        self._host_done = None
        self._spec = None
        self._paths: Optional[List[str]] = None
        self._crcs = None  # per-buffer checksums taken at spill time
        self.priority = priority
        self._lock = threading.Lock()
        self.closed = False
        self.creation_stack: Optional[str] = None
        if self._catalog.leak_detection:
            self.creation_stack = "".join(traceback.format_stack(limit=12))
        self.handle = self._catalog.register(self)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def num_rows(self) -> int:
        with self._lock:
            if self.closed:
                raise ValueError("SpillableBatch used after close")
            if self._batch is not None:
                return self._batch.num_rows
            return self._spec[2]

    @property
    def tier(self) -> str:
        if self._batch is not None:
            return "device"
        if self._host is not None:
            return "host"
        if self._paths is not None:
            return "disk"
        return "closed"

    def _wait_host(self) -> None:
        if self._host_done is not None:
            self._host_done.synchronize()
            self._host_done = None

    def spill_to_host(self) -> int:
        """Device -> host. Returns device bytes freed."""
        with self._lock:
            if self._batch is None or self.closed:
                return 0
            t0 = time.perf_counter_ns()
            bufs, self._spec = _flatten(self._batch)
            self._host, self._host_done = _to_host(bufs)
            if self._catalog.verify_checksums:
                # checksum every buffer the moment it leaves the device:
                # the host and disk tiers both verify against these
                self._wait_host()
                self._crcs = [array_checksum(h.numpy()) for h in self._host]
            self._batch = None
            del bufs
            self._catalog.budget.release(self._nbytes, owner=self.owner)
            ctx = task_context()
            ctx.spilled_bytes += self._nbytes
            ctx.spill_time_ns += time.perf_counter_ns() - t0
            return self._nbytes

    def spill_to_disk(self) -> int:
        """Host -> disk, one file per buffer. Returns host bytes freed."""
        with self._lock:
            if self._host is None or self.closed:
                return 0
            self._wait_host()
            d = self._catalog.disk_dir()
            paths = []
            try:
                for h in self._host:
                    fd, path = tempfile.mkstemp(suffix=".buf", dir=d)
                    paths.append((path, h.dtype, tuple(h.shape)))
                    with os.fdopen(fd, "wb") as f:
                        f.write(h.numpy().tobytes())
            except OSError:
                self._paths = paths
                self._drop_files()
                raise
            self._paths = paths
            self._host = None
            return self._nbytes

    def _load_disk(self) -> List[torch.Tensor]:
        host = []
        for path, dtype, shape in self._paths:
            raw = np.fromfile(path, dtype=np.uint8)
            want = int(np.prod(shape)) * torch.empty(
                0, dtype=dtype).element_size()
            if raw.nbytes != want:
                raise ValueError(f"{path}: {raw.nbytes} bytes, expected "
                                 f"{want}")
            host.append(torch.from_numpy(raw).view(dtype).reshape(shape))
        return host

    def get(self) -> ColumnarBatch:
        """Re-materialize on the device (unspillBufferToDeviceStore,
        RapidsBufferCatalog.scala:633).

        The host or disk copy is dropped only once every buffer is back
        on the device: an allocator OOM in the copies leaves the batch
        in its tier, with its reservation released, for a retry.
        budget.reserve runs outside self._lock: its spill callback may
        call back into this object."""
        with self._lock:
            if self.closed:
                raise ValueError("SpillableBatch used after close")
            if self._batch is not None:
                return self._batch
        self._catalog.budget.reserve(self._nbytes, owner=self.owner)
        try:
            with self._lock:
                if self.closed:
                    raise ValueError("SpillableBatch used after close")
                if self._batch is not None:
                    # another thread brought it back meanwhile
                    self._catalog.budget.release(self._nbytes,
                                                 owner=self.owner)
                    return self._batch
                if self._host is None:
                    # a file that fails to even read back whole is at-rest
                    # corruption, as a checksum mismatch is
                    try:
                        host = self._load_disk()
                    except (OSError, ValueError) as e:
                        raise DataCorruption(
                            f"spill entry handle={self.handle} unreadable "
                            f"at re-materialization: {type(e).__name__}: "
                            f"{e}", detail="entry dropped; recompute the "
                            "batch") from e
                else:
                    self._wait_host()
                    host = self._host
                self._verify_host(host)
                dev = [h.to(self._device, non_blocking=True) for h in host]
                self._batch = _unflatten(dev, self._spec, self._device)
                self._host = None
                self._drop_files()
                return self._batch
        except DataCorruption:
            # the entry's bytes are gone for good: drop it, so a retry
            # cannot re-read garbage; the caller recomputes the batch
            with self._lock:
                self.closed = True
                self._host = None
                self._drop_files()
            self._catalog.budget.release(self._nbytes, owner=self.owner)
            self._catalog.unregister(self.handle)
            raise
        except BaseException:
            self._catalog.budget.release(self._nbytes, owner=self.owner)
            raise

    def _verify_host(self, host: List[torch.Tensor]) -> None:
        """Checksums of the host or disk copy against those taken when
        the buffers left the device."""
        if self._crcs is None:
            return
        for idx, (h, crc) in enumerate(zip(host, self._crcs)):
            actual = array_checksum(h.numpy())
            if actual != crc:
                raise DataCorruption(
                    f"spill entry handle={self.handle} buffer={idx} "
                    f"failed verification at re-materialization",
                    expected=crc, actual=actual,
                    detail="entry dropped; recompute the batch")

    def _drop_files(self) -> None:
        for path, _, _ in self._paths or ():
            try:
                os.unlink(path)
            except OSError:
                pass
        self._paths = None

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self._batch is not None:
                self._catalog.budget.release(self._nbytes,
                                             owner=self.owner)
                self._batch = None
            self._host = None
            self._host_done = None
            self._drop_files()
        self._catalog.unregister(self.handle)


class SpillCatalog:
    """Handle registry and spill policy (RapidsBufferCatalog.scala:62).

    ``synchronous_spill(n)`` frees at least n device bytes by spilling
    registered batches in priority order, then pushes host-tier overflow
    to disk when the host limit is exceeded.
    """

    def __init__(self, budget: Optional[MemoryBudget] = None,
                 host_limit: Optional[int] = None,
                 spill_dir: Optional[str] = None, conf=None,
                 device=None):
        from ..conf import (HOST_SPILL_LIMIT, INTEGRITY_CHECKSUM,
                            LEAK_DETECTION, SPILL_DIR, SrtConf)
        conf = conf or SrtConf()
        self.budget = budget or device_budget(conf, device)
        self.budget.set_spill_callback(self.synchronous_spill)
        self.host_limit = host_limit or conf.get(HOST_SPILL_LIMIT)
        self.verify_checksums = conf.get(INTEGRITY_CHECKSUM)
        self.leak_detection = conf.get(LEAK_DETECTION)
        # disk-tier files live in a per-process directory under the
        # configured root, made at the first disk spill: this process
        # removes it at exit, and a directory whose process is gone is
        # swept then
        self.spill_root = spill_dir or conf.get(SPILL_DIR)
        self.spill_dir: Optional[str] = None
        self._entries: Dict[int, SpillableBatch] = {}
        self._next = 0
        self._lock = threading.Lock()

    def disk_dir(self) -> str:
        with self._lock:
            if self.spill_dir is None:
                os.makedirs(self.spill_root, exist_ok=True)
                sweep_stale_spill_dirs(self.spill_root)
                self.spill_dir = tempfile.mkdtemp(
                    prefix=f"session-{os.getpid()}-", dir=self.spill_root)
                atexit.register(_remove_session_dir, self.spill_dir)
            return self.spill_dir

    def register(self, sb: SpillableBatch) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._entries[h] = sb
            return h

    def unregister(self, handle: int) -> None:
        with self._lock:
            self._entries.pop(handle, None)

    def device_candidates(self) -> List[SpillableBatch]:
        with self._lock:
            return sorted(
                (e for e in self._entries.values() if e.tier == "device"),
                key=lambda e: (e.priority, -e.nbytes))

    def synchronous_spill(self, target_bytes: int,
                          requester: Optional[str] = None,
                          active_owners=None) -> int:
        """Free >= target_bytes of device memory if possible
        (RapidsBufferCatalog.synchronousSpill:589). Batches of another
        live query (``active_owners``, other than ``requester``) are left
        alone."""
        freed = 0
        for e in self.device_candidates():
            if freed >= target_bytes:
                break
            owner = e.owner
            if (active_owners and owner is not None
                    and owner != requester and owner in active_owners):
                continue  # another live query's slice: not evictable
            freed += e.spill_to_host()
        self._enforce_host_limit()
        return freed

    def _host_used(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.tier == "host")

    def _enforce_host_limit(self) -> None:
        used = self._host_used()
        if used <= self.host_limit:
            return
        with self._lock:
            host = sorted((e for e in self._entries.values()
                           if e.tier == "host"),
                          key=lambda e: (e.priority, -e.nbytes))
        for e in host:
            if used <= self.host_limit:
                break
            used -= e.spill_to_disk()

    def leak_report(self) -> List[dict]:
        """Entries still registered: each is a leaked (never closed)
        spillable. With srt.memory.leakDetection.enabled the creation
        stack names its owner."""
        with self._lock:
            entries = list(self._entries.values())
        return [{"handle": e.handle, "tier": e.tier,
                 "nbytes": e.nbytes, "priority": int(e.priority),
                 "creation_stack": e.creation_stack}
                for e in entries if not e.closed]

    def log_leaks(self) -> int:
        leaks = self.leak_report()
        log = logging.getLogger("spark_rapids_tpu_torch.memory")
        for lk in leaks:
            log.warning(
                "LEAKED SpillableBatch handle=%s tier=%s bytes=%d%s",
                lk["handle"], lk["tier"], lk["nbytes"],
                ("\n" + lk["creation_stack"])
                if lk["creation_stack"] else "")
        return len(leaks)


_SESSION_DIR_RE = re.compile(r"^session-(\d+)-")


def _remove_session_dir(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists but not ours (EPERM etc.)
    return True


def sweep_stale_spill_dirs(base: str) -> int:
    """Remove session spill directories whose process is gone (killed
    before its atexit cleanup ran). Returns how many were swept."""
    try:
        names = os.listdir(base)
    except OSError:
        return 0
    swept = 0
    for name in names:
        m = _SESSION_DIR_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
        swept += 1
    return swept


_CATALOG: Optional[SpillCatalog] = None
_CAT_LOCK = threading.Lock()


def spill_catalog(conf=None, device=None) -> SpillCatalog:
    """The process-wide catalog, made on first use (over
    ``device_budget(conf, device)``)."""
    global _CATALOG
    with _CAT_LOCK:
        if _CATALOG is None:
            _CATALOG = SpillCatalog(conf=conf, device=device)
        return _CATALOG


def reset_spill_catalog(**kwargs) -> SpillCatalog:
    """A fresh catalog (optionally over a fresh budget)."""
    global _CATALOG
    with _CAT_LOCK:
        _CATALOG = SpillCatalog(**kwargs)
        return _CATALOG
