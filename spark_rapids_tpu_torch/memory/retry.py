"""Split-and-retry OOM handling.

Counterpart of spark_rapids_tpu/memory/retry.py (the reference's
RmmRapidsRetryIterator): ``with_retry`` / ``with_retry_no_split`` /
``with_restore_on_retry`` plus ``split_spillable_in_half_by_rows``.
Attempt the body; on RetryOOM spill and retry at the same size; on
SplitAndRetryOOM split the input and retry the halves.

The OOMs come from the MemoryBudget (budget.py), from the test
injection, and on the card from the CUDA caching allocator: a
``torch.cuda.OutOfMemoryError`` raised inside a retry block becomes a
``DeviceOOM`` (a RetryOOM) here and nowhere else. The allocator has
already released its free cached blocks when it raises, and does not
say how much it lacked, so the block empties the cache and
spills every registered device batch before it runs the body again at
the same size; a second device OOM of the same attempt splits it
(``with_retry``) or is retried up to the limit (``with_retry_no_split``).
On the card a retry block's allocations go to the caching allocator,
which the budget does not see; so each attempt of ``with_retry`` counts
as one allocation attempt of the task, where an injected OOM lands as a
real one would.

Retry and split counts go into the TaskContext and, where the caller
passes them, into its operator's metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, TypeVar, Union

import torch

from .budget import RetryOOM, SplitAndRetryOOM, task_context
from .spill import SpillableBatch, spill_catalog

R = TypeVar("R")

#: spill target after a device OOM: every registered device batch
_EVERYTHING = 1 << 62
_MAX_RETRIES = 8
#: srt.memory.retry.maxSplits's default, for callers without a conf
_DEFAULT_MAX_SPLITS = 8


class DeviceOOM(RetryOOM):
    """The CUDA caching allocator failed inside a retry block."""


def _call(fn, *args):
    """``fn(*args)``, with a CUDA allocator failure raised as DeviceOOM
    once the failed frames, and the device tensors they hold, are
    released (raised outside the handler, so nothing chains to them)."""
    try:
        return fn(*args)
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e).splitlines()[0] if str(e) else "CUDA out of memory"
    raise DeviceOOM(msg)


def _relieve(err: BaseException, target: int) -> int:
    """Spill before a retry; returns the device bytes freed."""
    if isinstance(err, DeviceOOM):
        torch.cuda.empty_cache()
        target = _EVERYTHING
    return spill_catalog().synchronous_spill(target)


def _count(counters: Optional[Dict], name: str) -> None:
    if counters is not None:
        counters[name].add(1)


def split_spillable_in_half_by_rows(sb: SpillableBatch
                                    ) -> List[SpillableBatch]:
    """The standard split policy (splitSpillableInHalfByRows,
    RmmRapidsRetryIterator.scala:~447): halve by row count."""
    from ..columnar.vector import choose_capacity
    from ..ops.kernels import slice_batch

    batch = sb.get()
    n = batch.num_rows
    if n <= 1:
        raise SplitAndRetryOOM(
            f"cannot split a batch of {n} rows any further")
    half = n // 2
    lo = slice_batch(batch, 0, half, choose_capacity(half))
    hi = slice_batch(batch, half, n - half, choose_capacity(n - half))
    del batch
    lo_sb = SpillableBatch(lo, sb.priority)
    try:
        hi_sb = SpillableBatch(hi, sb.priority)
    except BaseException:
        lo_sb.close()
        raise
    sb.close()
    return [lo_sb, hi_sb]


def with_retry(
    inputs: Union[SpillableBatch, List[SpillableBatch]],
    fn: Callable[[SpillableBatch], R],
    split_policy: Callable[[SpillableBatch], List[SpillableBatch]] = None,
    max_splits: int = _DEFAULT_MAX_SPLITS,
    counters: Optional[Dict] = None,
) -> Iterator[R]:
    """Run ``fn`` over each input with retry and optional split on OOM.

    Yields one result per (possibly split) attempt. Inputs are consumed:
    each SpillableBatch is closed by fn or by the split. Mirrors
    ``withRetry`` (RmmRapidsRetryIterator.scala:33). ``counters`` maps
    ``retryCount`` and ``splitAndRetryCount`` to the operator's
    metrics.
    """
    pending: List[SpillableBatch] = (
        list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
    ctx = task_context()
    splits_done = 0
    retries_this_attempt = 0

    def close_all(attempt):
        attempt.close()
        for p in pending:
            p.close()

    def split(attempt, why: str) -> None:
        nonlocal splits_done, retries_this_attempt
        retries_this_attempt = 0
        if split_policy is None:
            close_all(attempt)
            raise SplitAndRetryOOM(why)
        if splits_done >= max_splits:
            close_all(attempt)
            raise SplitAndRetryOOM(f"still OOM after {splits_done} splits")
        ctx.split_count += 1
        _count(counters, "splitAndRetryCount")
        splits_done += 1
        try:
            halves = split_policy(attempt)
        except BaseException:
            close_all(attempt)
            raise
        pending[:0] = halves

    while pending:
        attempt = pending.pop(0)
        try:
            ctx.on_alloc_attempt()
            result = _call(fn, attempt)
            retries_this_attempt = 0
        except SplitAndRetryOOM as e:
            split(attempt, str(e))
            continue
        except RetryOOM as e:
            if isinstance(e, DeviceOOM) and retries_this_attempt:
                # it repeats past the spill: the attempt is too big
                split(attempt, str(e))
                continue
            ctx.retry_count += 1
            _count(counters, "retryCount")
            retries_this_attempt += 1
            freed = _relieve(e, attempt.nbytes)
            if retries_this_attempt > _MAX_RETRIES or (
                    freed == 0 and retries_this_attempt > 1):
                close_all(attempt)
                raise
            pending.insert(0, attempt)
            continue
        except BaseException:
            close_all(attempt)
            raise
        yield result


def with_retry_no_split(body: Callable[[], R],
                        max_retries: int = _MAX_RETRIES,
                        counters: Optional[Dict] = None) -> R:
    """Retry ``body`` at the same size (withRetryNoSplit). The body must
    be idempotent up to device allocations. It has no input to split,
    so a SplitAndRetryOOM spills and re-runs it too."""
    ctx = task_context()
    last = ""
    for _ in range(max_retries):
        try:
            return _call(body)
        except (RetryOOM, SplitAndRetryOOM) as e:
            ctx.retry_count += 1
            _count(counters, "retryCount")
            last = str(e)
            _relieve(e, 1 << 20)
    raise RetryOOM(f"exhausted {max_retries} retries: {last}")


def retry_each(ctx, exec_id: str, stream,
               fn: Callable[[SpillableBatch], R]) -> Iterator[R]:
    """``fn`` over each non-empty batch of ``stream``, each held as a
    spillable under ``with_retry`` with the halving split policy: the
    per-batch retry block of an operator whose batches are independent
    (a partial aggregate, a hash join's probe side), as the JAX
    package's fused stage and fused join wrap theirs. ``fn`` closes the
    spillable it is given."""
    from ..conf import RETRY_MAX_SPLITS
    counters = ctx.retry_counters(exec_id)
    max_splits = ctx.conf.get(RETRY_MAX_SPLITS)
    for batch in stream:
        if batch.num_rows == 0:
            continue
        sb = with_retry_no_split(
            lambda b=batch: SpillableBatch(b), counters=counters)
        del batch  # the spillable holds it now, so a spill frees it
        yield from with_retry(sb, fn,
                              split_policy=split_spillable_in_half_by_rows,
                              max_splits=max_splits, counters=counters)


class with_restore_on_retry:
    """Context manager: snapshot checkpointable state, restore on OOM
    (withRestoreOnRetry for non-deterministic expressions). The target
    must expose checkpoint()/restore()."""

    def __init__(self, target):
        self.target = target

    def __enter__(self):
        self.target.checkpoint()
        return self.target

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and issubclass(exc_type,
                                               (RetryOOM, SplitAndRetryOOM)):
            self.target.restore()
        return False
