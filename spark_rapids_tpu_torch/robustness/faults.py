"""Deterministic, seeded fault injection.

Counterpart of spark_rapids_tpu/robustness/faults.py, copied with its
grammar and its seeded decisions, so one spec fires the same faults at
the same hits in both packages: named ``fault_point("site")`` hooks and
a seeded ``FaultPlan`` that decides, reproducibly, which hits fire
which fault. The sites in this port are the Delta commit protocol's
(``delta.stage``, ``delta.rename``, ``delta.commit``,
``delta.commit.fsync``, ``delta.checkpoint``,
``delta.checkpoint.bytes``) and the scan's ``scan.file``; the JAX
package's transport, cluster and shuffle sites come with ROADMAP A10.
The memory layer injects its OOMs through its own counters
(memory/budget.py).

Design contract:

- **Zero overhead unarmed.** ``fault_point`` is a module-global ``None``
  check when no plan is armed; production code pays one attribute load
  and a compare per site hit.
- **Deterministic.** Firing decisions come from a per-plan
  ``random.Random(seed)`` plus exact hit counters — re-running the same
  workload with the same spec replays the same faults (seeded-replay
  tests assert on ``plan.log``).
- **Conf-activated.** ``srt.test.faultPlan`` (an internal string conf)
  arms a plan in the process that reads it (``arm_from_conf``), as the
  Delta ingester child does (delta/streaming.py).

Spec grammar (clauses joined by ``|``; first clause may be ``seed=N``)::

    site ':' kind ['@' nth] ['%' prob] ['*' count] ['+' delay_s] ['~' match]

- ``kind``: ``refuse`` (ConnectionRefusedError), ``reset``
  (ConnectionResetError), ``delay`` (sleep ``delay_s``), ``crash``
  (``os._exit(137)``), ``retry_oom`` / ``split_oom`` (RetryOOM /
  SplitAndRetryOOM), ``drop`` (FaultDrop — sites that poll, e.g. the
  heartbeat loop, treat it as "skip this beat"), ``corrupt`` /
  ``truncate`` (data corruption: at a data-bearing
  ``corrupt_point(site, data)`` the bytes are deterministically
  byte-flipped / tail-truncated; at a plain ``fault_point`` site both
  raise ``DataCorruption`` — a file that reads as garbage).
- ``@nth`` fires on exactly the nth *matching* hit (1-based);
  ``%prob`` fires each matching hit with probability ``prob`` from the
  plan's seeded RNG. Exactly one of the two; ``@1`` assumed otherwise.
- ``*count`` caps total fires for the clause (default 1).
- ``~match`` (must be last): substring filter against the hit's detail
  string (or the current operator scope when the site passes none).

Example: a crash at the third durable commit's fsync, and a flipped
byte in the first checkpoint written::

    seed=13|delta.commit.fsync:crash@3|delta.checkpoint.bytes:corrupt@1
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


class FaultDrop(Exception):
    """Raised by ``drop`` faults; polling sites catch it and skip one
    iteration (e.g. a heartbeat beat) instead of failing."""


@dataclass
class FaultSpec:
    site: str
    kind: str                    # refuse|reset|delay|crash|retry_oom|split_oom|drop
    nth: Optional[int] = None    # fire on the nth matching hit (1-based)
    prob: float = 0.0            # else: fire each matching hit w.p. prob
    count: int = 1               # max total fires for this clause
    delay_s: float = 0.05        # sleep for kind == "delay"
    match: str = ""              # substring filter on the hit detail

    _KINDS = ("refuse", "reset", "delay", "crash", "retry_oom",
              "split_oom", "drop", "corrupt", "truncate")
    #: kinds that mutate data at corrupt_point sites (all other kinds
    #: are ignored there; at plain fault_point sites these raise
    #: DataCorruption instead)
    _DATA_KINDS = ("corrupt", "truncate")

    @classmethod
    def parse(cls, clause: str) -> "FaultSpec":
        body = clause.strip()
        match = ""
        if "~" in body:
            body, match = body.split("~", 1)
        if ":" not in body:
            raise ValueError(f"fault clause needs site:kind — {clause!r}")
        site, rest = body.split(":", 1)
        spec = cls(site=site.strip(), kind="", match=match)
        # kind runs until the first modifier char
        i = 0
        while i < len(rest) and rest[i] not in "@%*+":
            i += 1
        spec.kind = rest[:i].strip()
        if spec.kind not in cls._KINDS:
            raise ValueError(f"unknown fault kind {spec.kind!r} in "
                             f"{clause!r} (expected one of {cls._KINDS})")
        rest = rest[i:]
        while rest:
            mod, rest = rest[0], rest[1:]
            j = 0
            while j < len(rest) and rest[j] not in "@%*+":
                j += 1
            val, rest = rest[:j], rest[j:]
            if mod == "@":
                spec.nth = int(val)
            elif mod == "%":
                spec.prob = float(val)
            elif mod == "*":
                spec.count = int(val)
            elif mod == "+":
                spec.delay_s = float(val)
        if spec.nth is None and spec.prob <= 0.0:
            spec.nth = 1
        return spec

    def unparse(self) -> str:
        out = f"{self.site}:{self.kind}"
        if self.nth is not None:
            out += f"@{self.nth}"
        elif self.prob > 0.0:
            out += f"%{self.prob}"
        if self.count != 1:
            out += f"*{self.count}"
        if self.kind == "delay" and self.delay_s != 0.05:
            out += f"+{self.delay_s}"
        if self.match:
            out += f"~{self.match}"
        return out


@dataclass
class FaultEvent:
    """One fired fault — ``plan.log`` entries for seeded-replay asserts."""
    site: str
    kind: str
    detail: str
    hit: int                     # which matching hit fired (1-based)
    pid: int = field(default_factory=os.getpid)


class FaultPlan:
    """A set of FaultSpecs plus the seeded state deciding which site
    hits fire. One plan per process; hit counters persist across jobs in
    the same process (so a crash clause that fired in attempt 0 does not
    re-fire on the surviving workers' attempt 1)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits = [0] * len(self.specs)
        self._fires = [0] * len(self.specs)
        self.log: List[FaultEvent] = []
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec_str: str) -> "FaultPlan":
        seed = 0
        specs = []
        for clause in spec_str.split("|"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[len("seed="):])
                continue
            specs.append(FaultSpec.parse(clause))
        return cls(specs, seed=seed)

    def spec_string(self) -> str:
        return "|".join([f"seed={self.seed}"]
                        + [s.unparse() for s in self.specs])

    def fired(self, site: Optional[str] = None) -> List[FaultEvent]:
        with self._lock:
            return [e for e in self.log if site is None or e.site == site]

    def _note(self, ev: FaultEvent) -> None:
        """Record a fired fault in the replay log AND the observability
        event log. Called with the plan lock held, BEFORE the fault
        actually fires — the event writer flushes per line, so even a
        ``crash`` clause (os._exit) leaves its FaultInjected on disk."""
        self.log.append(ev)
        from ..obs import events as _events
        _events.emit("FaultInjected", site=ev.site, kind=ev.kind,
                     detail=ev.detail, hit=ev.hit, seed=self.seed)

    def hit(self, site: str, detail: Optional[str]) -> None:
        to_fire: Optional[FaultSpec] = None
        hit_no = 0
        ref = detail if detail is not None else current_op()
        with self._lock:
            for i, sp in enumerate(self.specs):
                if sp.site != site:
                    continue
                if sp.match and sp.match not in ref:
                    continue
                self._hits[i] += 1
                if self._fires[i] >= sp.count:
                    continue
                if sp.nth is not None:
                    fire = self._hits[i] == sp.nth
                else:
                    fire = self._rng.random() < sp.prob
                if not fire:
                    continue
                self._fires[i] += 1
                hit_no = self._hits[i]
                to_fire = sp
                self._note(FaultEvent(site, sp.kind, ref, hit_no))
                break
        if to_fire is not None:
            self._fire(to_fire, site, ref)

    def _fire(self, sp: FaultSpec, site: str, ref: str) -> None:
        msg = f"[fault-injection] {sp.kind} at {site} ({ref})"
        if sp.kind == "refuse":
            raise ConnectionRefusedError(msg)
        if sp.kind == "reset":
            raise ConnectionResetError(msg)
        if sp.kind == "delay":
            time.sleep(sp.delay_s)
            return
        if sp.kind == "drop":
            raise FaultDrop(msg)
        if sp.kind == "retry_oom":
            from ..memory.budget import RetryOOM
            raise RetryOOM(msg)
        if sp.kind == "split_oom":
            from ..memory.budget import SplitAndRetryOOM
            raise SplitAndRetryOOM(msg)
        if sp.kind in FaultSpec._DATA_KINDS:
            # a corrupt/truncate clause armed on a plain (non-data)
            # fault site models a file/entry that reads as garbage
            from .integrity import DataCorruption
            raise DataCorruption(msg)
        if sp.kind == "crash":
            print(msg, file=sys.stderr, flush=True)
            os._exit(137)

    def mutate(self, site: str, data, detail: Optional[str]):
        """corrupt_point dispatch: find the first armed corrupt/truncate
        clause matching this data-bearing site hit and apply it. The
        flip position comes from the plan's seeded RNG, so replays with
        the same spec over the same workload corrupt the same byte;
        every mutation is recorded in ``plan.log`` with its position."""
        to_fire: Optional[FaultSpec] = None
        hit_no = 0
        ref = detail if detail is not None else current_op()
        with self._lock:
            for i, sp in enumerate(self.specs):
                if sp.site != site or sp.kind not in FaultSpec._DATA_KINDS:
                    continue
                if sp.match and sp.match not in ref:
                    continue
                self._hits[i] += 1
                if self._fires[i] >= sp.count:
                    continue
                if sp.nth is not None:
                    fire = self._hits[i] == sp.nth
                else:
                    fire = self._rng.random() < sp.prob
                if not fire:
                    continue
                self._fires[i] += 1
                hit_no = self._hits[i]
                to_fire = sp
                break
            if to_fire is None:
                return data
            n = int(data.nbytes) if hasattr(data, "nbytes") else len(data)
            if n == 0:
                self._note(FaultEvent(site, to_fire.kind,
                                      f"{ref};empty;", hit_no))
                return data
            if to_fire.kind == "truncate":
                cut = max(n // 2, 1) if n > 1 else 0
                self._note(FaultEvent(site, "truncate",
                                      f"{ref};cut={cut};", hit_no))
                return data[:cut]
            pos = self._rng.randrange(n)
            self._note(FaultEvent(site, "corrupt",
                                  f"{ref};byte={pos};", hit_no))
            if hasattr(data, "dtype"):   # numpy array: mutate in place
                import numpy as np
                if not data.flags.writeable:
                    # device->host leaves can be read-only views; the
                    # caller must adopt the returned copy
                    data = data.copy()
                if data.flags["C_CONTIGUOUS"]:
                    data.view(np.uint8).reshape(-1)[pos] ^= 0xFF
                else:   # rare: perturb one element instead
                    idx = tuple(np.unravel_index(pos % data.size,
                                                 data.shape))
                    data[idx] = data[idx] + type(data[idx].item())(1)
                return data
            out = bytearray(data)
            out[pos] ^= 0xFF
            return bytes(out)


_PLAN: Optional[FaultPlan] = None
_SCOPE = threading.local()


def fault_point(site: str, detail: Optional[str] = None) -> None:
    """Hook call at a named fault site. No-op (one global load + `is`
    compare) unless a plan is armed in this process."""
    if _PLAN is None:
        return
    _PLAN.hit(site, detail)


def corrupt_point(site: str, data, detail: Optional[str] = None):
    """Data-bearing fault hook: returns ``data`` unchanged (one global
    load + `is` compare) unless an armed plan has a ``corrupt`` /
    ``truncate`` clause matching this site hit, in which case the
    returned bytes are deterministically mutated (numpy arrays are
    mutated in place). Non-data fault kinds never fire here."""
    if _PLAN is None:
        return data
    return _PLAN.mutate(site, data, detail)


def armed() -> bool:
    return _PLAN is not None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def arm_fault_plan(plan: "FaultPlan | str") -> FaultPlan:
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _PLAN = plan
    return plan


def disarm_fault_plan() -> None:
    global _PLAN
    _PLAN = None


def arm_from_conf(conf) -> Optional[FaultPlan]:
    """Arm (or keep, or disarm) the process plan from an SrtConf. The
    SAME spec keeps the existing plan — hit/fire counters must survive
    job retries within one worker process so one-shot clauses stay
    one-shot across attempts."""
    from ..conf import FAULT_PLAN_SPEC
    spec = conf.get(FAULT_PLAN_SPEC)
    global _PLAN
    if not spec:
        _PLAN = None
        return None
    if _PLAN is not None and _PLAN.spec_string() == \
            FaultPlan.parse(spec).spec_string():
        return _PLAN
    _PLAN = FaultPlan.parse(spec)
    return _PLAN


class op_scope:
    """Context manager tagging the current thread with a scope name: a
    hit whose site passes no detail matches ``~match`` against it. (The
    JAX package's operators enter it for its memory site; the port's
    sites all pass a detail.)"""

    __slots__ = ("name", "prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev = getattr(_SCOPE, "op", "")
        _SCOPE.op = self.name
        return self

    def __exit__(self, *exc):
        _SCOPE.op = self.prev
        return False


def current_op() -> str:
    return getattr(_SCOPE, "op", "")
