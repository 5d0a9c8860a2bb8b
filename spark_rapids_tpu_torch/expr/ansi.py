"""ANSI mode: the plan rewrite and the runtime guards.

Counterpart of spark_rapids_tpu/expr/ansi.py. ``srt.sql.ansi.enabled``
flows from the session into the plan here: ``rewrite_plan`` clones a
logical plan with ``ansi=True`` on every node that owns an ANSI lane
(Cast, binary and unary arithmetic, SUM and AVG), and those nodes'
guards raise the Spark error types (expr/errors.py) where the non-ANSI
lanes give NULL or wrap.

A guard fires only for rows that reach its node, as Spark evaluates
them: a conditional (``If``, ``CaseWhen``, ``Coalesce``, ``Nvl2``) and
the right side of ``AND`` / ``OR`` bind the rows they select with
``reach``, and ``guard`` masks its flags with them. The JAX package's
guards see every row of the batch (its ``CaseWhen`` escapes them only
because the rewrite misses the branches it keeps beside its children;
``raise_error`` fires under a branch no row selects, ROADMAP C18).

A guard costs no host sync where it is raised: inside an operator
(exec/base.py ``TpuExec.execute``) the flags of every guard the
operator's batch evaluates are gathered and read with one ``.item()``
when the batch is done (``deferred`` / ``flush``); outside one, a
guard reads its flag at once. The CPU engine's guards take numpy masks
and raise at once.
"""

from __future__ import annotations

import contextlib
import copy
import threading

import numpy as np
import torch

_CTX = threading.local()


def _owns_ansi_lane(expr) -> bool:
    from .aggregates import Average, Sum
    from .arithmetic import Abs, BinaryArithmetic, UnaryMinus
    from .cast import Cast
    return isinstance(expr, (Cast, BinaryArithmetic, UnaryMinus, Abs,
                             Sum, Average))


def _remap(value, mapping):
    """``value`` with every original child replaced by its clone,
    through lists, tuples and dicts (a CaseWhen's ``branches``)."""
    if isinstance(value, list):
        return [_remap(v, mapping) for v in value]
    if isinstance(value, tuple):
        return tuple(_remap(v, mapping) for v in value)
    return mapping.get(id(value), value)


def enable_ansi(expr):
    """Deep-cloned tree with ``ansi=True`` on every supported node. An
    attribute that holds children beside ``children`` (a CaseWhen's
    branches, its ``otherwise``) takes the clones too."""
    from .core import Expression
    clone = copy.copy(expr)
    clone.children = [enable_ansi(c) for c in expr.children]
    mapping = {id(o): n for o, n in zip(expr.children, clone.children)}
    for k, v in vars(expr).items():
        if k != "children" and (isinstance(v, (list, tuple)) or
                                isinstance(v, Expression)):
            setattr(clone, k, _remap(v, mapping))
    if _owns_ansi_lane(clone):
        clone.ansi = True
    return clone


def rewrite_plan(plan):
    """Clone a LOGICAL plan with every embedded expression ansi-marked.

    Generic over node fields: any Expression (or list / tuple / dict of
    them, or a SortField-like holding ``.expr``) found in ``vars(node)``
    is rewritten, the arguments a node is rebuilt from
    (``_built_from``) included; children recurse. Unknown containers
    are left alone: a field the walk misses keeps the non-ANSI (null /
    wrap) semantics rather than corrupting the plan."""
    from .core import Expression

    def rw_val(v):
        if isinstance(v, Expression):
            return enable_ansi(v)
        if isinstance(v, list):
            return [rw_val(x) for x in v]
        if isinstance(v, tuple):
            return tuple(rw_val(x) for x in v)
        if isinstance(v, dict):
            return {k: rw_val(x) for k, x in v.items()}
        if isinstance(getattr(v, "expr", None), Expression):
            c = copy.copy(v)
            c.expr = enable_ansi(v.expr)
            return c
        return v

    node = copy.copy(plan)
    for k, v in vars(plan).items():
        if k != "children":
            setattr(node, k, rw_val(v))
    node.children = [rewrite_plan(c) for c in getattr(plan, "children", ())]
    if hasattr(plan, "_built_from"):
        args, kwargs = plan._built_from
        n = len(plan.children)
        node._built_from = (tuple(args[:n]) + rw_val(tuple(args[n:])),
                            rw_val(kwargs))
    return node


def has_guards(expr) -> bool:
    """Whether a node of the tree can raise per row (an ansi-marked
    node or ``raise_error``): only then does a conditional bind the
    rows its branches reach."""
    from .misc import RaiseError
    if getattr(expr, "ansi", False) or isinstance(expr, RaiseError):
        return True
    return any(has_guards(c) for c in expr.children)


# --- the rows that reach a node ---------------------------------------------

def _stack():
    s = getattr(_CTX, "reach", None)
    if s is None:
        s = _CTX.reach = []
    return s


def reached(key):
    """The rows of ``key`` (a batch, or a CPU-engine table) that reach
    the node being evaluated, or None for every row."""
    s = _stack()
    if s and s[-1][0] is key:
        return s[-1][1]
    return None


def evaluate_reached(expr, key, rows, run):
    """``run(expr)`` with ``rows`` bound as the rows of ``key`` that reach
    ``expr``; a tree without a guard runs unbound."""
    if not has_guards(expr):
        return run(expr)
    with reach(key, rows):
        return run(expr)


@contextlib.contextmanager
def reach(key, mask):
    """Bind ``mask`` (within the rows already bound) as the rows of
    ``key`` that reach the subtree evaluated inside."""
    prev = reached(key)
    s = _stack()
    s.append((key, mask if prev is None else prev & mask))
    try:
        yield
    finally:
        s.pop()


# --- guards -----------------------------------------------------------------

def guard(mask, exc: Exception, key=None) -> None:
    """Raise ``exc`` if a row of ``mask`` that reaches the node (``key``
    its batch or table) is set. A torch flag inside an operator is read
    when the operator's batch is done; otherwise at once."""
    r = reached(key) if key is not None else None
    if r is not None:
        mask = mask & r
    if isinstance(mask, np.ndarray):
        if bool(np.any(mask)):
            raise exc
        return
    pending = getattr(_CTX, "pending", None)
    if pending is None:
        if bool(mask.any()):
            raise exc
        return
    pending.append((mask.any(), exc))


def flush(pending) -> None:
    """Read the gathered flags with one host sync; raise the first
    guard's error that fired (evaluation order)."""
    if not pending:
        return
    flags = torch.stack([f for f, _ in pending])
    if bool(flags.any()):
        first = int(torch.nonzero(flags)[0, 0])
        exc = pending[first][1]
        pending.clear()
        raise exc
    pending.clear()


@contextlib.contextmanager
def deferred():
    """Gather the guards raised inside and read them once at the end.
    An error raised inside gives way to a guard that fired before it
    (the guard's row came first; a later step may have met its
    value)."""
    prev = getattr(_CTX, "pending", None)
    pending = _CTX.pending = []
    try:
        yield
    except BaseException:
        _CTX.pending = prev
        flush(pending)
        raise
    _CTX.pending = prev
    flush(pending)
