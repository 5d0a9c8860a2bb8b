"""Regex on the device: the JAX package's transpiler, run as DFAs.

Counterpart of spark_rapids_tpu/expr/regex.py. The pattern parser and
its Thompson NFA (``_Parser``, ``CompiledRegex``, ``transpile``) are
copied from the JAX package (pure Python and numpy): they accept the
same Java-flavoured subset and refuse the rest with
``RegexUnsupported`` (backreferences, lookaround, ``\\p`` classes,
named groups, inline flags, interior word boundaries). A refused
pattern, and a ``regexp_replace`` replacement with group references,
runs on the CPU engine through Python's ``re`` (the planner's
``_tag_rlike``, ``_tag_regexp_extract`` and ``_tag_regexp_replace``
read ``device_unsupported``, as the JAX planner does).

The JAX package steps the NFA's state set through every byte of a
padded (rows, width) view. Here each NFA becomes a DFA by subset
construction on the host (``_Dfa``: at most ``MAX_DFA_STATES`` states,
a byte-indexed int32 transition table), and every row walks it over its
own bytes in the Arrow offsets / chars layout: one table gather per
byte position, rows past their length frozen. An unanchored search is a
DFA whose every step re-seeds the start set.

Matching is on UTF-8 bytes, as in the JAX package: a literal of any
width matches, ``.`` and classes consume one byte.

Spans (``regexp_extract``, ``regexp_replace``) follow the JAX package's
leftmost-longest rule, which is Java's leftmost-greedy for the patterns
``check_submatch_supported`` admits (no alternation, no lazy
quantifier, capture groups directly under the top-level
concatenation): a reversed DFA marks where matches start, the leftmost
start is taken, and a forward DFA from it finds the last accepting
position; a group's bounds are the greedy split points between
top-level segments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result

class RegexUnsupported(TypeError):
    """Pattern uses a construct the TPU engine can't run (falls back)."""


# ---------------------------------------------------------------------------
# parser -> AST
# ---------------------------------------------------------------------------

class _Node:
    pass


class _Lit(_Node):  # a byte-set (one consumed byte)
    def __init__(self, byteset: np.ndarray):
        self.byteset = byteset  # (256,) bool


class _Cat(_Node):
    def __init__(self, parts):
        self.parts = parts


class _Alt(_Node):
    def __init__(self, options):
        self.options = options


class _Rep(_Node):
    def __init__(self, child, lo: int, hi: Optional[int]):
        self.child = child
        self.lo = lo
        self.hi = hi  # None = unbounded


_MAX_REP = 32  # {m,n} expansion bound (complexity estimator role)


def _class_of(chars: str) -> np.ndarray:
    b = np.zeros(256, bool)
    for c in chars:
        b[ord(c)] = True
    return b


_D = np.zeros(256, bool)
_D[ord("0"):ord("9") + 1] = True
_W = _class_of("_")
_W[ord("a"):ord("z") + 1] = True
_W[ord("A"):ord("Z") + 1] = True
_W[ord("0"):ord("9") + 1] = True
_S = _class_of(" \t\n\r\f\v")
_DOT = np.ones(256, bool)
_DOT[ord("\n")] = False
_ANY = np.ones(256, bool)

_ESCAPE_CLASSES = {"d": _D, "D": ~_D, "w": _W, "W": ~_W, "s": _S,
                   "S": ~_S}
_ESCAPE_LITERALS = {"t": "\t", "n": "\n", "r": "\r", "f": "\f",
                    "a": "\a", "e": "\x1b", "0": "\0"}


def _rng(lo: str, hi: str) -> np.ndarray:
    out = np.zeros(256, bool)
    out[ord(lo):ord(hi) + 1] = True
    return out


_POSIX_CLASSES = {
    "Lower": _rng("a", "z"),
    "Upper": _rng("A", "Z"),
    "Alpha": _rng("a", "z") | _rng("A", "Z"),
    "Digit": _rng("0", "9"),
    "Alnum": _rng("a", "z") | _rng("A", "Z") | _rng("0", "9"),
    "XDigit": _rng("0", "9") | _rng("a", "f") | _rng("A", "F"),
    "Space": _class_of(" \t\n\x0b\f\r"),
    "Punct": _class_of("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"),
    "Print": _rng(" ", "~"),
    "Graph": _rng("!", "~"),
    "Blank": _class_of(" \t"),
    "Cntrl": _rng("\x00", "\x1f") | _class_of("\x7f"),
    "ASCII": _rng("\x00", "\x7f"),
    # the Unicode names java also accepts, ASCII interpretation
    "L": _rng("a", "z") | _rng("A", "Z"),
    "N": _rng("0", "9"),
    "Nd": _rng("0", "9"),
}


class _Group(_Node):
    """Capturing group (index is 1-based like Java)."""

    def __init__(self, child: _Node, idx: int):
        self.child = child
        self.idx = idx


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.anchored_start = False
        self.anchored_end = False
        self.n_groups = 0
        self.has_alternation = False
        self.has_lazy = False

    def fail(self, why: str):
        raise RegexUnsupported(
            f"regex {self.p!r} at {self.i}: {why}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> _Node:
        if self.peek() == "^":
            self.next()
            self.anchored_start = True
        node = self.alternation(top=True)
        if self.i < len(self.p):
            self.fail("unbalanced ')'")
        # Anchors are simulation-global here, but a top-level alternation
        # scopes them per branch in Java ('a|b$' anchors only 'b') —
        # reject the combination so those patterns fall back to CPU
        # instead of silently matching wrong rows.
        if (self.anchored_start or self.anchored_end) and \
                isinstance(node, _Alt):
            self.fail("anchors with top-level alternation")
        return node

    def alternation(self, top: bool = False) -> _Node:
        options = [self.sequence(top)]
        while self.peek() == "|":
            self.next()
            options.append(self.sequence(top))
        if len(options) > 1:
            self.has_alternation = True
            return _Alt(options)
        return options[0]

    def sequence(self, top: bool = False) -> _Node:
        parts: List[_Node] = []
        while True:
            ch = self.peek()
            if ch is None or ch == "|" or ch == ")":
                break
            if ch == "$":
                # only valid as the final char of the whole pattern
                if top and self.i == len(self.p) - 1:
                    self.next()
                    self.anchored_end = True
                    break
                self.fail("'$' only supported at pattern end")
            parts.append(self.quantified())
        return _Cat(parts)

    def quantified(self) -> _Node:
        atom = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.next()
                atom = _Rep(atom, 0, None)
            elif ch == "+":
                self.next()
                atom = _Rep(atom, 1, None)
            elif ch == "?":
                self.next()
                atom = _Rep(atom, 0, 1)
            elif ch == "{":
                atom = self.bounded_rep(atom)
            else:
                break
            if self.peek() == "?":  # lazy: same language for matching
                self.next()
                self.has_lazy = True
        return atom

    def bounded_rep(self, atom: _Node) -> _Node:
        j = self.p.find("}", self.i)
        if j < 0:
            self.fail("unterminated {")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        try:
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s.strip() else None
            else:
                lo = hi = int(body)
        except ValueError:
            self.fail(f"bad repetition {{{body}}}")
        if lo > _MAX_REP or (hi is not None and hi > _MAX_REP):
            self.fail(f"repetition bound > {_MAX_REP} (state blow-up)")
        return _Rep(atom, lo, hi)

    def atom(self) -> _Node:
        ch = self.next()
        if ch == "(":
            capturing = True
            if self.peek() == "?":
                self.next()
                nxt = self.peek()
                if nxt == ":":
                    self.next()
                    capturing = False
                elif nxt == "<" or nxt == "P":
                    # named group (Java (?<name>...) / python (?P<name>)):
                    # captures by POSITION like Spark's regexp_extract —
                    # the name is only syntax
                    if nxt == "P":
                        self.next()
                    if self.peek() != "<":
                        self.fail("lookaround not supported")
                    self.next()
                    if self.peek() in ("=", "!"):
                        self.fail("lookbehind not supported")
                    while self.peek() not in (">", None):
                        self.next()
                    if self.peek() != ">":
                        self.fail("unterminated group name")
                    self.next()
                else:
                    self.fail("lookaround not supported")
            if capturing:
                self.n_groups += 1
                idx = self.n_groups
            node = self.alternation()
            if self.peek() != ")":
                self.fail("unbalanced '('")
            self.next()
            return _Group(node, idx) if capturing else node
        if ch == "[":
            return _Lit(self.char_class())
        if ch == ".":
            return _Lit(_DOT)
        if ch == "\\":
            return _Lit(self.escape())
        if ch in "*+?{":
            self.fail(f"dangling quantifier {ch!r}")
        if ch == "^":
            self.fail("'^' only supported at pattern start")
        raw = ch.encode("utf-8")
        if len(raw) == 1:
            return _Lit(_class_of(ch))
        # multi-byte literal char: a concatenation of its bytes
        return _Cat([_Lit(_byte_class(b)) for b in raw])

    def escape(self) -> np.ndarray:
        ch = self.next()
        if ch in _ESCAPE_CLASSES:
            return _ESCAPE_CLASSES[ch].copy()
        if ch in _ESCAPE_LITERALS:
            return _class_of(_ESCAPE_LITERALS[ch])
        if ch in "pP":
            # \p{Name} POSIX/ASCII classes (the reference transpiler's
            # supported subset, RegexParser.scala): byte classes over
            # the ASCII range, \P = complement
            if self.peek() != "{":
                self.fail(f"\\{ch} needs {{Name}}")
            self.next()
            name = ""
            while self.peek() not in ("}", None):
                name += self.next()
            if self.peek() != "}":
                self.fail("unterminated \\p{")
            self.next()
            cls = _POSIX_CLASSES.get(name)
            if cls is None:
                self.fail(f"\\p{{{name}}} not supported")
            return ~cls if ch == "P" else cls.copy()
        if ch in "bBAzZGk123456789":
            self.fail(f"\\{ch} not supported")
        if ch == "x":
            hex2 = self.p[self.i:self.i + 2]
            self.i += 2
            return _byte_class(int(hex2, 16))
        return _class_of(ch)  # escaped metachar

    def char_class(self) -> np.ndarray:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        out = np.zeros(256, bool)
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                self.fail("unterminated [")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            ch = self.next()
            if ch == "\\":
                cls = self.escape()
                out |= cls
                continue
            if ord(ch) > 127:
                self.fail("non-ASCII in char class")
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] not in "]":
                self.next()
                hi = self.next()
                if hi == "\\":
                    self.fail("range to escape unsupported")
                if ord(hi) > 127:
                    self.fail("non-ASCII in char class")
                out[ord(ch):ord(hi) + 1] = True
            else:
                out[ord(ch)] = True
        return ~out if negate else out


def _byte_class(b: int) -> np.ndarray:
    out = np.zeros(256, bool)
    out[b] = True
    return out


# ---------------------------------------------------------------------------
# AST -> NFA (Thompson) -> closed transition relation
# ---------------------------------------------------------------------------

_MAX_STATES = 128


class CompiledRegex:
    """Epsilon-free NFA + metadata, ready for vector simulation."""

    def __init__(self, pattern: str):
        # \b at the pattern EDGES compiles to boundary conditions on
        # seed/accept positions in the vector simulation (interior \b
        # still rejects -> CPU fallback, matching transpile-or-fallback)
        self.word_start = False
        self.word_end = False
        body = pattern
        if body.startswith(r"\b"):
            self.word_start = True
            body = body[2:]
        if body.endswith("b"):
            k = 0
            j = len(body) - 2
            while j >= 0 and body[j] == "\\":
                k += 1
                j -= 1
            if k % 2 == 1:  # odd backslashes: the final 'b' is \b
                self.word_end = True
                body = body[:-2]
        if (self.word_start or self.word_end) and not body:
            raise RegexUnsupported(f"regex {pattern!r}: bare \\b")
        parser = _Parser(body)
        ast = parser.parse()
        if (self.word_start or self.word_end) and isinstance(ast, _Alt):
            # like anchors: Java scopes an edge \b per branch under a
            # top-level alternation; our flags are simulation-global
            raise RegexUnsupported(
                f"regex {pattern!r}: \\b with top-level alternation")
        self.pattern = pattern
        self.ast = ast
        self.anchored_start = parser.anchored_start
        self.anchored_end = parser.anchored_end
        self.n_groups = parser.n_groups
        self.has_alternation = parser.has_alternation
        self.has_lazy = parser.has_lazy

        # Thompson build over epsilon edges
        self.eps: List[Set[int]] = [set()]
        self.byte_edges: List[Tuple[int, int, np.ndarray]] = []
        start = self._new_state()
        accept = self._build(ast, start)
        self.n_states = len(self.eps)
        if self.n_states > _MAX_STATES:
            raise RegexUnsupported(
                f"regex {pattern!r}: {self.n_states} NFA states > "
                f"{_MAX_STATES}")
        self.start = start
        self.accept = accept

        # epsilon closure (S,S) bool: closure[i,j] = j reachable from i
        S = self.n_states
        closure = np.eye(S, dtype=bool)
        for s in range(S):
            stack = [s]
            while stack:
                t = stack.pop()
                for u in self.eps[t]:
                    if not closure[s, u]:
                        closure[s, u] = True
                        stack.append(u)
        self.closure = closure
        # dedupe byte classes
        classes: List[np.ndarray] = []
        trans: List[Tuple[int, int, int]] = []  # (from, class_id, to)
        for (f, t, bs) in self.byte_edges:
            for cid, c in enumerate(classes):
                if np.array_equal(c, bs):
                    break
            else:
                cid = len(classes)
                classes.append(bs)
            trans.append((f, cid, t))
        self.classes = np.stack(classes) if classes else \
            np.zeros((0, 256), bool)
        self.transitions = trans
        self.start_set = closure[start]  # (S,) bool

    def _new_state(self) -> int:
        self.eps.append(set())
        return len(self.eps) - 1

    def _build(self, node: _Node, entry: int) -> int:
        """Wire node's NFA from `entry`; return its exit state."""
        if isinstance(node, _Lit):
            out = self._new_state()
            self.byte_edges.append((entry, out, node.byteset))
            return out
        if isinstance(node, _Cat):
            cur = entry
            for p in node.parts:
                cur = self._build(p, cur)
            return cur
        if isinstance(node, _Alt):
            out = self._new_state()
            for opt in node.options:
                fork = self._new_state()
                self.eps[entry].add(fork)
                end = self._build(opt, fork)
                self.eps[end].add(out)
            return out
        if isinstance(node, _Group):
            return self._build(node.child, entry)
        if isinstance(node, _Rep):
            cur = entry
            for _ in range(node.lo):
                cur = self._build(node.child, cur)
            if node.hi is None:
                # loop: child from cur back to cur (after >= lo copies)
                loop_in = self._new_state()
                self.eps[cur].add(loop_in)
                end = self._build(node.child, loop_in)
                self.eps[end].add(loop_in)
                return loop_in
            out = self._new_state()
            self.eps[cur].add(out)
            for _ in range(node.hi - node.lo):
                cur = self._build(node.child, cur)
                self.eps[cur].add(out)
            return out
        raise AssertionError(type(node))


_COMPILE_CACHE: Dict[str, CompiledRegex] = {}


def transpile(pattern: str) -> CompiledRegex:
    """Parse+compile or raise RegexUnsupported (the planner's fallback
    signal — the reference's ``RegexParser.transpile`` contract)."""
    if pattern not in _COMPILE_CACHE:
        _COMPILE_CACHE[pattern] = CompiledRegex(pattern)
    return _COMPILE_CACHE[pattern]



# ---------------------------------------------------------------------------
# NFA -> DFA (host) and the per-row walks (device)
# ---------------------------------------------------------------------------

#: the most DFA states one automaton may take; a pattern past it raises
MAX_DFA_STATES = 4096


class _SubAutomaton:
    """Epsilon-closed NFA for an AST fragment (no anchors)."""

    def __init__(self, ast: _Node):
        self.eps: List[Set[int]] = [set()]
        self.byte_edges: List[Tuple[int, int, np.ndarray]] = []
        start = self._new_state()
        accept = self._build(ast, start)
        self.n_states = len(self.eps)
        if self.n_states > _MAX_STATES:
            raise RegexUnsupported(
                f"sub-automaton: {self.n_states} states > {_MAX_STATES}")
        S = self.n_states
        closure = np.eye(S, dtype=bool)
        for s in range(S):
            stack = [s]
            while stack:
                t = stack.pop()
                for u in self.eps[t]:
                    if not closure[s, u]:
                        closure[s, u] = True
                        stack.append(u)
        self.closure = closure
        classes: List[np.ndarray] = []
        trans: List[Tuple[int, int, int]] = []
        for (f, t, bs) in self.byte_edges:
            for cid, c in enumerate(classes):
                if np.array_equal(c, bs):
                    break
            else:
                cid = len(classes)
                classes.append(bs)
            trans.append((f, cid, t))
        self.classes = np.stack(classes) if classes else \
            np.zeros((0, 256), bool)
        self.transitions = trans
        self.start = start
        self.accept = accept
        self.start_set = closure[start]

    _new_state = CompiledRegex._new_state
    _build = CompiledRegex._build


def _mask(row: np.ndarray) -> int:
    return int(sum(1 << int(i) for i in np.nonzero(row)[0]))


class _Dfa:
    """Subset construction of an epsilon-closed NFA (anything with
    ``n_states``, ``closure``, ``classes``, ``transitions``,
    ``start_set`` and ``accept``). ``modes`` lists the step kinds the
    walks need: False steps the set, True steps it and re-seeds the
    start set (an unanchored search). ``table[mode]`` is int32
    [states, 256]; state 0 is the empty set, ``start`` the closed start
    set."""

    def __init__(self, nfa, modes=(False,)):
        closure = [_mask(nfa.closure[s]) for s in range(nfa.n_states)]
        by_byte: List[List[Tuple[int, int]]] = [[] for _ in range(256)]
        for f, cid, t in nfa.transitions:
            for b in np.nonzero(nfa.classes[cid])[0]:
                by_byte[int(b)].append((f, closure[t]))
        # bytes that move every state set alike share one column
        groups: Dict[tuple, List[int]] = {}
        for b in range(256):
            groups.setdefault(tuple(by_byte[b]), []).append(b)
        start_mask = _mask(nfa.start_set)
        ids = {0: 0, start_mask: 1}
        order = [0, start_mask]
        rows: List[List[List[int]]] = []
        i = 0
        while i < len(order):
            cur = order[i]
            per_mode = []
            for seed in modes:
                col = [0] * 256
                for trans, bytes_ in groups.items():
                    nxt = 0
                    for f, cm in trans:
                        if cur >> f & 1:
                            nxt |= cm
                    if seed:
                        nxt |= start_mask
                    if nxt not in ids:
                        if len(order) >= MAX_DFA_STATES:
                            raise RegexUnsupported(
                                f"more than {MAX_DFA_STATES} DFA states")
                        ids[nxt] = len(order)
                        order.append(nxt)
                    for b in bytes_:
                        col[b] = ids[nxt]
                per_mode.append(col)
            rows.append(per_mode)
            i += 1
        self.table = np.asarray(rows, np.int32).transpose(1, 0, 2)
        self.accept = np.asarray([m >> nfa.accept & 1 for m in order], bool)
        self.start = 1
        self.modes = tuple(modes)
        self._dev: Dict[torch.device, tuple] = {}

    @property
    def n_states(self) -> int:
        return self.table.shape[1]

    def tensors(self, device):
        """(flat int64 tables, one per mode, indexed state * 256 +
        byte; bool accept) on ``device``."""
        device = torch.device(device)
        got = self._dev.get(device)
        if got is None:
            tbls = [torch.from_numpy(t.reshape(-1).astype(np.int64))
                    .to(device) for t in self.table]
            got = self._dev[device] = (
                tbls, torch.from_numpy(self.accept).to(device))
        return got


def _dfa_of(owner, key, build):
    """A DFA cached on ``owner`` (a CompiledRegex) under ``key``."""
    cache = owner.__dict__.setdefault("_dfas", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


class _Rows:
    """The per-row geometry of a string column that every walk uses:
    byte starts and lengths (int64), and the 'positions' view of rows
    with len + 1 slots each (0..len), flat over the batch."""

    def __init__(self, c: StringColumn):
        self.c = c
        self.dev = c.device
        self.cap = c.capacity
        self.starts = c.offsets[:-1].to(torch.int64)
        self.lens = c.lengths().to(torch.int64)
        self.max_len = int(self.lens.max()) if self.cap else 0
        self.last = max(c.char_capacity - 1, 0)
        n1 = self.lens + 1
        self.vstart = torch.cumsum(n1, 0) - n1
        self.vtotal = int(n1.sum()) if self.cap else 0
        self._vrow = None

    def byte_at(self, pos: torch.Tensor) -> torch.Tensor:
        """int64 byte at within-row position ``pos`` (0 past the row)."""
        inb = (pos >= 0) & (pos < self.lens)
        b = self.c.chars[(self.starts + pos).clamp(0, self.last)]
        return torch.where(inb, b.to(torch.int64), 0)

    @property
    def vrow(self) -> torch.Tensor:
        if self._vrow is None:
            self._vrow = torch.repeat_interleave(
                torch.arange(self.cap, device=self.dev), self.lens + 1,
                output_size=self.vtotal)
        return self._vrow

    def vpos(self) -> torch.Tensor:
        """The position (0..len) of every slot of the positions view."""
        return torch.arange(self.vtotal, device=self.dev) - \
            self.vstart[self.vrow]

    def vmask(self) -> torch.Tensor:
        return torch.zeros(self.vtotal, dtype=torch.bool, device=self.dev)

    def leftmost(self, vmask, lo=None) -> torch.Tensor:
        """Per row, the least position (>= ``lo``) marked in ``vmask``;
        len + 1 where none is."""
        pos = self.vpos()
        ok = vmask if lo is None else vmask & (pos >= lo[self.vrow])
        out = self.lens + 1
        return out.scatter_reduce(0, self.vrow, torch.where(
            ok, pos, self.lens[self.vrow] + 1), "amin", include_self=True)

    def rightmost(self, vmask) -> torch.Tensor:
        """Per row, the greatest position marked in ``vmask``; -1 where
        none is."""
        pos = self.vpos()
        out = torch.full((self.cap,), -1, dtype=torch.int64,
                         device=self.dev)
        return out.scatter_reduce(0, self.vrow, torch.where(vmask, pos, -1),
                                  "amax", include_self=True)


def _walk(rows: _Rows, dfa: _Dfa, pos0: torch.Tensor, forward: bool,
          mode: int = 0, record: bool = True, stop: torch.Tensor = None):
    """Walk each row's DFA from position ``pos0``: forward over bytes
    pos0..len-1, or backward over bytes pos0-1 down to 0. Returns (the
    final state per row, the positions view marked where the walk is in
    an accepting state, or None without ``record``). The start state's
    own acceptance is marked at ``pos0``. ``stop`` (optional) ends a
    forward walk at that position."""
    tbls, acc = dfa.tensors(rows.dev)
    tbl = tbls[mode]
    state = torch.full((rows.cap,), dfa.start, dtype=torch.int64,
                       device=rows.dev)
    end = rows.lens if stop is None else torch.minimum(stop, rows.lens)
    n = (end - pos0) if forward else pos0
    n = n.clamp(min=0)
    steps = int(n.max()) if rows.cap else 0
    marks = None
    if record:
        marks = rows.vmask()
        marks[rows.vstart + pos0.clamp(0, None).minimum(rows.lens)] = \
            acc[state] & (pos0 >= 0) & (pos0 <= rows.lens)
    for k in range(steps):
        active = k < n
        pos = pos0 + k if forward else pos0 - 1 - k
        byte = rows.byte_at(pos)
        state = torch.where(active, tbl[state * 256 + byte], state)
        if record:
            at = pos + 1 if forward else pos
            idx = rows.vstart + at.clamp(0, None).minimum(rows.lens)
            marks[idx] = marks[idx] | (active & acc[state])
    return state, marks


# ---------------------------------------------------------------------------
# RLIKE: the boolean search
# ---------------------------------------------------------------------------

def _is_word(b: torch.Tensor) -> torch.Tensor:
    return ((b >= 97) & (b <= 122)) | ((b >= 65) & (b <= 90)) | \
        ((b >= 48) & (b <= 57)) | (b == 95)


def _simulate(rx: CompiledRegex, col: StringColumn) -> torch.Tensor:
    """bool[capacity]: the row contains a match (is one, when anchored
    at both ends). Edge word boundaries choose, at each position,
    whether the search may start there and whether a match may end
    there."""
    rows = _Rows(col)
    reseed = not rx.anchored_start
    word = rx.word_start or rx.word_end
    modes = (False, True) if reseed and rx.word_start else (reseed,)
    dfa = _dfa_of(rx, ("sim", modes), lambda: _Dfa(rx, modes))
    tbls, acc = dfa.tensors(rows.dev)
    lens = rows.lens
    state = torch.full((rows.cap,), dfa.start, dtype=torch.int64,
                       device=rows.dev)
    if word:
        isw = _is_word(rows.byte_at(torch.zeros_like(lens))) & (lens > 0)
    if rx.word_start:
        state = torch.where(isw, state, 0)
    matched = acc[state] & ((lens == 0) if rx.anchored_end else True)
    for j in range(rows.max_len):
        in_str = j < lens
        nxt_w = None
        if word:
            nxt_w = _is_word(rows.byte_at(torch.full_like(lens, j + 1))) & \
                (j + 1 < lens)
        byte = rows.byte_at(torch.full_like(lens, j))
        flat = state * 256 + byte
        if len(modes) == 2:
            seed_ok = in_str & (nxt_w != isw)
            nxt = torch.where(seed_ok, tbls[1][flat], tbls[0][flat])
        else:
            nxt = tbls[0][flat]
        state = torch.where(in_str, nxt, state)
        ok = (j + 1 == lens) if rx.anchored_end else in_str
        if rx.word_end:
            ok = ok & (isw != nxt_w)
        matched = matched | (acc[state] & ok)
        if word:
            isw = nxt_w
    return matched


def _refusal(check, what: str):
    try:
        check()
    except RegexUnsupported as e:
        return f"{what}: {e}"
    return None


def _guard(expr, rule: str) -> None:
    reason = expr.device_unsupported()
    if reason is not None:
        from .core import cpu_fallback
        raise cpu_fallback(reason, rule)


class RLike(Expression):
    """rlike / regexp_like: unanchored regex search."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child)
        self.pattern = pattern

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def compiled(self) -> CompiledRegex:
        return transpile(self.pattern)

    def device_unsupported(self):
        """Why the device cannot run this pattern (the planner's
        ``_tag_rlike`` reads it), else None."""
        return _refusal(lambda: transpile(self.pattern), "rlike")

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        _guard(self, "_tag_rlike")
        c = self.children[0].eval(batch)
        return make_result(_simulate(self.compiled(), c), c.validity,
                           dt.BOOL)

    def __repr__(self):
        return f"{self.children[0]!r} RLIKE {self.pattern!r}"


# ---------------------------------------------------------------------------
# spans: regexp_extract / regexp_replace
# ---------------------------------------------------------------------------

def _reverse_ast(node: _Node) -> _Node:
    if isinstance(node, _Lit):
        return node
    if isinstance(node, _Cat):
        return _Cat([_reverse_ast(p) for p in reversed(node.parts)])
    if isinstance(node, _Alt):
        return _Alt([_reverse_ast(o) for o in node.options])
    if isinstance(node, _Rep):
        return _Rep(_reverse_ast(node.child), node.lo, node.hi)
    if isinstance(node, _Group):
        return _Group(_reverse_ast(node.child), node.idx)
    raise AssertionError(type(node))


def _span_dfas(rx: CompiledRegex):
    """(forward DFA, reversed DFA): the forward one anchored at its
    start; the reversed one re-seeding at every position unless the
    pattern is anchored at its end."""
    def build():
        fwd = _Dfa(_SubAutomaton(rx.ast))
        rev = _Dfa(_SubAutomaton(_reverse_ast(rx.ast)),
                   (bool(not rx.anchored_end),))
        return fwd, rev
    return _dfa_of(rx, "spans", build)


def _match_starts(rx: CompiledRegex, rows: _Rows) -> torch.Tensor:
    """Positions view: a match of ``rx`` starts there."""
    _, rev = _span_dfas(rx)
    _, starts = _walk(rows, rev, rows.lens, forward=False)
    if rx.anchored_start:
        starts = starts & (rows.vpos() == 0)
    return starts


def _longest_from(rx: CompiledRegex, rows: _Rows, p: torch.Tensor
                  ) -> torch.Tensor:
    """The end of the longest match that starts at ``p`` (-1: none)."""
    fwd, _ = _span_dfas(rx)
    _, ends = _walk(rows, fwd, p, forward=True)
    if rx.anchored_end:
        ends = ends & (rows.vpos() == rows.lens[rows.vrow])
    return rows.rightmost(ends)


def first_match_span(rx: CompiledRegex, rows: _Rows):
    """(found, start, end) of the leftmost-longest match per row."""
    if rx.word_start or rx.word_end:
        raise RegexUnsupported(
            f"regex {rx.pattern!r}: \\b spans are not lowered")
    p = rows.leftmost(_match_starts(rx, rows))
    found = p <= rows.lens
    p = torch.where(found, p, rows.lens)
    q = _longest_from(rx, rows, p)
    found = found & (q >= p)
    return found, torch.where(found, p, 0), torch.where(found, q, 0)


def _top_level_segments(rx: CompiledRegex):
    """[(ast, group index or None)] of the top-level concatenation;
    every capture group must be one of its parts."""
    ast = rx.ast
    parts = ast.parts if isinstance(ast, _Cat) else [ast]
    segs = []
    for part in parts:
        if isinstance(part, _Group):
            if _contains_group(part.child):
                raise RegexUnsupported("nested capture groups")
            segs.append((part.child, part.idx))
        else:
            if _contains_group(part):
                raise RegexUnsupported(
                    "capture group under quantifier/alternation")
            segs.append((part, None))
    return segs


def _contains_group(node: _Node) -> bool:
    if isinstance(node, _Group):
        return True
    if isinstance(node, _Cat):
        return any(_contains_group(p) for p in node.parts)
    if isinstance(node, _Alt):
        return any(_contains_group(o) for o in node.options)
    if isinstance(node, _Rep):
        return _contains_group(node.child)
    return False


def extract_group_spans(rx: CompiledRegex, rows: _Rows, group: int):
    """(found, start, end) of capture group ``group`` in the
    leftmost-longest match: each top-level segment ends at the last
    position where it can end and the rest of the pattern can still
    match up to the match's end."""
    found, p, q = first_match_span(rx, rows)
    if group == 0:
        return found, p, q
    segs = _top_level_segments(rx)

    def build():
        out = []
        for i, (seg_ast, _) in enumerate(segs):
            suffix = _Cat([a for a, _ in segs[i + 1:]])
            out.append((_Dfa(_SubAutomaton(seg_ast)),
                        _Dfa(_SubAutomaton(_reverse_ast(suffix)))))
        return out
    autos = _dfa_of(rx, "segments", build)
    bound = p
    for (seg, suffix_rev), (_, gidx) in zip(autos, segs):
        _, prefix = _walk(rows, seg, bound, forward=True, stop=q)
        _, feasible = _walk(rows, suffix_rev, q, forward=False)
        nxt = rows.rightmost(prefix & feasible)
        nxt = torch.where(found, nxt.clamp(min=0), 0)
        if gidx == group:
            return found, bound, nxt
        bound = nxt
    raise RegexUnsupported(f"regex {rx.pattern!r} has no group {group}")


def check_submatch_supported(pattern: str, group: int = 0
                             ) -> CompiledRegex:
    """Plan-time gate for extract / replace (the JAX package's): the
    span rule is leftmost-longest, Java's leftmost-greedy only without
    alternation or lazy quantifiers, and capture groups must sit
    directly in the top-level concatenation. Raises RegexUnsupported."""
    rx = transpile(pattern)
    if rx.word_start or rx.word_end:
        raise RegexUnsupported(
            f"regex {pattern!r}: \\b in extract / replace")
    if rx.has_alternation:
        raise RegexUnsupported(
            f"regex {pattern!r}: alternation in extract / replace "
            "(leftmost-longest is not Java's leftmost-greedy there)")
    if rx.has_lazy:
        raise RegexUnsupported(
            f"regex {pattern!r}: lazy quantifiers in extract / replace")
    if group < 0 or group > rx.n_groups:
        raise RegexUnsupported(f"regex {pattern!r} has no group {group}")
    if group > 0:
        _top_level_segments(rx)
    return rx


class RegExpExtract(Expression):
    """regexp_extract(str, pattern, group): the group's text in the
    leftmost match, '' where there is none."""

    def __init__(self, child: Expression, pattern: str, group: int = 1):
        super().__init__(child)
        self.pattern = pattern
        self.group = group

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def device_unsupported(self):
        return _refusal(lambda: check_submatch_supported(self.pattern,
                                                         self.group),
                        "regexp_extract")

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        from .strings import slice_rows
        _guard(self, "_tag_regexp_extract")
        c = self.children[0].eval(batch)
        rows = _Rows(c)
        rx = check_submatch_supported(self.pattern, self.group)
        found, gs, ge = extract_group_spans(rx, rows, self.group)
        return slice_rows(c, gs, torch.where(found, ge - gs, 0))

    def __repr__(self):
        return (f"RegExpExtract({self.children[0]!r}, {self.pattern!r}, "
                f"{self.group})")


class RegExpReplace(Expression):
    """regexp_replace(str, pattern, replacement): every non-overlapping
    leftmost match replaced, empty matches included (Java's
    ``replaceAll``: after an empty match the search moves on one
    character). A ``$`` or ``\\`` in the replacement (group references)
    runs on the CPU engine."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        super().__init__(child)
        self.pattern = pattern
        self.replacement = replacement
        self._repl_refs = "$" in replacement or "\\" in replacement

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def device_unsupported(self):
        if self._repl_refs:
            return ("regexp_replace: group references in the "
                    "replacement run on the CPU engine")
        return _refusal(lambda: check_submatch_supported(self.pattern, 0),
                        "regexp_replace")

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        from .strings import code_point_length, replace_spans
        _guard(self, "_tag_regexp_replace")
        c = self.children[0].eval(batch)
        rows = _Rows(c)
        rx = check_submatch_supported(self.pattern, 0)
        starts = _match_starts(rx, rows)
        lens = rows.lens
        cursor = torch.zeros_like(lens)
        done = ~c.validity
        chosen = rows.vmask()
        spans = []
        while True:
            p = rows.leftmost(starts, cursor)
            live = (p <= lens) & ~done
            if not bool(live.any()):
                break
            p = torch.where(live, p, lens)
            q = _longest_from(rx, rows, p)
            live = live & (q >= p)
            chosen[rows.vstart + p] |= live
            spans.append((torch.where(live, p, 0), torch.where(live, q, 0)))
            step = code_point_length(rows, p)
            cursor = torch.where(live, torch.where(q > p, q, p + step),
                                 cursor)
            done = done | ~live
        return replace_spans(rows, chosen, spans,
                             self.replacement.encode("utf-8"))

    def __repr__(self):
        return (f"RegExpReplace({self.children[0]!r}, {self.pattern!r}, "
                f"{self.replacement!r})")


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------

def _bytes_in(lo: int, hi: int) -> np.ndarray:
    out = np.zeros(256, bool)
    out[lo:hi + 1] = True
    return out


def _one_code_point() -> _Node:
    """Any one UTF-8 code point (a lead byte and its continuations)."""
    cont = _Lit(_bytes_in(0x80, 0xBF))
    return _Alt([_Lit(_bytes_in(0x00, 0x7F)),
                 _Cat([_Lit(_bytes_in(0xC0, 0xDF)), cont]),
                 _Cat([_Lit(_bytes_in(0xE0, 0xEF)), cont, cont]),
                 _Cat([_Lit(_bytes_in(0xF0, 0xFF)), cont, cont, cont])])


def like_dfa(pattern: str, escape: str = "\\") -> _Dfa:
    """The DFA of a LIKE pattern, anchored at both ends: ``%`` is any
    bytes, ``_`` one code point, the escape character takes the next
    one literally, every other character its UTF-8 bytes."""
    parts: List[_Node] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            lit, i = pattern[i + 1], i + 2
        elif ch == "%":
            parts.append(_Rep(_Lit(np.ones(256, bool)), 0, None))
            i += 1
            continue
        elif ch == "_":
            parts.append(_one_code_point())
            i += 1
            continue
        else:
            lit, i = ch, i + 1
        for b in lit.encode("utf-8"):
            parts.append(_Lit(_byte_class(b)))
    return _Dfa(_SubAutomaton(_Cat(parts)))


def like_match(c: StringColumn, dfa: _Dfa) -> torch.Tensor:
    """bool[capacity]: the whole row matches the LIKE DFA."""
    rows = _Rows(c)
    state, _ = _walk(rows, dfa, torch.zeros_like(rows.lens), forward=True,
                     record=False)
    return dfa.tensors(rows.dev)[1][state]
