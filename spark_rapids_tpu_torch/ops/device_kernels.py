"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version, its launch counter and its build loader.

The JAX package has exactly two functions that reach ``pl.pallas_call``
(spark_rapids_tpu/ops/pallas_kernels.py). Both are rewritten here:

``tile_reduce`` (replaces pallas_kernels.py:78, kernel body :54) — a
fused masked reduction: per row block, a per-query program evaluates the
filter predicate and the aggregate inputs in registers and reduces each
output lane (SUM / MIN / MAX) to one partial per block. Its string lane
(B2, replaces the padded-byte lane of spark_rapids_tpu/exec/pallas_agg.py:60-171)
evaluates ``=``, ``IN``, ``startswith`` and ``IS [NOT] NULL`` on string
columns inside the same pass: each string column enters as its int32
offsets, uint8 chars and uint8 validity, and each literal of m bytes is
an unrolled compare of the row length against m and of the m bytes at
``chars[offsets[i] + j]`` (loads masked by ``j < len``) with the
literal's bytes, which are written into the source. Bound: bytes — per
string column 4 B of offsets (``offsets[i + 1]`` is the next row's
``offsets[i]``), at most m chars and 1 B of validity per row; a separate string kernel would write a mask to HBM and read it
back, which the fused lane avoids. Route: Triton,
generated per plan from the expression tree (RowProgram.triton_source),
written to a ``.py`` file in the build directory (``triton.jit`` reads
source through ``inspect``) and cached by the source's hash. Bound on
the H100: bytes — each input column, validity byte and the live mask is
read once (33 B/row at TPC-H q6); the design writes only a
[programs, n_slots] float64 partial buffer, which torch then reduces in
a fixed order, so results do not depend on block scheduling.

``tile_group_reduce`` (replaces pallas_kernels.py:152) — grouped SUM of
float64 lanes over bucket ids in [0, num_buckets). Route: CUDA C++ for
sm_90a (csrc/tile_group_reduce.cu) built with nvcc into a shared library
with a C interface and loaded through ctypes. Bound on the H100: bytes
(4 B of bucket id + 8 B per lane and row); the design keeps the
accumulators in shared memory (see the .cu header).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises. Launch counters count kernel launches
only; ``plain_calls`` counts the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from ..expr import arithmetic as A
from ..expr import core as E
from ..expr import predicates as Pr
from ..expr.core import literal_physical
from ..expr.strings import match_literal

SUM = "sum"
MIN = "min"
MAX = "max"

#: rows per Triton program of tile_reduce
BLOCK_ROWS = 1024
GROUP_BUCKETS = 1024
#: lane pointers the CUDA launcher passes by value (TGR_MAX_LANES)
GROUP_MAX_LANES = 128

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "build")
GROUP_SOURCE = os.path.join(_PKG_DIR, "csrc", "tile_group_reduce.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def reduce_identity(kind: str, dtype: torch.dtype):
    """Identity element a masked-out lane must carry."""
    if kind == SUM:
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == MIN else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == MIN else info.min


def _check_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def reset_counts() -> None:
    for fn in (tile_reduce, tile_group_reduce):
        fn.launches = 0
        fn.plain_calls = 0
    # tile_reduce calls whose program carries string lanes (B2), also
    # counted in launches / plain_calls
    tile_reduce.str_launches = 0
    tile_reduce.str_plain_calls = 0


# ---------------------------------------------------------------------------
# tile_reduce: the per-query row program and its Triton generator
# ---------------------------------------------------------------------------


class StrPred(E.Expression):
    """String-lane predicate (B2): the row equals one of ``choices`` (or
    starts with one, when ``prefix``). ``eval`` is the plain version,
    over the column's Arrow offsets/chars/validity, which ride the
    kernel batch's ``str_lanes``; the generator lowers the same node to
    byte compares. Null rows are null."""

    def __init__(self, name: str, choices: Sequence[bytes],
                 prefix: bool = False):
        super().__init__()
        self.name = name
        self.choices = [bytes(c) for c in choices]
        self.prefix = prefix

    def data_type(self, schema) -> dt.DType:
        return dt.BOOL

    def references(self) -> set:
        return {self.name}

    def eval(self, batch) -> ColumnVector:
        offsets, chars, valid = batch.str_lanes[self.name]
        col = StringColumn(offsets, chars, valid)
        hit = torch.zeros(valid.shape[0], dtype=torch.bool,
                          device=valid.device)
        for lit in self.choices:
            hit = hit | match_literal(col, lit, self.prefix)
        return ColumnVector(hit & valid, valid, dt.BOOL)

    def __repr__(self):
        op = "startswith" if self.prefix else "in"
        return f"{self.name} {op} {self.choices!r}"


class StrNull(E.Expression):
    """IS [NOT] NULL over a string-lane column (validity only)."""

    def __init__(self, name: str, negated: bool):
        super().__init__()
        self.name = name
        self.negated = negated

    def data_type(self, schema) -> dt.DType:
        return dt.BOOL

    def references(self) -> set:
        return {self.name}

    def eval(self, batch) -> ColumnVector:
        _, _, valid = batch.str_lanes[self.name]
        live = batch.live_mask()
        data = valid if self.negated else ~valid
        return ColumnVector(data & live, live, dt.BOOL)

    def __repr__(self):
        return f"{self.name} IS {'NOT ' if self.negated else ''}NULL"


class _KernelBatch(ColumnarBatch):
    """Batch view of one block of kernel inputs: the live mask comes from
    an input lane instead of the row count."""

    def __init__(self, columns, names, num_rows, device, live):
        super().__init__(columns, names, num_rows, device)
        self._live = live

    def live_mask(self):
        return self._live


class RowProgram:
    """What tile_reduce evaluates per row: an optional filter predicate
    and value builders over referenced columns.

    Inputs are laid out as [data_0, valid_0, data_1, valid_1, ...,
    offsets_0, chars_0, svalid_0, ..., live]: (data, validity) per
    scalar column in ``names``, then (int32 offsets, uint8 chars, uint8
    validity) per string column in ``str_names``, then the uint8 live
    mask. ``builders`` entries are
    ``("sum", expr)`` -> [masked value, mask], ``("count_star", None)``
    -> [mask], ``("count", expr)`` -> [mask & valid] and
    ``(MIN|MAX, expr, with_nan)`` -> [masked value, mask (, NaN mask)].
    Calling the program evaluates it with torch (the plain row function);
    ``triton_source`` lowers the same tree to a Triton kernel.
    """

    def __init__(self, names: Sequence[str], col_dtypes: Sequence[dt.DType],
                 pred: Optional[E.Expression], builders: Sequence[tuple],
                 str_names: Sequence[str] = ()):
        self.names = list(names)
        self.col_dtypes = list(col_dtypes)
        self.pred = pred
        self.builders = list(builders)
        self.str_names = list(str_names)
        self._source: Optional[Tuple[str, List[float]]] = None
        self._lits = {}

    def lane_lengths(self, n: int) -> List[Optional[int]]:
        """Expected length of each input for ``n`` rows (None: any)."""
        return [n] * (2 * len(self.names)) + \
            [n + 1, None, n] * len(self.str_names) + [n]

    # --- the plain row function ---
    def __call__(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        live = blocks[-1] != 0
        cols = [ColumnVector(blocks[2 * i], blocks[2 * i + 1] != 0, t)
                for i, t in enumerate(self.col_dtypes)]
        kb = _KernelBatch(cols, self.names, live.shape[0], live.device, live)
        base = 2 * len(self.names)
        kb.str_lanes = {
            name: (blocks[base + 3 * k], blocks[base + 3 * k + 1],
                   blocks[base + 3 * k + 2] != 0)
            for k, name in enumerate(self.str_names)}
        mask = live
        if self.pred is not None:
            pc = self.pred.eval(kb)
            mask = mask & pc.data & pc.validity
        vals: List[torch.Tensor] = []
        for b in self.builders:
            if b[0] == "count_star":
                vals.append(mask.to(torch.float64))
                continue
            c = b[1].eval(kb)
            m = mask & c.validity
            if b[0] == "sum":
                vals += [torch.where(m, c.data, torch.zeros(
                    (), dtype=c.data.dtype, device=c.data.device)),
                    m.to(torch.float64)]
            elif b[0] == "count":
                vals.append(m.to(torch.float64))
            else:
                fill = torch.tensor(reduce_identity(b[0], c.data.dtype),
                                    dtype=c.data.dtype, device=c.data.device)
                if not b[2]:
                    vals += [torch.where(m, c.data, fill),
                             m.to(torch.float64)]
                else:
                    nan = torch.isnan(c.data)
                    vals += [torch.where(m & ~nan, c.data, fill),
                             m.to(torch.float64),
                             (m & nan).to(torch.float64)]
        return vals

    # --- the kernel source ---
    def triton_source(self) -> Tuple[str, List[float]]:
        """(source, float literals): a Triton module defining
        ``tile_reduce_kernel``. Float literals travel in a float64
        buffer so they keep full precision; the source is the plan's
        structural signature."""
        if self._source is None:
            self._source = _TritonGen(self).generate()
        return self._source

    def literals(self, device: torch.device) -> torch.Tensor:
        t = self._lits.get(device)
        if t is None:
            lits = self.triton_source()[1] or [0.0]
            t = self._lits[device] = torch.tensor(lits, dtype=torch.float64,
                                                  device=device)
        return t


_TT = {dt.BOOL: "tl.int1", dt.INT8: "tl.int8", dt.INT16: "tl.int16",
       dt.INT32: "tl.int32", dt.DATE: "tl.int32", dt.INT64: "tl.int64",
       dt.FLOAT32: "tl.float32", dt.FLOAT64: "tl.float64"}


class _TritonGen:
    """Lowers a RowProgram to Triton. Every node yields a (value, valid,
    logical type) triple that mirrors the torch ``eval`` of that node:
    Spark null propagation, Kleene And/Or, NaN-greatest comparisons,
    x / 0 -> null, and zeroed data under nulls."""

    def __init__(self, program: RowProgram):
        self.p = program
        self.lines: List[str] = []
        self.lits: List[float] = []
        self.n = 0

    def tmp(self) -> str:
        self.n += 1
        return f"t{self.n}"

    def emit(self, line: str) -> None:
        self.lines.append("    " + line)

    def lit(self, value: float, t: dt.DType) -> str:
        k = len(self.lits)
        self.lits.append(float(value))
        v = self.tmp()
        self.emit(f"{v} = tl.load(lits + {k}).to({_TT[t]})")
        return v

    def zero(self, t: dt.DType) -> str:
        return "0.0" if t.is_floating else "0"

    def lower(self, e: E.Expression):
        if isinstance(e, E.Alias):
            return self.lower(e.children[0])
        if isinstance(e, E.ColumnRef):
            i = self.p.names.index(e.name)
            return f"c{i}", f"v{i}", self.p.col_dtypes[i]
        if isinstance(e, E.Literal):
            return self._literal(e)
        if isinstance(e, A.BinaryArithmetic):
            return self._arith(e)
        if isinstance(e, A.UnaryMinus):
            a, av, t = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = tl.where({av}, -{a}, {self.zero(t)})")
            return r, av, t
        if isinstance(e, Pr.BinaryComparison):
            return self._compare(e)
        if isinstance(e, Pr.EqualNullSafe):
            (a, av, lt), (b, bv, rt), (x, y) = self._aligned(e)
            r = self.tmp()
            eq = self._eq(x, y, lt.is_floating or rt.is_floating)
            self.emit(f"{r} = ((~{av} & ~{bv}) | ({av} & {bv} & {eq})) "
                      "& live")
            return r, "live", dt.BOOL
        if isinstance(e, Pr.And):
            a, av, _ = self.lower(e.children[0])
            b, bv, _ = self.lower(e.children[1])
            kf, v, r = self.tmp(), self.tmp(), self.tmp()
            self.emit(f"{kf} = ({av} & ~{a}) | ({bv} & ~{b})")
            self.emit(f"{v} = ({av} & {bv}) | {kf}")
            self.emit(f"{r} = {a} & {b} & ~{kf} & {v}")
            return r, v, dt.BOOL
        if isinstance(e, Pr.Or):
            a, av, _ = self.lower(e.children[0])
            b, bv, _ = self.lower(e.children[1])
            kt, v, r = self.tmp(), self.tmp(), self.tmp()
            self.emit(f"{kt} = ({av} & {a}) | ({bv} & {b})")
            self.emit(f"{v} = ({av} & {bv}) | {kt}")
            self.emit(f"{r} = ({kt} | {a} | {b}) & {v}")
            return r, v, dt.BOOL
        if isinstance(e, Pr.Not):
            a, av, _ = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = ~{a} & {av}")
            return r, av, dt.BOOL
        if isinstance(e, Pr.IsNull):
            _, av, _ = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = ~{av} & live")
            return r, "live", dt.BOOL
        if isinstance(e, Pr.IsNotNull):
            _, av, _ = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = {av} & live")
            return r, "live", dt.BOOL
        if isinstance(e, Pr.IsNaN):
            a, av, t = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = ({a} != {a}) & {av}" if t.is_floating
                      else f"{r} = inb & (offs < 0)")
            return r, av, dt.BOOL
        if isinstance(e, StrPred):
            return self._str_pred(e)
        if isinstance(e, StrNull):
            k = self._str_lane(e.name)
            r = self.tmp()
            self.emit(f"{r} = {'' if e.negated else '~'}sv{k} & live")
            return r, "live", dt.BOOL
        if isinstance(e, Pr.InSet):
            a, av, t = self.lower(e.children[0])
            r = self.tmp()
            self.emit(f"{r} = inb & (offs < 0)")
            for v in e.values:
                if v is None:
                    continue
                c = self.lit(v, t) if t.is_floating else \
                    f"tl.full([BLOCK], {int(literal_physical(v, t))}, " \
                    f"{_TT[t]})"
                self.emit(f"{r} = {r} | ({a} == {c})")
            self.emit(f"{r} = {r} & {av}")
            return r, av, dt.BOOL
        raise NotImplementedError(
            f"{type(e).__name__} has no tile_reduce lowering")

    def _str_lane(self, name: str) -> int:
        return self.p.str_names.index(name)

    def _str_pred(self, e):
        """Row equals (or starts with) one of the literals: per literal
        a length test, then its bytes unrolled, each load of
        chars[start + j] masked by j < len. The bytes are source text,
        so each literal set compiles to its own kernel."""
        k = self._str_lane(e.name)
        chars = f"p{2 * len(self.p.names) + 3 * k + 1}"
        r = self.tmp()
        self.emit(f"{r} = inb & (offs < 0)")
        for lit in e.choices:
            h = self.tmp()
            op = ">=" if e.prefix else "=="
            self.emit(f"{h} = sl{k} {op} {len(lit)}")
            for j, byte in enumerate(lit):
                self.emit(f"{h} = {h} & (tl.load({chars} + so{k} + {j}, "
                          f"mask=inb & (sl{k} > {j}), other=0)"
                          f".to(tl.int32) == {byte})")
            self.emit(f"{r} = {r} | {h}")
        self.emit(f"{r} = {r} & sv{k}")
        return r, f"sv{k}", dt.BOOL

    def _literal(self, e: E.Literal):
        if e.value is None:
            raise NotImplementedError("null literal in tile_reduce")
        t = e.dtype
        r = self.tmp()
        if t.is_floating:
            c = self.lit(e.value, t)
            self.emit(f"{r} = tl.where(live, {c}, 0.0)")
        elif t == dt.BOOL:
            self.emit(f"{r} = live" if e.value else f"{r} = inb & (offs < 0)")
        else:
            v = int(literal_physical(e.value, t))
            self.emit(f"{r} = tl.where(live, tl.full([BLOCK], {v}, {_TT[t]})"
                      f", tl.zeros([BLOCK], {_TT[t]}))")
        return r, "live", t

    def _arith(self, e: A.BinaryArithmetic):
        a, av, lt = self.lower(e.children[0])
        b, bv, rt = self.lower(e.children[1])
        out_t = e._result_type(lt, rt)
        if lt != out_t:
            a = f"{a}.to({_TT[out_t]})"
        if rt != out_t:
            b = f"{b}.to({_TT[out_t]})"
        v, r = self.tmp(), self.tmp()
        z = self.zero(out_t)
        if isinstance(e, A.Divide):
            nz = self.tmp()
            self.emit(f"{nz} = {b} != 0.0")
            self.emit(f"{v} = {av} & {bv} & {nz}")
            self.emit(f"{r} = tl.where({v}, {a} / tl.where({nz}, {b}, 1.0)"
                      f", 0.0)")
            return r, v, out_t
        op = {A.Add: "+", A.Subtract: "-", A.Multiply: "*"}[type(e)]
        self.emit(f"{v} = {av} & {bv}")
        self.emit(f"{r} = tl.where({v}, {a} {op} {b}, {z})")
        return r, v, out_t

    def _aligned(self, e):
        left = self.lower(e.children[0])
        right = self.lower(e.children[1])
        a, b = left[0], right[0]
        if left[2].physical != right[2].physical:
            out_t = dt.promote(left[2], right[2])
            a, b = f"{a}.to({_TT[out_t]})", f"{b}.to({_TT[out_t]})"
        return left, right, (a, b)

    def _lt(self, x: str, y: str, floaty: bool) -> str:
        if not floaty:
            return f"({x} < {y})"
        # NaN is greatest: x < y iff x is not NaN and (y is NaN or x < y)
        return f"(({x} == {x}) & (({y} != {y}) | ({x} < {y})))"

    def _eq(self, x: str, y: str, floaty: bool) -> str:
        if not floaty:
            return f"({x} == {y})"
        return f"((({x} != {x}) & ({y} != {y})) | ({x} == {y}))"

    def _compare(self, e: Pr.BinaryComparison):
        left, right, (x, y) = self._aligned(e)
        floaty = left[2].is_floating or right[2].is_floating
        if isinstance(e, Pr.EqualTo):
            c = self._eq(x, y, floaty)
        elif isinstance(e, Pr.LessThan):
            c = self._lt(x, y, floaty)
        elif isinstance(e, Pr.GreaterThan):
            c = self._lt(y, x, floaty)
        elif isinstance(e, Pr.LessThanOrEqual):
            c = f"~{self._lt(y, x, floaty)}"
        elif isinstance(e, Pr.GreaterThanOrEqual):
            c = f"~{self._lt(x, y, floaty)}"
        else:
            raise NotImplementedError(type(e).__name__)
        v, r = self.tmp(), self.tmp()
        self.emit(f"{v} = {left[1]} & {right[1]}")
        self.emit(f"{r} = {c} & {v}")
        return r, v, dt.BOOL

    def generate(self) -> Tuple[str, List[float]]:
        p = self.p
        ncols = len(p.col_dtypes)
        nlanes = 2 * ncols + 3 * len(p.str_names)
        params = [f"p{i}" for i in range(nlanes + 1)]
        self.emit("pid = tl.program_id(0)")
        self.emit("offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)")
        self.emit("inb = offs < n")
        self.emit(f"live = tl.load(p{nlanes} + offs, mask=inb, other=0)"
                  " != 0")
        for i, t in enumerate(p.col_dtypes):
            load = f"tl.load(p{2 * i} + offs, mask=inb, other=0)"
            self.emit(f"c{i} = {load} != 0" if t == dt.BOOL
                      else f"c{i} = {load}")
            self.emit(f"v{i} = tl.load(p{2 * i + 1} + offs, mask=inb, "
                      "other=0) != 0")
        for k in range(len(p.str_names)):
            o = 2 * ncols + 3 * k
            # start and length from offsets[i], offsets[i + 1]
            self.emit(f"so{k} = tl.load(p{o} + offs, mask=inb, other=0)")
            self.emit(f"sl{k} = tl.load(p{o} + offs + 1, mask=inb, "
                      f"other=0) - so{k}")
            self.emit(f"sv{k} = tl.load(p{o + 2} + offs, mask=inb, "
                      "other=0) != 0")
        mask = "live"
        if p.pred is not None:
            d, v, _ = self.lower(p.pred)
            mask = self.tmp()
            self.emit(f"{mask} = live & {d} & {v}")
        outs: List[Tuple[str, str]] = []  # (expression, reduction kind)
        for b in p.builders:
            if b[0] == "count_star":
                outs.append((f"{mask}.to(tl.float64)", SUM))
                continue
            c, cv, t = self.lower(b[1])
            m = self.tmp()
            self.emit(f"{m} = {mask} & {cv}")
            if b[0] == "sum":
                outs += [(f"tl.where({m}, {c}, {self.zero(t)})", SUM),
                         (f"{m}.to(tl.float64)", SUM)]
            elif b[0] == "count":
                outs.append((f"{m}.to(tl.float64)", SUM))
            else:
                kind, with_nan = b[0], b[2]
                ident = reduce_identity(kind, t.physical)
                fill = self.lit(ident, t) if t.is_floating else \
                    f"tl.full([BLOCK], {ident}, {_TT[t]})"
                if with_nan:
                    nan = self.tmp()
                    self.emit(f"{nan} = {c} != {c}")
                    outs += [(f"tl.where({m} & ~{nan}, {c}, {fill})", kind),
                             (f"{m}.to(tl.float64)", SUM),
                             (f"({m} & {nan}).to(tl.float64)", SUM)]
                else:
                    outs += [(f"tl.where({m}, {c}, {fill})", kind),
                             (f"{m}.to(tl.float64)", SUM)]
        ns = len(outs)
        for j, (x, kind) in enumerate(outs):
            if kind == SUM:
                red = f"tl.sum(({x}).to(tl.float64), axis=0)"
            else:
                fn = "tl.min" if kind == MIN else "tl.max"
                red = f"{fn}({x}, axis=0).to(tl.float64)"
            self.emit(f"tl.store(out + pid * {ns} + {j}, {red})")
        head = ["import triton", "import triton.language as tl", "", "",
                "@triton.jit",
                "def tile_reduce_kernel(" + ", ".join(params)
                + ", lits, out, n, BLOCK: tl.constexpr):"]
        return "\n".join(head + self.lines) + "\n", self.lits


_TRITON_KERNELS: dict = {}
_BUILD_LOCK = threading.Lock()


def _write_atomic(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_tile_reduce_kernel(program: RowProgram):
    """Build loader: the Triton kernel for ``program``, generated into
    the build directory and imported from there, cached by source."""
    source, _ = program.triton_source()
    key = hashlib.sha256(source.encode()).hexdigest()[:16]
    with _BUILD_LOCK:
        fn = _TRITON_KERNELS.get(key)
        if fn is None:
            path = os.path.join(BUILD_DIR, "triton", f"tile_reduce_{key}.py")
            if not os.path.exists(path):
                _write_atomic(path, source.encode())
            spec = importlib.util.spec_from_file_location(
                f"srt_tile_reduce_{key}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = _TRITON_KERNELS[key] = mod.tile_reduce_kernel
    return fn


def tile_reduce_plain(inputs: Sequence[torch.Tensor], row_fn: Callable,
                      kinds: Sequence[str]) -> torch.Tensor:
    """The plain PyTorch version: evaluate ``row_fn`` over all rows and
    reduce each output lane. Returns float64[len(kinds)]."""
    tile_reduce.plain_calls += 1
    if getattr(row_fn, "str_names", None):
        tile_reduce.str_plain_calls += 1
    vals = row_fn(list(inputs))
    if len(vals) != len(kinds):
        raise ValueError(f"row_fn gave {len(vals)} lanes for {len(kinds)}")
    out = []
    for v, kind in zip(vals, kinds):
        if kind == SUM:
            out.append(v.to(torch.float64).sum())
        elif v.numel() == 0:
            out.append(torch.tensor(float(reduce_identity(kind, v.dtype)),
                                    dtype=torch.float64, device=v.device))
        else:
            r = v.min() if kind == MIN else v.max()
            out.append(r.to(torch.float64))
    return torch.stack(out)


def tile_reduce(inputs: Sequence[torch.Tensor], row_fn: Callable,
                kinds: Sequence[str]) -> torch.Tensor:
    """Fused masked reduction over rows.

    ``inputs``: 1-D tensors (column data / validity / live mask, uint8
    for the masks; a RowProgram's string lanes add offsets of one more
    entry and chars of any length). ``row_fn(inputs)`` maps them to
    ``len(kinds)`` pre-masked value lanes: excluded rows carry the
    kind's identity (0 for sum, +/-inf or the integer extreme for
    min/max). Returns float64[len(kinds)], one reduced value per lane.
    On CUDA ``row_fn`` must be a RowProgram, which is compiled.
    """
    inputs = list(inputs)
    dev = _check_device(inputs)
    if dev.type == "cpu":
        return tile_reduce_plain(inputs, row_fn, kinds)
    if not isinstance(row_fn, RowProgram):
        raise TypeError("tile_reduce on CUDA compiles a RowProgram; got "
                        f"{type(row_fn).__name__}")
    n = inputs[-1].shape[0]
    expected = row_fn.lane_lengths(n)
    if len(expected) != len(inputs):
        raise ValueError(f"tile_reduce: {len(inputs)} inputs for a program "
                         f"of {len(expected)}")
    for t, length in zip(inputs, expected):
        if t.dim() != 1 or not t.is_contiguous() or \
                (length is not None and t.shape[0] != length):
            raise ValueError("tile_reduce inputs must be contiguous 1-D "
                             "tensors in the program's layout")
    kernel = load_tile_reduce_kernel(row_fn)
    args = [t.view(torch.uint8) if t.dtype == torch.bool else t
            for t in inputs]
    grid = max(1, -(-n // BLOCK_ROWS))
    partial = torch.empty((grid, len(kinds)), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        kernel[(grid,)](*args, row_fn.literals(dev), partial, n,
                        BLOCK=BLOCK_ROWS, num_warps=4,
                        enable_fp_fusion=False)
    tile_reduce.launches += 1
    if row_fn.str_names:
        tile_reduce.str_launches += 1
    is_sum, is_min = _kind_masks(tuple(kinds), dev)
    return torch.where(is_sum, partial.sum(0), torch.where(
        is_min, partial.amin(0), partial.amax(0)))


_KIND_MASKS: dict = {}


def _kind_masks(kinds: Tuple[str, ...], dev: torch.device):
    """Device masks of the SUM and MIN lanes, cached so that combining
    the partials copies nothing from the host."""
    key = (kinds, dev)
    masks = _KIND_MASKS.get(key)
    if masks is None:
        masks = _KIND_MASKS[key] = (
            torch.tensor([k == SUM for k in kinds], device=dev),
            torch.tensor([k == MIN for k in kinds], device=dev))
    return masks


# ---------------------------------------------------------------------------
# tile_group_reduce: grouped SUM (CUDA C++, ctypes)
# ---------------------------------------------------------------------------

_GROUP_LIB: dict = {}


def group_library_path() -> str:
    with open(GROUP_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libtile_group_reduce_{digest}.so")


def build_group_kernel() -> None:
    """Compile csrc/tile_group_reduce.cu with nvcc into the build
    directory (skipped when the library for this source exists)."""
    so = group_library_path()
    if os.path.exists(so):
        return
    from torch.utils.cpp_extension import CUDA_HOME  # the toolkit torch finds
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit (nvcc) found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    tmp = f"{so}.{os.getpid()}.tmp"
    done = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, GROUP_SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n{done.stdout}")
    os.replace(tmp, so)


def _group_lib():
    so = group_library_path()
    lib = _GROUP_LIB.get(so)
    if lib is None:
        build_group_kernel()
        lib = ctypes.CDLL(so)
        fn = lib.tile_group_reduce_f64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _GROUP_LIB[so] = lib
    return lib


def tile_group_reduce_plain(gid: torch.Tensor, values: Sequence[torch.Tensor],
                            num_buckets: int = GROUP_BUCKETS
                            ) -> List[torch.Tensor]:
    """The plain PyTorch version: per-lane scatter-add into buckets."""
    tile_group_reduce.plain_calls += 1
    idx = gid.to(torch.int64)
    return [torch.zeros(num_buckets, dtype=torch.float64,
                        device=v.device).index_add_(0, idx, v)
            for v in values]


def tile_group_reduce(gid: torch.Tensor, values: Sequence[torch.Tensor],
                      num_buckets: int = GROUP_BUCKETS) -> List[torch.Tensor]:
    """Grouped SUM: for each float64 lane in ``values``, the sum of its
    entries per bucket id of ``gid`` (int32, every id in
    [0, num_buckets)); excluded rows must carry 0. Returns one
    float64[num_buckets] tensor per lane."""
    values = list(values)
    if num_buckets % 8 != 0 or num_buckets <= 0:
        raise ValueError(f"num_buckets must be a positive multiple of 8, "
                         f"got {num_buckets}")
    if not 1 <= len(values) <= GROUP_MAX_LANES:
        raise ValueError(f"1..{GROUP_MAX_LANES} value lanes, got "
                         f"{len(values)}")
    n = gid.shape[0]
    if gid.dim() != 1 or gid.dtype != torch.int32:
        raise ValueError("gid must be a 1-D int32 tensor")
    for v in values:
        if v.dim() != 1 or v.shape[0] != n or v.dtype != torch.float64:
            raise ValueError("values must be 1-D float64 tensors of gid's "
                             "length")
    dev = _check_device([gid] + values)
    if dev.type == "cpu":
        return tile_group_reduce_plain(gid, values, num_buckets)
    if not gid.is_contiguous() or not all(v.is_contiguous() for v in values):
        raise ValueError("tile_group_reduce inputs must be contiguous")
    lib = _group_lib()
    nv = len(values)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(sms, -(-n // 512)))
    partial = torch.empty(blocks * nv * num_buckets, dtype=torch.float64,
                          device=dev)
    out = torch.empty((nv, num_buckets), dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_uint64 * nv)(*[v.data_ptr() for v in values])
    with torch.cuda.device(dev):
        rc = lib.tile_group_reduce_f64(
            gid.data_ptr(), ptrs, n, nv, num_buckets, blocks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile_group_reduce launch failed: cudaError {rc}")
    tile_group_reduce.launches += 1
    return list(out.unbind(0))


reset_counts()
