"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version, its launch counter and its build loader.

The JAX package has exactly two functions that reach ``pl.pallas_call``
(spark_rapids_tpu/ops/pallas_kernels.py). Both are rewritten here:

``tile_reduce`` (replaces pallas_kernels.py:78, kernel body :54) — a
fused masked reduction: a per-query program evaluates the filter
predicate and the aggregate inputs in registers and reduces each output
lane (SUM / MIN / MAX). Its string lane (B2, replaces the padded-byte
lane of spark_rapids_tpu/exec/pallas_agg.py:60-171) evaluates ``=``,
``IN``, ``startswith`` and ``IS [NOT] NULL`` on string columns inside
the same pass: each string column enters as its int32 offsets, uint8
chars and uint8 validity, and each literal of m bytes is an unrolled
compare of the row length against m and of the m bytes at
``chars[offsets[i] + j]`` (loads masked by ``j < len``) with the
literal's bytes, which are written into the source; a separate string
kernel would write a mask to HBM and read it back, which the fused lane
avoids. Route: Triton, generated per plan from the expression tree
(RowProgram.triton_source), written to a ``.py`` file in the build
directory (``triton.jit`` reads source through ``inspect``) and cached by
the source's hash. Bound on the H100: bytes — each input column,
validity byte and the live mask is read once (33 B/row at TPC-H q6); per
string column 4 B of offsets (``offsets[i + 1]`` is the next row's
``offsets[i]``), at most m chars and 1 B of validity per row. Design: a
persistent grid of a few programs per SM, each walking row blocks with
one register accumulator per output slot (float64 for sums) and storing
one partial per slot; a second, single-program kernel reduces each
slot's partials by its kind, which the generator writes into its
source, with one ``tl.sum`` / ``tl.min`` / ``tl.max`` over the
[P]-vector of partials: a tree whose shape is fixed by P and the
program count. Two launches per call, and the same input on the same
card (same grid) gives the same bits.

``tile_group_reduce`` (replaces pallas_kernels.py:152) — grouped SUM of
float64 lanes over bucket ids in [0, num_buckets). Route: CUDA C++ for
sm_90a (csrc/tile_group_reduce.cu) built with nvcc into a shared library
with a C interface and loaded through ctypes. Bound on the H100: bytes
(4 B of bucket id + 8 B per lane and row); the design pre-aggregates
equal ids within a warp and sums into per-warp shared-memory copies
sized to the batch's groups, without atomics (see the .cu header).

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
from ..expr.cast import Cast
from ..expr.core import literal_physical
from ..expr.strings import match_literal

SUM = "sum"
MIN = "min"
MAX = "max"

#: tile_reduce's persistent grid: (rows per block, num_warps, programs
#: per SM), tuned on the H100 (PERF.md)
TILE_REDUCE_CONFIG = (512, 8, 4)
GROUP_BUCKETS = 1024
#: lane pointers the CUDA launcher passes by value (TGR_MAX_LANES)
GROUP_MAX_LANES = 128
#: the shared memory the CUDA kernel's per-warp copies may take in one
#: block, tuned on the H100 (PERF.md)
GROUP_SMEM_TARGET = 110 * 1024

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

    def slot_kinds(self) -> List[str]:
        """The reduction kind of each output slot, in order: what the
        generated combine kernel reduces each slot by."""
        kinds: List[str] = []
        for b in self.builders:
            if b[0] == "sum":
                kinds += [SUM, SUM]
            elif b[0] in ("count_star", "count"):
                kinds.append(SUM)
            else:
                kinds += [b[0], SUM] + ([SUM] if b[2] else [])
        return kinds

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
        if isinstance(e, A.UnaryPositive):
            return self.lower(e.children[0])
        if isinstance(e, A.Abs):
            a, av, t = self.lower(e.children[0])
            r = self.tmp()
            # an integral minimum wraps to itself, as torch.abs does
            absval = f"tl.abs({a})" if t.is_floating else \
                f"tl.where({a} < 0, -{a}, {a})"
            self.emit(f"{r} = tl.where({av}, {absval}, {self.zero(t)})")
            return r, av, t
        if isinstance(e, Cast):
            return self._cast(e)
        if isinstance(e, A._LeastGreatestBase):
            return self._minmax(e)
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

    def _cast(self, e):
        """expr/cast.py's numeric, boolean and date casts: a wrap on
        narrowing, a float truncated toward zero and saturated (NaN is
        0; TINYINT / SMALLINT through INT, then a wrap), x != 0 to
        boolean, 0 / 1 from it."""
        a, av, src = self.lower(e.children[0])
        to = e.to
        r = self.tmp()
        if src == to:
            return a, av, src
        if to == dt.BOOL:
            self.emit(f"{r} = ({a} != 0) & {av}")
            return r, av, to
        if src.is_floating and to.is_integral:
            wide = dt.INT64 if to == dt.INT64 else dt.INT32
            lo, hi = dt.min_value(wide), dt.max_value(wide)
            # float64(2^63 - 1) rounds up to 2^63: saturate explicitly
            top = float(2 ** 63) if wide == dt.INT64 else float(hi)
            x, c = self.tmp(), self.tmp()
            self.emit(f"{x} = tl.where({a} != {a}, 0.0, "
                      f"{a}.to(tl.float64))")
            self.emit(f"{c} = tl.where({x} < {float(lo)!r}, "
                      f"{float(lo)!r}, {x})")
            self.emit(f"{c} = tl.where({c} > {top!r}, {top!r}, {c})")
            self.emit(f"{c} = tl.where({c} < 0, -tl.floor(-{c}), "
                      f"tl.floor({c}))")
            self.emit(f"{r} = tl.where({c} >= {top}, "
                      f"tl.full([BLOCK], {hi}, {_TT[wide]}), "
                      f"{c}.to({_TT[wide]}))")
            if wide != to:
                self.emit(f"{r} = {r}.to({_TT[to]})")
        else:
            self.emit(f"{r} = {a}.to({_TT[to]})")
        self.emit(f"{r} = tl.where({av}, {r}, {self.zero(to)})")
        return r, av, to

    def _minmax(self, e):
        """least / greatest: NULLs skipped, NaN above every number (as
        expr/arithmetic.py ``minmax_columns``)."""
        kids = [self.lower(c) for c in e.children]
        out_t = kids[0][2]
        for _, _, t in kids[1:]:
            out_t = dt.promote(out_t, t)
        largest = e.largest
        fill = dt.min_value(out_t) if largest else dt.max_value(out_t)
        # float fills (the infinities, NaN) ride the literal buffer
        fill_s = self.lit(fill, out_t) if out_t.is_floating else \
            f"tl.full([BLOCK], {int(fill)}, {_TT[out_t]})"
        red = "tl.maximum" if largest else "tl.minimum"
        data, anyv = self.tmp(), self.tmp()
        self.emit(f"{data} = {fill_s}")
        self.emit(f"{anyv} = inb & (offs < 0)")
        if out_t.is_floating:
            nan_seen, num_seen = self.tmp(), self.tmp()
            self.emit(f"{nan_seen} = inb & (offs < 0)")
            self.emit(f"{num_seen} = inb & (offs < 0)")
        for a, av, t in kids:
            x = a if t == out_t else f"{a}.to({_TT[out_t]})"
            if out_t.is_floating:
                nan = self.tmp()
                self.emit(f"{nan} = {x} != {x}")
                self.emit(f"{data} = {red}({data}, tl.where({av} & ~{nan}, "
                          f"{x}, {fill_s}))")
                self.emit(f"{nan_seen} = {nan_seen} | ({av} & {nan})")
                self.emit(f"{num_seen} = {num_seen} | ({av} & ~{nan})")
            else:
                self.emit(f"{data} = {red}({data}, tl.where({av}, {x}, "
                          f"{fill_s}))")
            self.emit(f"{anyv} = {anyv} | {av}")
        r = self.tmp()
        if out_t.is_floating:
            pick = nan_seen if largest else f"~{num_seen}"
            nan_v = self.lit(float("nan"), out_t)
            self.emit(f"{data} = tl.where({pick}, {nan_v}, {data})")
        self.emit(f"{r} = tl.where({anyv}, {data}, {self.zero(out_t)})")
        return r, anyv, out_t

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
        """Two kernels: ``tile_reduce_kernel``, a persistent grid whose
        programs walk row blocks ``pid, pid + nprog, ...`` and keep one
        register accumulator per output slot, then store one partial per
        program and slot; and ``tile_reduce_combine``, one program that
        reduces the partials of each slot by the slot's kind, which is
        written into its source, with one tree reduction over the
        [P]-vector of partials (a fixed order for a fixed grid)."""
        p = self.p
        ncols = len(p.col_dtypes)
        nlanes = 2 * ncols + 3 * len(p.str_names)
        params = [f"p{i}" for i in range(nlanes + 1)]
        self.emit("offs = blk.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)")
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
        # (expression, reduction kind, accumulator type, its identity)
        outs: List[Tuple[str, str, str, object]] = []
        f64 = "tl.float64"
        for b in p.builders:
            if b[0] == "count_star":
                outs.append((f"{mask}.to(tl.float64)", SUM, f64, 0))
                continue
            c, cv, t = self.lower(b[1])
            m = self.tmp()
            self.emit(f"{m} = {mask} & {cv}")
            if b[0] == "sum":
                outs += [(f"tl.where({m}, {c}, {self.zero(t)})", SUM, f64, 0),
                         (f"{m}.to(tl.float64)", SUM, f64, 0)]
            elif b[0] == "count":
                outs.append((f"{m}.to(tl.float64)", SUM, f64, 0))
            else:
                kind, with_nan = b[0], b[2]
                ident = reduce_identity(kind, t.physical)
                fill = self.lit(ident, t) if t.is_floating else \
                    f"tl.full([BLOCK], {ident}, {_TT[t]})"
                if with_nan:
                    nan = self.tmp()
                    self.emit(f"{nan} = {c} != {c}")
                    outs += [(f"tl.where({m} & ~{nan}, {c}, {fill})", kind,
                              _TT[t], ident),
                             (f"{m}.to(tl.float64)", SUM, f64, 0),
                             (f"({m} & {nan}).to(tl.float64)", SUM, f64, 0)]
                else:
                    outs += [(f"tl.where({m}, {c}, {fill})", kind, _TT[t],
                              ident),
                             (f"{m}.to(tl.float64)", SUM, f64, 0)]
        ns = len(outs)
        head = ["pid = tl.program_id(0)", "nprog = tl.num_programs(0)"]
        tail = []
        for j, (x, kind, tt, ident) in enumerate(outs):
            if kind == SUM:
                head.append(f"acc{j} = tl.zeros([BLOCK], tl.float64)")
                self.emit(f"acc{j} += ({x}).to(tl.float64)")
                red = f"tl.sum(acc{j}, axis=0)"
            else:
                fn = "minimum" if kind == MIN else "maximum"
                init = (f"tl.zeros([BLOCK], {tt}) "
                        f"{'+' if kind == MIN else '-'} float(\"inf\")"
                        if isinstance(ident, float)
                        else f"tl.full([BLOCK], {ident}, {tt})")
                head.append(f"acc{j} = {init}")
                self.emit(f"acc{j} = tl.{fn}(acc{j}, ({x}).to({tt}))")
                red = f"tl.{kind}(acc{j}, axis=0).to(tl.float64)"
            tail.append(f"tl.store(partial + pid * {ns} + {j}, {red})")
        lines = ["import triton", "import triton.language as tl", "", "",
                 "@triton.jit",
                 "def tile_reduce_kernel(" + ", ".join(params)
                 + ", lits, partial, n, BLOCK: tl.constexpr):"]
        lines += ["    " + h for h in head]
        lines.append("    for blk in range(pid, tl.cdiv(n, BLOCK), nprog):")
        lines += ["    " + b for b in self.lines]
        lines += ["    " + t for t in tail]
        lines += ["", "", "@triton.jit",
                  "def tile_reduce_combine(partial, out, nprog, "
                  "P: tl.constexpr):",
                  "    r = tl.arange(0, P)",
                  "    m = r < nprog"]
        # every load first, so that the slots' loads are in flight at once
        for j, (_, kind, _, _) in enumerate(outs):
            other = {SUM: "0.0", MIN: 'float("inf")',
                     MAX: '-float("inf")'}[kind]
            lines.append(f"    x{j} = tl.load(partial + r * {ns} + {j}, "
                         f"mask=m, other={other})")
        for j, (_, kind, _, _) in enumerate(outs):
            lines.append(f"    tl.store(out + {j}, tl.{kind}(x{j}, axis=0))")
        return "\n".join(lines) + "\n", self.lits


_TRITON_KERNELS: dict = {}
_BUILD_LOCK = threading.Lock()


def _write_atomic(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_tile_reduce_kernel(program: RowProgram):
    """Build loader: the Triton kernels (partials, combine) for
    ``program``, generated into the build directory and imported from
    there, cached by source."""
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
            fn = _TRITON_KERNELS[key] = (mod.tile_reduce_kernel,
                                         mod.tile_reduce_combine)
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
    On CUDA ``row_fn`` must be a RowProgram, which is compiled; a
    RowProgram's ``kinds`` must be its ``slot_kinds()``, as the kernel
    reduces each slot by the kind written into its source.
    """
    inputs = list(inputs)
    dev = _check_device(inputs)
    if isinstance(row_fn, RowProgram) and \
            list(kinds) != row_fn.slot_kinds():
        raise ValueError(f"tile_reduce: kinds {list(kinds)} differ from "
                         f"the program's {row_fn.slot_kinds()}")
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
    kernel, combine = load_tile_reduce_kernel(row_fn)
    args = [t.view(torch.uint8) if t.dtype == torch.bool else t
            for t in inputs]
    block, _, per_sm = TILE_REDUCE_CONFIG
    most = _sm_count(dev) * per_sm
    nprog = max(1, min(-(-n // block), most))
    ns = len(kinds)
    out = torch.empty(ns, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev), _LAUNCH_LOCK:
        partial = _scratch("tile_reduce", dev, nprog * ns)
        _launch_tile_reduce(kernel, combine, args, row_fn.literals(dev),
                            partial, out, n, nprog, most)
    tile_reduce.launches += 1
    if row_fn.str_names:
        tile_reduce.str_launches += 1
    return out


def _launch_tile_reduce(kernel, combine, args, lits, partial, out, n: int,
                        nprog: int, most: int) -> None:
    """The two launches of one tile_reduce call: ``nprog`` persistent
    programs write [nprog, slots] partials, then one program combines
    them; its vector width P covers ``most``, the grid's largest
    program count, so that P does not change with the batch."""
    block, warps, _ = TILE_REDUCE_CONFIG
    kernel[(nprog,)](*args, lits, partial, n, BLOCK=block, num_warps=warps,
                     enable_fp_fusion=False)
    combine[(1,)](partial, out, nprog, P=_next_power_of_2(most),
                  num_warps=4)


def _next_power_of_2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_SM_COUNT: dict = {}
_SCRATCH: dict = {}
#: held while a wrapper enqueues its kernels, so that two threads on one
#: stream cannot interleave their use of the same scratch buffer
_LAUNCH_LOCK = threading.Lock()


def _sm_count(dev: torch.device) -> int:
    sms = _SM_COUNT.get(dev.index)
    if sms is None:
        sms = _SM_COUNT[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _scratch(tag: str, dev: torch.device, numel: int) -> torch.Tensor:
    """float64 scratch of at least ``numel`` entries, kept per wrapper,
    device and stream: kernels on one stream run in order, so the next
    call's kernels find the buffer free."""
    key = (tag, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = _SCRATCH[key] = torch.empty(max(numel, 1), dtype=torch.float64,
                                          device=dev)
    return buf


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
    """The library, built and loaded at the first call (the source is
    hashed once, not per launch)."""
    lib = _GROUP_LIB.get("lib")
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _GROUP_LIB.get("lib")
        if lib is not None:
            return lib
        build_group_kernel()
        lib = ctypes.CDLL(group_library_path())
        fn = lib.tile_group_reduce_f64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        shape = lib.tile_group_reduce_shape
        shape.restype = ctypes.c_int
        shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_int)]
        _GROUP_LIB["lib"] = lib
    return lib


_GROUP_SHAPES: dict = {}


def _group_shape(lib, dev: torch.device, num_lanes: int,
                 num_groups: int) -> Tuple[int, int]:
    """(lanes per block, blocks that fill the card once) for this many
    lanes and groups, from the library's occupancy query, cached."""
    key = (dev.index, num_lanes, num_groups)
    shape = _GROUP_SHAPES.get(key)
    if shape is None:
        chunk, resident = ctypes.c_int(), ctypes.c_int()
        rc = lib.tile_group_reduce_shape(num_lanes, num_groups,
                                         GROUP_SMEM_TARGET,
                                         ctypes.byref(chunk),
                                         ctypes.byref(resident))
        if rc != 0:
            raise RuntimeError(f"tile_group_reduce shape failed: cudaError "
                               f"{rc}")
        shape = _GROUP_SHAPES[key] = (chunk.value, resident.value)
    return shape


def tile_group_reduce_plain(gid: torch.Tensor, values: Sequence[torch.Tensor],
                            num_buckets: int = GROUP_BUCKETS,
                            num_groups: Optional[int] = None
                            ) -> List[torch.Tensor]:
    """The plain PyTorch version: per-lane scatter-add into buckets.
    ``num_groups`` is the kernel's hint and changes nothing here: rows at
    or above it carry zeros."""
    tile_group_reduce.plain_calls += 1
    idx = gid.to(torch.int64)
    return [torch.zeros(num_buckets, dtype=torch.float64,
                        device=v.device).index_add_(0, idx, v)
            for v in values]


def tile_group_reduce(gid: torch.Tensor, values: Sequence[torch.Tensor],
                      num_buckets: int = GROUP_BUCKETS,
                      num_groups: Optional[int] = None) -> List[torch.Tensor]:
    """Grouped SUM: for each float64 lane in ``values``, the sum of its
    entries per bucket id of ``gid`` (int32, every id in
    [0, num_buckets)); excluded rows must carry 0. ``num_groups``, when
    given, says that only ids below it carry values (rows at or above it
    carry 0), so the kernel accumulates that many buckets and skips the
    rest. Returns one float64[num_buckets] tensor per lane."""
    values = list(values)
    if num_buckets % 8 != 0 or num_buckets <= 0:
        raise ValueError(f"num_buckets must be a positive multiple of 8, "
                         f"got {num_buckets}")
    if num_groups is not None and not 1 <= num_groups <= num_buckets:
        raise ValueError(f"num_groups must be in 1..{num_buckets}, got "
                         f"{num_groups}")
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
        return tile_group_reduce_plain(gid, values, num_buckets, num_groups)
    if not gid.is_contiguous() or not all(v.is_contiguous() for v in values):
        raise ValueError("tile_group_reduce inputs must be contiguous")
    lib = _group_lib()
    nv = len(values)
    ng = num_buckets if num_groups is None else num_groups
    ptrs = [v.data_ptr() for v in values]
    vec = int(all(p % 16 == 0 for p in ptrs + [gid.data_ptr()]))
    out = torch.empty((nv, num_buckets), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev), _LAUNCH_LOCK:
        chunk, resident = _group_shape(lib, dev, nv, ng)
        partial = _scratch("tile_group_reduce", dev, resident * nv * ng)
        rc = lib.tile_group_reduce_f64(
            gid.data_ptr(), (ctypes.c_uint64 * nv)(*ptrs), n, nv,
            num_buckets, ng, chunk, resident, vec, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile_group_reduce launch failed: cudaError {rc}")
    tile_group_reduce.launches += 1
    return list(out.unbind(0))


reset_counts()
