"""Execution-context expressions: monotonically_increasing_id,
spark_partition_id, uuid, raise_error, version.

Counterpart of spark_rapids_tpu/expr/misc.py. The projection that evaluates a
positional expression (``uses_row_position``) binds the stream
position of its batch's first row (``row_offset``): monotonically
increasing ids are that offset plus the row's index, so they are unique
across every batch of a run and the same in two runs of one plan.
Outside such a binding the offset is 0, as in the JAX package. One
partition runs, so the partition id is 0 and its bits (``pid << 33``)
are 0.

``uuid()`` draws its random bits on the device from a
``torch.Generator`` seeded by the expression's seed (drawn when the
query is built, Spark's ``Uuid(randomSeed)``) and the batch's row
offset, and formats the v4 strings there: no Python loop per row (the
JAX package calls ``uuid.uuid4()`` for each).

``input_file_name()``, ``input_file_block_start()`` and
``input_file_block_length()`` read the file the scan's current batch
came from (``set_input_file``, called by io/scan.py's
FileSourceScanExec before it yields each batch): the path, 0 and the
file's size, as whole-file reads report them; "" / 0 / 0 outside a
file or for a batch the coalescing reader made of several files. The
planner forces the per-file reader below them
(plan/overrides.py ``_force_perfile_for_input_file``). They are
DataFrame-only, as in the JAX parser.

``raise_error(msg)`` raises for the rows that reach it, as Spark's
lazy ``If`` / ``CASE`` evaluate it (expr/ansi.py ``reach``): under a
branch that no row selects it does not raise. The JAX package raises
for any batch with live rows (ROADMAP C18). ``version()`` is the JAX
package's string, ``spark_rapids_tpu <version>``.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
from typing import Optional

import torch

from .. import __version__
from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Literal, Schema, make_result

_CTX = threading.local()


@contextlib.contextmanager
def row_offset(offset: int):
    """Bind the stream position of the next evaluated batch's row 0."""
    prev = getattr(_CTX, "offset", 0)
    _CTX.offset = int(offset)
    try:
        yield
    finally:
        _CTX.offset = prev


class MonotonicallyIncreasingID(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        ids = torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.device) + getattr(_CTX, "offset", 0)
        return make_result(ids, batch.live_mask(), dt.INT64)

    def __repr__(self):
        return "monotonically_increasing_id()"


# --- the scan's per-batch file context -------------------------------------

def set_input_file(name: Optional[str], block_start: int = 0,
                   block_length: int = 0) -> None:
    """The file of the batch the scan yields next (None: no single
    file)."""
    _CTX.input_file = (name or "", block_start, block_length)


def current_input_file():
    return getattr(_CTX, "input_file", None) or ("", 0, 0)


class InputFileName(Expression):
    """The current scan file's path; "" (never null) where there is
    none (Spark's input_file_name)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        return Literal(current_input_file()[0], dt.STRING).eval(batch)

    def __repr__(self):
        return "input_file_name()"


class _InputFileBlock(Expression):
    slot = 1

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        return Literal(current_input_file()[self.slot],
                       dt.INT64).eval(batch)


class InputFileBlockStart(_InputFileBlock):
    slot = 1

    def __repr__(self):
        return "input_file_block_start()"


class InputFileBlockLength(_InputFileBlock):
    slot = 2

    def __repr__(self):
        return "input_file_block_length()"


def contains_input_file(exprs) -> bool:
    """Whether any tree reads the scan's file context."""
    def walk(e):
        return isinstance(e, (InputFileName, _InputFileBlock)) or \
            any(walk(c) for c in e.children)
    return any(walk(e) for e in exprs)


class SparkPartitionID(Expression):
    """The partition id: 0, as one partition runs."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        return make_result(torch.zeros(batch.capacity, dtype=torch.int32,
                                       device=batch.device),
                           batch.live_mask(), dt.INT32)

    def __repr__(self):
        return "spark_partition_id()"


_HEX = b"0123456789abcdef"
#: where the 32 hex digits of a uuid land among its 36 characters
_DIGIT_AT = [i for i in range(36) if i not in (8, 13, 18, 23)]


class Uuid(Expression):
    """A random v4 UUID string per live row (GpuUuid)."""

    def __init__(self, seed: Optional[int] = None):
        super().__init__()
        self.seed = secrets.randbits(62) if seed is None else int(seed)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        dev, cap = batch.device, batch.capacity
        offset = getattr(_CTX, "offset", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed * 1_000_003 + offset) % (1 << 63))
        n = batch.num_rows
        raw = torch.randint(0, 256, (n, 16), generator=gen, device=dev,
                            dtype=torch.int64)
        raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40      # version 4
        raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80      # IETF variant
        nibbles = torch.stack([raw >> 4, raw & 0x0F], dim=2).reshape(n, 32)
        hexd = torch.tensor(list(_HEX), dtype=torch.uint8, device=dev)
        text = torch.full((n, 36), ord("-"), dtype=torch.uint8, device=dev)
        text[:, _DIGIT_AT] = hexd[nibbles]
        live = batch.live_mask()
        offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        offsets[1:] = torch.cumsum(live.to(torch.int32) * 36, 0,
                                   dtype=torch.int32)
        chars = torch.zeros(max(-(-n * 36 // 128) * 128, 128),
                            dtype=torch.uint8, device=dev)
        chars[:n * 36] = text.reshape(-1)
        return StringColumn(offsets, chars, live.clone(), pad_bucket=64)

    def __repr__(self):
        return "uuid()"


class RaiseErrorException(RuntimeError):
    pass


class RaiseError(Expression):
    """raise_error(msg): a row that reaches it raises (GpuRaiseError).
    Typed STRING as in the JAX package (Spark's NullType has no lane);
    no value escapes, since a reached row raises."""

    def __init__(self, message: str):
        super().__init__()
        self.message = message

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        from .ansi import guard
        guard(batch.live_mask(), RaiseErrorException(self.message), batch)
        return Literal(None, dt.STRING).eval(batch)

    def __repr__(self):
        return f"raise_error({self.message!r})"


class Version(Expression):
    """version(): the engine's name and version, a string literal."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        return Literal(version_string(), dt.STRING).eval(batch)

    def __repr__(self):
        return "version()"


def version_string() -> str:
    return f"spark_rapids_tpu {__version__}"


def uses_row_position(exprs) -> bool:
    """Whether a tree reads its rows' stream positions (the projection
    then binds ``row_offset``)."""
    def walk(e):
        return isinstance(e, (MonotonicallyIncreasingID, Uuid)) or \
            any(walk(c) for c in e.children)
    return any(walk(e) for e in exprs)


# --- user-facing constructors ---------------------------------------------

def monotonically_increasing_id() -> MonotonicallyIncreasingID:
    return MonotonicallyIncreasingID()


def spark_partition_id() -> SparkPartitionID:
    return SparkPartitionID()


def uuid_expr(seed: Optional[int] = None) -> Uuid:
    return Uuid(seed)


def raise_error(message: str) -> RaiseError:
    return RaiseError(message)


def version() -> Version:
    return Version()


def input_file_name() -> InputFileName:
    return InputFileName()


def input_file_block_start() -> InputFileBlockStart:
    return InputFileBlockStart()


def input_file_block_length() -> InputFileBlockLength:
    return InputFileBlockLength()
