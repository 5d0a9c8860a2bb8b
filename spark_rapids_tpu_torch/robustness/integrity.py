"""Data integrity for off-device bytes.

Counterpart of spark_rapids_tpu/robustness/integrity.py, copied: a
crc32c-style masked checksum (stdlib ``zlib.crc32`` with the
snappy/LevelDB rotation mask, so a CRC stored next to its own payload
never checksums to itself), the framed envelope (magic | length |
masked crc | payload) and ``DataCorruption``, the error every
verification failure raises. The port's spill tiers checksum their host
and disk buffers with ``array_checksum`` (memory/spill.py); the scan
counts ``DataCorruption`` among a corrupt file's errors (io/scan.py).
``DataCorruption`` does not subclass OSError: a storage tier surfaces
it so that the caller recomputes instead of retrying a read that can
never succeed. Its construction emits ``CorruptionDetected`` to the
event log (obs/events.py).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Union

Buffer = Union[bytes, bytearray, memoryview]

#: envelope magic "SRTC" (SRT + Checksum), little-endian u32
MAGIC = 0x53525443
#: magic u32 | payload_len u64 | masked crc u32
_HDR = struct.Struct("<IQI")
HEADER_SIZE = _HDR.size

# snappy/LevelDB CRC mask constant: storing crc(data) adjacent to data
# makes crc(data || crc) degenerate; the rotation+offset mask breaks
# that self-similarity (the "crc32c-style" masked form).
_MASK_DELTA = 0xA282EAD8


class DataCorruption(RuntimeError):
    """Off-device bytes failed verification (checksum/length/magic).

    Carries enough context to attribute the corruption to a tier and
    entry. Storage tiers raise it directly (the data is gone — only a
    recompute helps); the shuffle transport converts it into a fetch
    failure so retry/failover/stage-rerun machinery regenerates the
    block.
    """

    def __init__(self, what: str, expected: Optional[int] = None,
                 actual: Optional[int] = None, detail: str = ""):
        msg = f"DataCorruption: {what}"
        if expected is not None or actual is not None:
            msg += (f" (expected={_hex(expected)} actual={_hex(actual)})")
        if detail:
            msg += f" [{detail}]"
        super().__init__(msg)
        self.what = what
        self.expected = expected
        self.actual = actual
        self.detail = detail
        # central choke point: every verification failure in the engine
        # constructs one of these, so the event log sees them all
        from ..obs import events as _events
        _events.emit("CorruptionDetected", what=what,
                     expected=_hex(expected), actual=_hex(actual),
                     detail=detail)


def _hex(v: Optional[int]) -> str:
    return "?" if v is None else f"0x{v:08x}"


def checksum(data: Buffer, value: int = 0) -> int:
    """Masked crc32c-style checksum of a buffer (incremental via
    ``value``: pass a previous UNMASKED running crc from
    :func:`checksum_update` only — this function masks its output)."""
    return mask_crc(zlib.crc32(data, value) & 0xFFFFFFFF)


def checksum_update(value: int, data: Buffer) -> int:
    """Running (unmasked) crc for chunked streams; finish with
    :func:`mask_crc`."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def wrap(payload: bytes) -> bytes:
    """Frame ``payload`` with the checksum envelope."""
    return _HDR.pack(MAGIC, len(payload), checksum(payload)) + payload


def unwrap(framed: Buffer, what: str = "block") -> bytes:
    """Verify and strip the envelope; raises :class:`DataCorruption`
    on any mismatch (magic, length, checksum)."""
    if len(framed) < HEADER_SIZE:
        raise DataCorruption(
            f"{what}: framed envelope truncated to {len(framed)} bytes "
            f"(header needs {HEADER_SIZE})")
    magic, length, crc = _HDR.unpack_from(framed, 0)
    if magic != MAGIC:
        raise DataCorruption(f"{what}: bad envelope magic",
                             expected=MAGIC, actual=magic)
    payload = bytes(memoryview(framed)[HEADER_SIZE:])
    if len(payload) != length:
        raise DataCorruption(
            f"{what}: payload length mismatch "
            f"(declared {length}, got {len(payload)})")
    actual = checksum(payload)
    if actual != crc:
        raise DataCorruption(f"{what}: checksum mismatch",
                             expected=crc, actual=actual)
    return payload


def strip(framed: Buffer) -> bytes:
    """Remove the envelope WITHOUT verification — the
    srt.integrity.checksum.enabled=false path (storage format stays
    framed either way)."""
    return bytes(memoryview(framed)[HEADER_SIZE:])


def verify_framed(framed: Buffer, what: str = "block") -> None:
    """Checksum-verify an envelope without copying the payload out —
    the server-side pre-serve check."""
    if len(framed) < HEADER_SIZE:
        raise DataCorruption(
            f"{what}: framed envelope truncated to {len(framed)} bytes "
            f"(header needs {HEADER_SIZE})")
    magic, length, crc = _HDR.unpack_from(framed, 0)
    if magic != MAGIC:
        raise DataCorruption(f"{what}: bad envelope magic",
                             expected=MAGIC, actual=magic)
    payload = memoryview(framed)[HEADER_SIZE:]
    if len(payload) != length:
        raise DataCorruption(
            f"{what}: payload length mismatch "
            f"(declared {length}, got {len(payload)})")
    actual = checksum(payload)
    if actual != crc:
        raise DataCorruption(f"{what}: checksum mismatch",
                             expected=crc, actual=actual)


def array_checksum(arr) -> int:
    """Masked checksum of a numpy array's bytes (C-order; non-contiguous
    inputs are compacted first so views checksum identically to their
    copies)."""
    import numpy as np
    a = np.ascontiguousarray(arr)
    return checksum(a.view(np.uint8).reshape(-1))


def file_checksum(path: str, chunk: int = 1 << 20) -> int:
    """Masked checksum of a file's contents, read in chunks."""
    crc = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = checksum_update(crc, block)
    return mask_crc(crc)
