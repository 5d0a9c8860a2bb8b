"""The host library (Parquet and ORC): build and ctypes bindings.

``csrc/host/parquet_decode.cpp`` (the port's copy of the JAX package's
``native/parquet_decode.cpp``, plus BOOLEAN and FIXED_LEN_BYTE_ARRAY
lanes) and ``csrc/host/parquet_encode.cpp`` (the writer's pages) and
``csrc/host/orc.cpp`` (ORC's framing, RLEs and decimals, both ways) are
compiled with ``g++ -O3 -shared`` at first use into
``spark_rapids_tpu_torch/build/host/``, under a name that hashes the
sources, the compiler and the codec flags, so a changed source or
machine builds afresh. The
library is bound with ``ctypes``, which releases the GIL for each call:
the reader and writer pools decode and encode in parallel.

Snappy is the port's own code (``csrc/host/codecs.h``); GZIP and ZSTD
come from the machine's zlib and libzstd, linked by the runtime soname
that ``ldconfig -p`` lists (no development headers are needed). A codec
whose library is absent is left out of the build: a chunk in it raises
an error naming the codec. ``codecs()`` says which the build has.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("spark_rapids_tpu_torch.io")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG, "csrc", "host")
SOURCES = [os.path.join(SOURCE_DIR, "parquet_decode.cpp"),
           os.path.join(SOURCE_DIR, "parquet_encode.cpp"),
           os.path.join(SOURCE_DIR, "orc.cpp")]
HEADERS = [os.path.join(SOURCE_DIR, "codecs.h")]
BUILD_DIR = os.path.join(_PKG, "build", "host")

#: the library's codec ids (csrc/host/codecs.h; DEFLATE is ORC's ZLIB)
CODEC_IDS = {"UNCOMPRESSED": 0, "SNAPPY": 1, "GZIP": 2, "ZSTD": 3,
             "DEFLATE": 4}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

_LIB: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _runtime_sonames() -> Dict[str, str]:
    """{"z": path, "zstd": path} for the runtime libraries ldconfig
    lists (the versioned soname; an unversioned dev symlink also
    does)."""
    out = subprocess.run(["ldconfig", "-p"], capture_output=True,
                         text=True).stdout
    found: Dict[str, str] = {}
    for line in out.splitlines():
        if "=>" not in line:
            continue
        name = line.split()[0]
        path = line.split("=>")[-1].strip()
        for lib in ("z", "zstd"):
            if name in (f"lib{lib}.so.1", f"lib{lib}.so") and \
                    lib not in found:
                found[lib] = path
    return found


def _build_flags() -> Tuple[List[str], List[str]]:
    """(-D defines, link arguments) for the codecs this machine has."""
    libs = _runtime_sonames()
    defines, links = [], []
    if "z" in libs:
        defines.append("-DSRT_HAVE_ZLIB")
        links.append(libs["z"])
    if "zstd" in libs:
        defines.append("-DSRT_HAVE_ZSTD")
        links.append(libs["zstd"])
    return defines, links


def library_path() -> str:
    """Build the library (skipped when this source, compiler and flag
    set is built) and return its path."""
    defines, links = _build_flags()
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    compiler = subprocess.run(["g++", "--version"], capture_output=True,
                              text=True, check=True).stdout
    h.update(" ".join(defines + links + [compiler, platform.platform()])
             .encode())
    so = os.path.join(BUILD_DIR, f"libsrt_parquet-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    done = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *defines,
         "-o", tmp, *SOURCES, *links],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed ({done.returncode}):\n{done.stdout}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The library, built and bound at the first call."""
    got = _LIB.get("lib")
    if got is not None:
        return got
    with _LOCK:
        got = _LIB.get("lib")
        if got is not None:
            return got
        so = library_path()
        got = ctypes.CDLL(so)
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        got.parquet_decode_chunk.restype = i64
        got.parquet_decode_chunk.argtypes = [p, i64, i32, i32, i32, i64,
                                             i32, i32, p, i64, p, p, p, p,
                                             i64]
        got.parquet_decode_chunk_binary.restype = i64
        got.parquet_decode_chunk_binary.argtypes = [p, i64, i32, i64, i32,
                                                    i32, p, p, i64, p, p, p,
                                                    p, i64]
        got.parquet_encode_chunk.restype = i64
        got.parquet_encode_chunk.argtypes = [i32, p, i32, p, p, i64, i32,
                                             i32, i64, p, i64, p, p, p, i32]
        got.srt_codec_mask.restype = i32
        got.srt_codec_mask.argtypes = []
        got.srt_compress_bound.restype = i64
        got.srt_compress_bound.argtypes = [i64]
        got.srt_compress.restype = i64
        got.srt_compress.argtypes = [i32, p, i64, p, i64]
        got.srt_decompress.restype = i32
        got.srt_decompress.argtypes = [i32, p, i64, p, i64, p]
        got.srt_string_minmax.restype = None
        got.srt_string_minmax.argtypes = [p, p, p, i64, p]
        for name, args in (
                ("orc_deframe", [p, i64, i32, p, i64]),
                ("orc_frame", [p, i64, i32, i64, p, i64]),
                ("orc_bool_rle", [p, i64, p, i64]),
                ("orc_byte_rle", [p, i64, p, i64]),
                ("orc_int_rle", [p, i64, i32, i32, p, i64]),
                ("orc_decimal", [p, i64, p, p, i64]),
                ("orc_byte_rle_encode", [p, i64, p, i64]),
                ("orc_int_rle_v1_encode", [p, i64, i32, p, i64]),
                ("orc_decimal_encode", [p, p, i64, p, i64])):
            fn = getattr(got, name)
            fn.restype, fn.argtypes = i64, args
        _LIB["lib"] = got
        logger.info("parquet host library %s, codecs %s",
                    os.path.basename(so), codecs())
    return got


def codecs() -> List[str]:
    """The codecs this build decodes and encodes."""
    mask = lib().srt_codec_mask()
    return [CODEC_NAMES[c] for c in range(4) if mask >> c & 1]


def ptr(a: Optional[np.ndarray]):
    """The address of a contiguous array's first byte (None for
    None)."""
    if a is None:
        return None
    return a.ctypes.data


class CodecMissing(NotImplementedError):
    """A chunk or page in a codec this build of the library lacks."""


_ERRORS = {-1: "malformed data", -2: "an encoding or layout outside the "
           "decoder", -3: "a buffer too small", -4: "codec not in this build"}


def check_rc(rc: int, what: str, codec: int) -> int:
    """Raise for a negative return code of the library."""
    if rc >= 0:
        return rc
    if rc == -4:
        raise CodecMissing(f"{what}: the {CODEC_NAMES.get(codec, codec)} "
                           f"codec is not in this build (codecs "
                           f"{codecs()})")
    raise ValueError(f"{what}: {_ERRORS.get(rc, rc)} (code {rc})")


def compress(codec: int, data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(lib().srt_compress_bound(len(src)) + 64, np.uint8)
    n = check_rc(lib().srt_compress(codec, ptr(src), len(src), ptr(dst),
                                    len(dst)), "compress", codec)
    return dst[:n].tobytes()


def decompress(codec: int, data: bytes, size: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(max(size, 1), np.uint8)
    got = ctypes.c_int64()
    if not lib().srt_codec_mask() >> codec & 1:
        check_rc(-4, "decompress", codec)
    ok = lib().srt_decompress(codec, ptr(src), len(src), ptr(dst), len(dst),
                              ctypes.addressof(got))
    if not ok:
        raise ValueError(f"decompress: corrupt {CODEC_NAMES[codec]} data")
    return dst[:got.value].tobytes()
