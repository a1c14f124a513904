"""ctypes binding for the host C++ data plane (`native/jpeg_plane.cpp`).

A copy of `sparknet_tpu/data/jpeg_plane.py` for the port: JPEG decode +
force-resize + planar CHW, the fused crop/mean-subtract/NHWC batch kernel
(float32 or bfloat16 out) and the tar member indexer. The library is
loaded from `native/libjpeg_plane.so` when that file exists (read-only:
the port never writes under `native/`); otherwise it is built from
`native/jpeg_plane.cpp` with g++ into the port's build directory
(`sparknet_tpu_torch/_build/`, gitignored), keyed by a hash of the source,
the flags and the host's CPU, since `-march=native` code only runs where
it was built. `available()` gates every caller; `unavailable_reason()`
says why the plane is off (no libjpeg, a failed build), so a caller can
print the preprocessing route it takes.

`crop_mean_nhwc(..., out_dtype="bfloat16")` returns a CPU
`torch.bfloat16` tensor (numpy has no bfloat16) written by the native
loop with round-to-nearest-even, bit-identical to torch's cast.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent.parent.parent
_SOURCE = _REPO / "native" / "jpeg_plane.cpp"
_COMMITTED = _REPO / "native" / "libjpeg_plane.so"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why the plane is unavailable


def _cpu_id() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return platform.machine() + flags


def build_path() -> Path:
    """Where a library built here from `native/jpeg_plane.cpp` lives."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_id().encode())
    return _BUILD_DIR / f"libjpeg_plane-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """g++ the plane into `out` (written under a temporary name, renamed
    into place, so a concurrent loader never sees half a file)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SOURCE),
                        "-ljpeg"], check=True, capture_output=True,
                       text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    path = _COMMITTED
    if not path.exists():
        path = build_path()
        if not path.exists():
            try:
                _build(path)
            except subprocess.CalledProcessError as e:
                _reason = (f"building {_SOURCE.name} failed: "
                           f"{e.stderr.strip().splitlines()[-1:]}")
                return None
            except (OSError, subprocess.SubprocessError) as e:
                _reason = f"building {_SOURCE.name} failed: {e}"
                return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _reason = f"loading {path.name} failed: {e}"
        return None
    lib.jp_decode_resize_chw.restype = ctypes.c_int
    lib.jp_decode_resize_chw.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.jp_decode_resize_chw_batch.restype = None
    lib.jp_decode_resize_chw_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int)]
    crop_args = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.jp_crop_mean_nhwc.restype = None
    lib.jp_crop_mean_nhwc.argtypes = crop_args + [
        ctypes.POINTER(ctypes.c_float)]
    try:
        lib.jp_crop_mean_nhwc_bf16.restype = None
        lib.jp_crop_mean_nhwc_bf16.argtypes = crop_args + [
            ctypes.POINTER(ctypes.c_uint16)]
    except AttributeError:
        lib.jp_crop_mean_nhwc_bf16 = None  # pre-bf16 .so build
    try:
        lib.jp_tar_index.restype = ctypes.c_long
        lib.jp_tar_index.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_long]
    except AttributeError:
        lib.jp_tar_index = None  # pre-index .so build
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """None when the plane loads, else why it does not."""
    _load()
    return _reason


def decode_resize_chw(data: bytes, height: int, width: int) -> np.ndarray:
    """One JPEG -> CHW uint8 at (height, width). Raises ValueError on corrupt
    input (same contract as the PIL fallback)."""
    lib = _load()
    assert lib is not None, "native plane unavailable"
    out = np.empty((3, height, width), dtype=np.uint8)
    rc = lib.jp_decode_resize_chw(
        data, len(data), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out


def decode_resize_chw_batch(jpegs: list, height: int, width: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel batch decode. Returns (images (N,3,H,W) uint8, ok (N,) bool);
    corrupt entries have ok=False and undefined pixels."""
    lib = _load()
    assert lib is not None, "native plane unavailable"
    n = len(jpegs)
    blob = b"".join(jpegs)
    offsets = np.zeros(n, dtype=np.int64)
    lengths = np.array([len(j) for j in jpegs], dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    out = np.empty((n, 3, height, width), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.int32)
    lib.jp_decode_resize_chw_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n, height,
        width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, ok == 0


def supports_bf16_out() -> bool:
    lib = _load()
    return lib is not None and \
        getattr(lib, "jp_crop_mean_nhwc_bf16", None) is not None


def crop_mean_nhwc(images_chw_u8: np.ndarray,
                   mean_chw: Optional[np.ndarray],
                   ys: np.ndarray, xs: np.ndarray, crop: int,
                   out_dtype: str = "float32"):
    """Fused mean-subtract + crop + NHWC for a CHW uint8 batch: a float32
    numpy array, or with out_dtype 'bfloat16' a CPU torch.bfloat16 tensor
    written straight from the OpenMP loop."""
    lib = _load()
    assert lib is not None, "native plane unavailable"
    images_chw_u8 = np.ascontiguousarray(images_chw_u8, dtype=np.uint8)
    n, c, h, w = images_chw_u8.shape
    ys = np.ascontiguousarray(ys, dtype=np.int32)
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    if ys.shape != (n,) or xs.shape != (n,) or crop > min(h, w) or (
            n and (ys.min() < 0 or xs.min() < 0 or ys.max() > h - crop
                   or xs.max() > w - crop)):
        raise ValueError(f"crop {crop} at offsets ys/xs out of range for "
                         f"{n} images of {h}x{w}")
    mean_ptr = None
    if mean_chw is not None:
        mean_chw = np.ascontiguousarray(mean_chw, dtype=np.float32)
        if mean_chw.shape != (c, h, w):
            raise ValueError(f"mean image {mean_chw.shape} != {(c, h, w)}")
        mean_ptr = mean_chw.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    args = (images_chw_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, c, h, w, mean_ptr,
            ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), crop)
    if out_dtype == "bfloat16":
        if not supports_bf16_out():
            raise RuntimeError("the native plane predates bf16 output")
        out = torch.empty((n, crop, crop, c), dtype=torch.bfloat16)
        lib.jp_crop_mean_nhwc_bf16(
            *args, ctypes.cast(out.data_ptr(),
                               ctypes.POINTER(ctypes.c_uint16)))
        return out
    if out_dtype != "float32":
        raise ValueError(f"out_dtype {out_dtype!r}: float32 or bfloat16")
    out = np.empty((n, crop, crop, c), dtype=np.float32)
    lib.jp_crop_mean_nhwc(
        *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


class TruncatedTarError(OSError):
    """A shard is missing data (truncated mid-member or missing the tar
    end-of-archive terminator). Distinct from plain OSError so callers
    that fall back to tarfile on INDEXING problems still surface this
    loudly — Python's tarfile iterates a boundary-truncated archive
    silently, so falling back would train on partial data."""


def supports_tar_index() -> bool:
    lib = _load()
    return lib is not None and \
        getattr(lib, "jp_tar_index", None) is not None


def tar_index(path: str, name_cap: int = 128):
    """Parse a local tar's member table in C (no GIL-held Python walk):
    returns (data_offsets int64[n], sizes int64[n], isfile bool[n],
    basenames list[str]) with member numbering identical to Python
    tarfile iteration, or None when the archive uses extension headers
    (GNU long names / pax) — callers fall back to tarfile."""
    lib = _load()
    assert lib is not None, "native plane unavailable"
    if getattr(lib, "jp_tar_index", None) is None:
        return None  # pre-index .so build
    max_n = max(64, os.path.getsize(path) // 512 // 2 + 2)
    offsets = np.zeros(max_n, dtype=np.int64)
    sizes = np.zeros(max_n, dtype=np.int64)
    isfile = np.zeros(max_n, dtype=np.uint8)
    names = np.zeros(max_n * name_cap, dtype=np.uint8)
    n = lib.jp_tar_index(
        path.encode(), max_n,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        isfile.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        names.ctypes.data_as(ctypes.c_char_p), name_cap)
    if n == -1:
        return None  # extension headers: numbering would diverge
    if n == -4:
        raise TruncatedTarError(
            f"tar {path!r} ended without the zero end-of-archive block — "
            f"truncated at a member boundary?")
    if n < 0:
        raise OSError(f"tar index of {path!r} failed (rc={n})")
    if n and int(offsets[n - 1] + sizes[n - 1]) > os.path.getsize(path):
        # truncated archive: fseek past EOF "succeeds", so the C walk can
        # index members whose data is missing
        raise TruncatedTarError(
            f"tar {path!r} is truncated (last member extends past EOF)")
    name_list = [bytes(names[i * name_cap:(i + 1) * name_cap]
                       ).split(b"\0", 1)[0].decode("utf-8", "replace")
                 for i in range(n)]
    return offsets[:n], sizes[:n], isfile[:n].astype(bool), name_list
