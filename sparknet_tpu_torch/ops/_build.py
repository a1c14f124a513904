"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `sparknet_tpu_torch/csrc/` is compiled on first use into
a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the flags and the toolkit's
`nvcc --version` (read once per process), so a library built from other
source, with other flags or by another nvcc is never loaded. The build
goes to `sparknet_tpu_torch/_build/` (listed in .gitignore) unless
`utils/compile_cache.init_compile_cache` points the process at another
directory (the warm-up cache that several processes or machines share),
written under a temporary name and renamed into place, so concurrent
builders never load a half-written library. nvcc's report (`-Xptxas -v`:
registers, shared memory, spills) is kept beside the library as
`<name>-<hash>.log`.

Building does not include PyTorch's headers, so one source compiles in
seconds. `build_all` starts one nvcc per source at once.

Each thread counts what its `build_all` calls found (`counts()`): `build`
per nvcc run, `hit` per library already on disk, `miss` per library that
was not (nvcc then ran). `utils/compile_cache.track_compiles` reads these
counts over a region, on the thread that runs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DEFAULT_BUILD_DIR = BUILD_DIR

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_tls = threading.local()
_toolkit: Optional[str] = None


def counts() -> Dict[str, int]:
    """This thread's running counts: {"build", "hit", "miss"}."""
    c = getattr(_tls, "counts", None)
    if c is None:
        c = _tls.counts = {"build": 0, "hit": 0, "miss": 0}
    return c


def relocate(build_dir: Path) -> None:
    """Build into and load from `build_dir` from now on (called by
    `utils/compile_cache.init_compile_cache` only). Libraries this process
    already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(build_dir)


def nvcc_path() -> str:
    """$CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or nvcc on PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "are built from source on first use")
    return found


def toolkit_id() -> str:
    """`nvcc --version` of this machine's toolkit, read once per process
    ("nvcc: not found" where there is none: nothing can be built then)."""
    global _toolkit
    if _toolkit is None:
        try:
            nvcc = nvcc_path()
        except RuntimeError:
            _toolkit = "nvcc: not found"
        else:
            _toolkit = subprocess.run([nvcc, "--version"], check=True,
                                      capture_output=True,
                                      text=True).stdout
    return _toolkit


def library_path(name: str) -> Path:
    """Where the library for csrc/<name>.cu lives once built: keyed by the
    source, the flags and the toolkit."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(toolkit_id().encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process or None, tmp path, final path)."""
    out = library_path(name)
    c = counts()
    if out.exists():
        c["hit"] += 1
        return None, None, out
    c["miss"] += 1
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    c["build"] += 1
    return proc, tmp, out


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc each,
    all started together; raises with nvcc's output if any fails."""
    started = [(n, *_start(n)) for n in names]
    failures = []
    for name, proc, tmp, out in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            if tmp.exists():
                tmp.unlink()
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: out for name, _, _, out in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
