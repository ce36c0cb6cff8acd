"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source in ``csrc/`` exports a plain C interface, so it is
compiled by ``nvcc`` alone into a shared library (seconds; no PyTorch
headers) and bound with :mod:`ctypes`.  Libraries go into ``_build/``
(git-ignored), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source builds anew
and an unchanged one is reused.  :func:`build_all` builds every source at
once, one ``nvcc`` each, in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["find_nvcc", "build_library", "build_all", "load_library",
           "KERNEL_SOURCES", "NVCC_FLAGS"]

# every kernel source of the port, by the name of its csrc/<name>.cu
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
                  "conv_bn_fwd", "conv_bn_bwd")

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")  # the toolkit's default prefix
# sm_90a (not sm_90): wgmma and setmaxnreg exist only for that target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``, else under the
    toolkit's default prefix ``/usr/local/cuda/bin``; raises if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "port's kernels")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/<name>-<hash>.so`` unless
    that file exists; returns its path.  The compiler's resource report
    (``-Xptxas -v``) is kept beside it as ``<name>-<hash>.ptxas.txt``."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent builder never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> List[Path]:
    """Build every source in ``names`` at once (one ``nvcc`` each, in
    parallel); returns the libraries' paths in order."""
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build_library, names))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name)))
            _loaded[name] = lib
        return lib
