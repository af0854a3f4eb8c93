"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All sources
are compiled in parallel (one ``nvcc`` process each) the first time any
kernel is called, never at import. Libraries land in ``.torch_ext_build/`` at
the repository root, named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused. A failed build raises.

Every C entry point takes device pointers, sizes and the CUDA stream as
plain integers and returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise on a non-zero code (:func:`check`).

``LAUNCHES`` counts kernel launches per kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. The backward wrappers (``gcn_bwd``,
``attn_bwd``) launch several CUDA kernels per call and count the call once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("spline.cu", "gcn.cu", "gcn_bwd.cu", "attn.cu", "attn_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

LAUNCHES: Dict[str, int] = {"spline": 0, "gcn_fwd": 0, "gcn_bwd": 0, "attn_fwd": 0, "attn_bwd": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from source at first use"
    )


def _target(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library; returns seconds."""
    start = time.perf_counter()
    with _lock:
        todo = [s for s in SOURCES if not _target(s).exists()]
        if not todo:
            return time.perf_counter() - start
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for source in todo:
            tmp = _target(source).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs.append((source, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for source, tmp, cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(source))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(f"{name}.cu")))
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        fn = lib.pxt_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"CUDA launch of {kernel} failed: cudaError {code} "
            f"({fn(code).decode()})"
        )
