"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All sources
are compiled in parallel (one ``nvcc`` process each) the first time any
kernel is called, never at import. Libraries land in ``.torch_ext_build/`` at
the repository root, named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. A failed build raises. The compiler's report
(``-Xptxas -v``: registers, spills and shared memory of each kernel) is kept
beside each library (:func:`build_log`).

Every C entry point takes device pointers, sizes and the CUDA stream as
plain integers and returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise on a non-zero code (:func:`check`).

``LAUNCHES`` counts kernel launches per kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. The history lookup's forward counts
under ``spline`` (one launch for one query set or two) and its lag gradient
under ``spline_bwd``. The backward wrappers (``gcn_bwd``, ``attn_bwd``)
and the attention forwards launch several CUDA kernels per call and count
the call once. The bfloat16 forms count under keys of
their own (``gcn_fwd_bf16``, ``attn_fwd_bf16``, ``attn_bwd_bf16``, and
``gcn_bwd_bf16`` for the GCN backward kernels on a bfloat16 cotangent), and
so do the dropout forms of the attention kernels (``attn_fwd_dropout``,
``attn_bwd_dropout``, ``attn_fwd_bf16_dropout``, ``attn_bwd_bf16_dropout``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "build_all", "library", "library_path", "build_log",
           "tool", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("spline.cu", "gcn.cu", "gcn_bwd.cu", "attn.cu", "attn_bwd.cu", "gcn_bf16.cu",
           "attn_bf16.cu", "attn_bwd_bf16.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {"spline": 0, "spline_bwd": 0, "gcn_fwd": 0, "gcn_bwd": 0,
                            "attn_fwd": 0, "attn_bwd": 0, "gcn_fwd_bf16": 0, "attn_fwd_bf16": 0,
                            "gcn_bwd_bf16": 0, "attn_bwd_bf16": 0, "attn_fwd_dropout": 0,
                            "attn_bwd_dropout": 0, "attn_fwd_bf16_dropout": 0,
                            "attn_bwd_bf16_dropout": 0}

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


def tool(name: str) -> str:
    """A program of the CUDA toolkit beside ``nvcc`` (``cuobjdump``, ...)."""
    return str(Path(_nvcc()).with_name(name))


def _headers(source: str):
    """The ``csrc/`` headers that ``source`` includes, directly or through
    another header, in include order."""
    found, todo = [], [source]
    while todo:
        text = (CSRC / todo.pop()).read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
            if name not in found and (CSRC / name).is_file():
                found.append(name)
                todo.append(name)
    return found


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for name in _headers(source):
        h.update(name.encode() + (CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


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
                _target(source).with_suffix(".log").write_text(out)
                os.replace(tmp, _target(source))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def library_path(name: str) -> Path:
    """The built library of ``csrc/<name>.cu`` (built if missing)."""
    build_all()
    return _target(f"{name}.cu")


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


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
