"""Version and commit introspection.

Counterpart of ``paddlexde_tpu/version/__init__.py``: no subprocess at
import; ``commit()`` asks git on first use and ``show()`` prints the
version, the commit and the PyTorch build with its devices.
"""

from __future__ import annotations

import os
import subprocess

__version__ = "0.1.0"
__all__ = ["__version__", "commit", "show"]

_commit_cache = None


def _git(*args: str) -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.check_output(["git", *args], cwd=root, stderr=subprocess.DEVNULL,
                                   text=True).strip()


def commit() -> str:
    """The checkout's git revision ('unknown' outside a repository)."""
    global _commit_cache
    if _commit_cache is None:
        try:
            rev = _git("rev-parse", "HEAD")
            if _git("status", "--porcelain"):
                rev += ".dirty"
            _commit_cache = rev
        except Exception:
            _commit_cache = "unknown"
    return _commit_cache


def show() -> str:
    import torch

    cuda = (f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)"
            if torch.cuda.is_available() else "no CUDA card")
    info = (f"paddlexde_tpu_torch {__version__} (commit {commit()})\n"
            f"torch {torch.__version__}, {cuda}")
    print(info)
    return info
