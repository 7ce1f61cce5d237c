"""Native (C++) host-side runtimes with ctypes bindings.

``build_native_lib`` compiles ``native/<stem>.cpp`` with ``g++`` on first
use into the port's build directory (``build/aircraft_tpu_torch/``, the
one ``kernels/_build.py`` builds the CUDA kernels into), never into the
source tree.  The library's file name carries a hash of its source, so an
edit rebuilds.  A build or load failure is remembered and returns None:
every runtime here has a pure-Python fallback writing the same output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from aircraft_tpu_torch.kernels._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIBS: dict = {}
_FAILED: set = set()


def lib_path(stem: str) -> Path:
    """Where the library of ``native/<stem>.cpp`` is built."""
    digest = hashlib.sha256((_DIR / f"{stem}.cpp").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:12]}.so"


def build_native_lib(stem: str, configure) -> Optional[ctypes.CDLL]:
    """Build ``native/<stem>.cpp`` into ``lib<stem>_<hash>.so`` under the
    build directory if it is not there yet, load it, and run
    ``configure(lib)`` to declare argtypes.  Cached per stem; a failure
    is remembered and returns None (callers fall back to pure Python)."""
    with _LOCK:
        if stem in _LIBS:
            return _LIBS[stem]
        if stem in _FAILED:
            return None
        try:
            so = lib_path(stem)
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", str(tmp), str(_DIR / f"{stem}.cpp"), "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            configure(lib)
            _LIBS[stem] = lib
            return lib
        except Exception:
            _FAILED.add(stem)
            return None


__all__ = ["build_native_lib", "lib_path"]
