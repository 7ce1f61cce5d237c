"""Native (C++) host-side runtimes with ctypes bindings.

``build_native_lib`` compiles ``native/<stem>.cpp`` with ``g++`` on first
use into the port's build directory (``build/aircraft_tpu_torch/``, the
one ``kernels/_build.py`` builds the CUDA kernels into), never into the
source tree.  The library's file name carries a hash of its source, so an
edit rebuilds.  A build or load failure is remembered and returns None:
every runtime here has a pure-Python fallback writing the same output.

The batch Dubins engine (``dubins.cpp``: ``shortest_batch``,
``sample_batch``) is host code for warm-start geometry, not a device
kernel; without a toolchain it falls back to ``dubins/dubins2d.py``
path by path.  The flight recorder is ``native/telemetry.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

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


def _configure_dubins(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dubins_shortest_batch.argtypes = [dp, dp, dp, dp, ctypes.c_int, dp,
                                          u8p]
    lib.dubins_shortest_batch.restype = None
    lib.dubins_sample_batch.argtypes = [dp, dp, dp, ctypes.c_int,
                                        ctypes.c_int, dp]
    lib.dubins_sample_batch.restype = None


def _dubins_lib() -> Optional[ctypes.CDLL]:
    return build_native_lib("dubins", _configure_dubins)


def native_available() -> bool:
    """Whether the batch Dubins engine built and loaded."""
    return _dubins_lib() is not None


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def shortest_batch(qis: np.ndarray, qfs: np.ndarray, rhos: np.ndarray,
                   min_lengths: Optional[np.ndarray] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Shortest Dubins paths of a batch: qis, qfs (B, 3) configurations
    (x, y, psi), rhos (B,) turn radii, optional min_lengths (B,).  Returns
    (paths (B, 5) [word index, t, p, q, length], ok (B,) bool); a path not
    found stays zero with ok False."""
    qis, qfs, rhos = _f64(qis), _f64(qfs), _f64(rhos)
    B = qis.shape[0]
    out = np.zeros((B, 5), dtype=np.float64)
    ok = np.zeros(B, dtype=np.uint8)

    lib = _dubins_lib()
    if lib is not None:
        ml = None if min_lengths is None else _f64(min_lengths)
        lib.dubins_shortest_batch(
            _as_c(qis), _as_c(qfs), _as_c(rhos),
            None if ml is None else _as_c(ml), B, _as_c(out),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out, ok.astype(bool)

    from aircraft_tpu_torch.dubins.dubins2d import WORDS, shortest_path

    for b in range(B):
        p = shortest_path(qis[b], qfs[b], float(rhos[b]),
                          None if min_lengths is None
                          else float(min_lengths[b]))
        if p is not None:
            out[b] = [WORDS.index(p.word), *p.params, p.length]
            ok[b] = 1
    return out, ok.astype(bool)


def sample_batch(qis: np.ndarray, rhos: np.ndarray, paths: np.ndarray,
                 n: int) -> np.ndarray:
    """Each path of ``shortest_batch`` sampled at n uniform arc lengths:
    (B, n, 3) configurations."""
    qis, rhos, paths = _f64(qis), _f64(rhos), _f64(paths)
    B = qis.shape[0]
    out = np.zeros((B, n, 3), dtype=np.float64)

    lib = _dubins_lib()
    if lib is not None:
        lib.dubins_sample_batch(_as_c(qis), _as_c(rhos), _as_c(paths), B, n,
                                _as_c(out))
        return out

    from aircraft_tpu_torch.dubins.dubins2d import WORDS, DubinsPath

    for b in range(B):
        p = DubinsPath(qi=qis[b], qf=np.zeros(3), rho=float(rhos[b]),
                       word=WORDS[int(paths[b, 0])], params=paths[b, 1:4])
        out[b] = p.sample_many(n)
    return out


__all__ = ["build_native_lib", "lib_path", "native_available",
           "shortest_batch", "sample_batch"]
