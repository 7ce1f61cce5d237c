"""Build the CUDA kernels of ``csrc/`` on first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, under
``build/aircraft_tpu_torch/`` in the checkout, and loaded with ``ctypes``.
Every library exports ``<name>_launch``, ``<name>_layout`` (the field
layout of its by-value constants block, empty where it takes none) and
``kernel_error_string``.  The file name carries a hash of the sources, so
an edit rebuilds and an unchanged tree reuses the library.  ``build_all``
starts one ``nvcc`` per source at once.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aircraft_tpu_torch"
SOURCES = ("window_backward", "window_forward", "batched_cholesky",
           "fused_rollout")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of aircraft_tpu_torch "
                       "are built with the CUDA toolkit on the machine with "
                       "the card")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(out),
           str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no current library, one ``nvcc`` each,
    all started together.  Returns {name: compiler output}; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        launch = getattr(lib, f"{name}_launch")
        launch.restype = ctypes.c_int
        layout = getattr(lib, f"{name}_layout")
        layout.restype = ctypes.c_char_p
        lib.layout = [(f.split(":")[0], int(f.split(":")[1]))
                      for f in layout().decode().split(",") if f]
        lib.error_string = lib.kernel_error_string
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def pack_consts(lib: ctypes.CDLL, consts: dict):
    """The constants as a float array in the library's struct order."""
    flat = []
    for field, count in lib.layout:
        v = consts[field]
        vals = list(v) if isinstance(v, (tuple, list)) else [v]
        if len(vals) != count:
            raise ValueError(f"constant {field}: {len(vals)} values, "
                             f"kernel expects {count}")
        flat += [float(x) for x in vals]
    missing = set(consts) - {f for f, _ in lib.layout}
    if missing:
        raise ValueError(f"constants unknown to the kernel: {sorted(missing)}")
    return (ctypes.c_float * len(flat))(*flat)


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.error_string(err).decode()})"
