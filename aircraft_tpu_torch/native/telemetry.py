"""Async telemetry recorder: ctypes binding over the native C++ runtime
(`telemetry.cpp`, built by ``native.build_native_lib``) with a pure-Python
fallback writing the identical format.

Role of the reference's SaveMixin/logging (reference
src/aircraft/control/base.py:48-114,508-541), redesigned so observability
never blocks the control loop: ``push`` copies into a bounded ring and
returns; a background thread owns the disk.  A full ring DROPS records
(counted) instead of stalling the producer — the reference's synchronous
plotting callback cost 411 s of a 423 s solve (SURVEY.md §6) and this is
the structural fix.

Binary format (shared by both backends):
  8 bytes magic ``ATPTLOG1`` | uint32 version | uint32 rec_floats |
  written * rec_floats float64, little-endian.
"""

from __future__ import annotations

import ctypes
import queue
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from aircraft_tpu_torch.native import build_native_lib

_MAGIC = b"ATPTLOG1"
_VERSION = 1


def _configure(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_long)
    lib.tel_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
    lib.tel_open.restype = ctypes.c_void_p
    lib.tel_push.argtypes = [ctypes.c_void_p, dp, ctypes.c_long]
    lib.tel_push.restype = ctypes.c_long
    lib.tel_flush.argtypes = [ctypes.c_void_p]
    lib.tel_flush.restype = None
    lib.tel_stats.argtypes = [ctypes.c_void_p, lp, lp]
    lib.tel_stats.restype = None
    lib.tel_close.argtypes = [ctypes.c_void_p]
    lib.tel_close.restype = None


def _get_lib() -> Optional[ctypes.CDLL]:
    return build_native_lib("telemetry", _configure)


def native_available() -> bool:
    return _get_lib() is not None


class _PyBackend:
    """Fallback: same drop-not-block semantics via a bounded in-memory
    record budget and a writer thread; identical on-disk format.

    Matches the native backend's contracts: ``capacity`` bounds buffered
    RECORDS (not push calls), pushes are snapshotted (caller may reuse its
    buffer), counters are lock-protected for concurrent producers, and
    ``flush`` uses Queue.join so it cannot return while an item is still
    queued or being written."""

    def __init__(self, path: str, rec_floats: int, capacity: int):
        self.rec_floats = rec_floats
        self.capacity = capacity
        self._f = open(path, "wb")
        self._f.write(_MAGIC + struct.pack("<II", _VERSION, rec_floats))
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self._mu = threading.Lock()
        self._queued = 0       # records in the queue (the capacity budget)
        self.written = 0
        self.dropped = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                break
            item.tofile(self._f)
            with self._mu:
                self.written += len(item)
                self._queued -= len(item)
            self._q.task_done()

    def push(self, recs: np.ndarray) -> int:
        n = len(recs)
        with self._mu:
            space = self.capacity - self._queued
            accept = min(n, max(space, 0))
            self._queued += accept
            self.dropped += n - accept
        if accept > 0:
            # snapshot (native memcpy's at push time too): the caller may
            # mutate its buffer immediately after push returns
            self._q.put(np.array(recs[:accept], dtype="<f8"))
        return accept

    def flush(self):
        self._q.join()
        self._f.flush()

    def stats(self) -> Tuple[int, int]:
        with self._mu:
            return self.written, self.dropped

    def close(self):
        self._q.put(None)
        self._t.join()
        self._f.close()


class TelemetryRecorder:
    """Async fixed-width float64 record log.

    ``rec_floats`` doubles per record; ``capacity`` records buffered in
    memory.  ``push`` never blocks on disk; overflow records are dropped and
    counted (``stats()``).  Use as a context manager or call ``close()``.
    """

    def __init__(self, path, rec_floats: int, capacity: int = 1 << 16,
                 force_python: bool = False):
        self.path = str(path)
        self.rec_floats = int(rec_floats)
        lib = None if force_python else _get_lib()
        self._lib = lib
        self._py: Optional[_PyBackend] = None
        self._h = None
        if lib is not None:
            h = lib.tel_open(self.path.encode(), self.rec_floats,
                             int(capacity))
            if h:
                self._h = ctypes.c_void_p(h)
        if self._h is None:
            self._lib = None
            self._py = _PyBackend(self.path, self.rec_floats, int(capacity))

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "python"

    def push(self, recs) -> int:
        """Append (n, rec_floats) or (rec_floats,) records; returns the
        number accepted (rest dropped)."""
        arr = np.ascontiguousarray(recs, dtype=np.float64).reshape(
            -1, self.rec_floats
        )
        if self._lib is not None:
            return int(self._lib.tel_push(
                self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                len(arr),
            ))
        return self._py.push(arr)

    def flush(self):
        """Block until everything accepted so far is on disk."""
        if self._lib is not None:
            self._lib.tel_flush(self._h)
        else:
            self._py.flush()

    def stats(self) -> Tuple[int, int]:
        """(records written to disk or in flight, records dropped)."""
        if self._lib is not None:
            w = ctypes.c_long(0)
            d = ctypes.c_long(0)
            self._lib.tel_stats(self._h, ctypes.byref(w), ctypes.byref(d))
            return w.value, d.value
        return self._py.stats()

    def close(self):
        if self._lib is not None:
            if self._h is not None:
                self._lib.tel_close(self._h)
                self._h = None
        elif self._py is not None:
            self._py.close()
            self._py = None
        self._lib = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path) -> np.ndarray:
    """Read a telemetry log back as a (n, rec_floats) float64 array."""
    with open(path, "rb") as f:
        head = f.read(16)
        if len(head) < 16 or head[:8] != _MAGIC:
            raise ValueError(f"not a telemetry log: {path}")
        version, rec_floats = struct.unpack("<II", head[8:16])
        if version != _VERSION:
            raise ValueError(f"unsupported telemetry version {version}")
        data = np.fromfile(f, dtype="<f8")
    n = len(data) // rec_floats
    return data[: n * rec_floats].reshape(n, rec_floats)


# ---------------------------------------------------------------------------
# MPC flight-log schema: one record per committed node.
#   [window, k, state(13), control(7), progress, cost, violation] -> 25
# ---------------------------------------------------------------------------

FLIGHT_REC_FLOATS = 25


def flight_records(window: int, states: np.ndarray, controls: np.ndarray,
                   progress, cost: float, violation: float) -> np.ndarray:
    """Pack one committed MPC window into flight-log records.

    ``states`` (c, 13), ``controls`` (c, 7), ``progress`` scalar or (c,).
    """
    c = len(controls)
    out = np.empty((c, FLIGHT_REC_FLOATS), dtype=np.float64)
    out[:, 0] = float(window)
    out[:, 1] = np.arange(c)
    out[:, 2:15] = states[:c]
    out[:, 15:22] = controls
    out[:, 22] = progress
    out[:, 23] = float(cost)
    out[:, 24] = float(violation)
    return out


def flight_log_to_trajectory(path):
    """Load a flight log into a ``utils.TrajectoryData``."""
    from aircraft_tpu_torch.utils import TrajectoryData

    arr = read_log(path)
    if arr.shape[1] != FLIGHT_REC_FLOATS:
        raise ValueError(
            f"expected {FLIGHT_REC_FLOATS} floats/record, got {arr.shape[1]}"
        )
    return TrajectoryData(
        state=arr[:, 2:15].astype(np.float32),
        control=arr[:, 15:22].astype(np.float32),
        lam=arr[:, 22].astype(np.float32),
    )
