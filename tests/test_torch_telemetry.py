"""The port's async flight telemetry (``native/telemetry.py`` over its own
copy of ``telemetry.cpp``) and the serving bench modes that push to it.

* The same flight records written by the port's native and Python
  backends and by the JAX package's recorder (its Python backend, which
  writes the format its native one does) give byte-identical files, and
  the JAX package's ``read_log`` reads the port's file.
* A burst past the ring's capacity returns at once with the overflow
  dropped and counted (drop-not-block), on both backends.
* ``python -m aircraft_tpu_torch.bench --mode latency|serve`` on the CPU
  at a tiny horizon prints the reference mode's keys.
"""

import json
import time

import numpy as np
import pytest

from aircraft_tpu.native import telemetry as jax_tel

from aircraft_tpu_torch import bench
from aircraft_tpu_torch.native import telemetry as tel

BACKENDS = ["native", "python"]


def _flight(windows=3, c=20, seed=0):
    """Records of `windows` committed windows of c knots each."""
    rng = np.random.default_rng(seed)
    return np.concatenate([tel.flight_records(
        w, rng.standard_normal((c, 13)), rng.standard_normal((c, 7)),
        np.linspace(0.1 * w, 0.1 * w + 0.05, c), 100.0 + w, 1e-3 * w)
        for w in range(windows)])


def _write(recorder_cls, path, recs, **kw):
    with recorder_cls(path, tel.FLIGHT_REC_FLOATS, capacity=1 << 12,
                      **kw) as r:
        backend = r.backend
        for w in range(0, len(recs), 20):
            assert r.push(recs[w:w + 20]) == len(recs[w:w + 20])
        r.flush()
        assert r.stats() == (len(recs), 0)
    return backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_files_match_the_reference_byte_for_byte(tmp_path, backend):
    recs = _flight()
    ours, ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    assert _write(tel.TelemetryRecorder, ours, recs,
                  force_python=backend == "python") == backend
    # the reference's Python backend: its native one would build with g++
    # into the JAX package's source tree, racing other test processes
    _write(jax_tel.TelemetryRecorder, ref, recs, force_python=True)
    assert ours.read_bytes() == ref.read_bytes()
    # the reference reads the port's log, the port the reference's
    np.testing.assert_array_equal(jax_tel.read_log(ours), recs)
    np.testing.assert_array_equal(tel.read_log(ref), recs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_overflow_drops_and_never_blocks(tmp_path, backend):
    """A ring of 8 records and a burst of 64: the push returns at once
    with 8 accepted and 56 dropped."""
    path = tmp_path / "drop.bin"
    with tel.TelemetryRecorder(path, 2, capacity=8,
                               force_python=backend == "python") as r:
        assert r.backend == backend
        t0 = time.perf_counter()
        accepted = r.push(np.ones((64, 2)))
        assert time.perf_counter() - t0 < 0.5
        assert accepted == 8
        r.flush()
        assert r.stats() == (8, 56)
    assert len(tel.read_log(path)) == 8


def test_flight_log_loads_as_a_trajectory(tmp_path):
    recs = _flight(windows=2, c=5)
    path = tmp_path / "flight.bin"
    _write(tel.TelemetryRecorder, path, recs)
    traj = tel.flight_log_to_trajectory(path)
    np.testing.assert_array_equal(traj.state, recs[:, 2:15].astype(np.float32))
    np.testing.assert_array_equal(traj.control,
                                  recs[:, 15:22].astype(np.float32))
    np.testing.assert_array_equal(traj.lam, recs[:, 22].astype(np.float32))


# the reference modes' output keys (bench.py:303-317, :895-929)
LATENCY_KEYS = {"metric", "value", "unit", "vs_baseline", "p90_ms", "reps",
                "fused_kernels", "al_iters", "inner_iters", "compile_wall_s",
                "cost", "violation", "device"}
SERVE_KEYS = {"metric", "value", "unit", "vs_baseline", "windows",
              "pipelined", "deadline_ms", "p50_ms", "p99_ms", "max_ms",
              "telemetry_backend", "telemetry_records", "telemetry_dropped",
              "fused_kernels", "compile_wall_s",
              "compile_cache_entries_at_start", "initial_progress",
              "final_progress", "progress_per_window", "resets", "reset_viol",
              "violation_units", "mean_violation", "p90_violation", "device"}
SYNC_KEYS = {"solve_p50_ms", "commit_copy_p50_ms", "telemetry_push_p50_us"}


@pytest.mark.parametrize("mode", ["latency", "serve", "serve-sync"])
def test_serving_modes_print_the_reference_keys(capsys, mode):
    """Tiny runs on the CPU (horizon 4, 1 x 1 budget, 3 step sizes; the
    window kernels' plain versions)."""
    argv = ["--device", "cpu", "--horizon", "4", "--al-iters", "1",
            "--inner-iters", "1", "--line-search", "3"]
    if mode == "latency":
        argv += ["--mode", "latency", "--reps", "2"]
        keys, metric = LATENCY_KEYS, "replan_latency_p50_ms_b1_N50"
    else:
        argv += ["--mode", "serve", "--windows", "2"]
        keys, metric = SERVE_KEYS, "serve_cadence_miss_rate_N50"
        if mode == "serve-sync":
            argv.append("--no-pipeline")
            keys, metric = SERVE_KEYS | SYNC_KEYS, "serve_deadline_miss_rate_N50"
    bench.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert keys <= set(out), sorted(keys - set(out))
    assert out["metric"] == metric
    assert out["device"] == "cpu" and out["matmul_precision"] == "highest"
    assert out["kernel_launches"]["window_backward"] == 0
    if mode == "latency":
        assert out["reps"] == 2 and np.isfinite(out["cost"])
    else:
        assert out["windows"] == 2 and out["pipelined"] == (mode == "serve")
        # horizon 4 commits 2 knots per window
        assert out["telemetry_records"] == 4
        assert out["telemetry_dropped"] == 0
        assert out["telemetry_backend"] == "native"
