"""The port's fleet-scale bench modes and ``examples/batched_mpc.py`` on
the CPU, at tiny shapes.

* ``--mode phase``, ``warm``, ``roofline``, ``oppoints`` and ``scaling``
  each end in one JSON line with the reference bench's fields for that
  mode (listed below from ``bench.py``; the roofline mode's ``counted_*``
  fields take the place of its ``xla_*`` ones, which read XLA's cost
  model); the scaling mode runs its ranks as gloo processes, and a
  rank that raises fails it.
* ``examples/batched_mpc.py`` unsharded and with ``--mesh --ranks 2``
  prints the reference's two lines.
* The counts moved into ``aircraft_tpu_torch/roofline.py`` give the bound
  column of PERF.md's kernel table.
* The oppoints mode's point parsing and its best-point rule.

The plant's best glide (its trim solves, ~10 s on the CPU) is found once
for the file and handed to every mode with ``--glide``.
"""

import json
import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from aircraft_tpu_torch import bench, roofline
from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import load_mlp
from aircraft_tpu_torch.examples import batched_mpc
from aircraft_tpu_torch.kernels import rollout as rollout_mod
from aircraft_tpu_torch.kernels import window as win

TINY = ["--device", "cpu", "--batch", "2", "--horizon", "4", "--al-iters",
        "1", "--inner-iters", "1", "--line-search", "3"]

# the reference's JSON keys of each mode (bench.py:604-621, :668-686,
# :983-1019, :1190-1204, :1290-1310 and its scaling rows :1350-1359)
PIECES = ("rollout", "linearize", "quadraticize", "backward",
          "forward_12alpha")
MODE_FIELDS = {
    "phase": ("metric", "value", "unit", "vs_baseline", "batch", "horizon",
              "use_residuals", "device", "linearize_fused_s")
    + tuple(f"{p}_s" for p in PIECES) + tuple(f"{p}_frac" for p in PIECES),
    "warm": ("metric", "value", "unit", "vs_baseline", "batch",
             "warm_wall_s_per_window", "cold_wall_s", "windows_timed",
             "finite_fraction", "mean_violation", "device"),
    "roofline": ("metric", "unit", "batch", "wall_s",
                 "counted_flops_per_batch", "counted_bytes_per_batch",
                 "achieved_gflops", "achieved_hbm_gbs",
                 "arithmetic_intensity_flops_per_byte", "device", "value",
                 "vs_baseline", "bound"),
    "oppoints": ("metric", "value", "unit", "vs_baseline", "gate",
                 "best_point", "points"),
    "scaling": ("metric", "value", "unit", "vs_baseline", "per_device_batch",
                "host_physical_cores", "note", "curve", "rows"),
}
OPPOINT_ROW = ("point", "al", "inner", "rowpen", "solves_per_s",
               "mean_violation", "median_violation", "p90_violation",
               "converged_fraction_1e2", "converged_fraction_1e4",
               "diverged_fraction", "mean_cost", "violation_units", "batch",
               "device", "subprocess_wall_s")
SCALING_ROW = ("devices", "mode", "total_batch", "wall_s", "solves_per_s",
               "mean_cost", "max_violation", "n_converged")


@pytest.fixture(scope="module")
def glide():
    """The plant's (v_ref, glide_ld), found once for every case."""
    return bench.plant_best_glide(AircraftParams.from_config(
        glider_config().aircraft, coeff=load_mlp(device="cpu"),
        device="cpu"))


def _glide_arg(glide):
    return ["--glide", ",".join(repr(float(g)) for g in glide)]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,args", [
    ("phase", ["--reps", "1", "--cuda-chol"]),
    ("warm", ["--windows", "1", "--cuda-chol"]),
    ("roofline", ["--reps", "1"])])
def test_single_device_modes_print_the_reference_fields(capsys, glide,
                                                        mode, args):
    bench.main(TINY + ["--mode", mode] + args + _glide_arg(glide))
    line = _last_json(capsys)
    missing = set(MODE_FIELDS[mode]) - set(line)
    assert not missing, sorted(missing)
    assert line["device"] == "cpu" and line["batch"] == 2
    # on the CPU no kernel is launched: the plain versions run
    assert not any(v for v in line["kernel_launches"].values())
    if mode == "phase":
        assert all(line[f"{p}_s"] > 0 for p in PIECES)
        assert abs(sum(line[f"{p}_frac"] for p in PIECES) - 1.0) < 0.01
    elif mode == "warm":
        assert line["finite_fraction"] == 1.0
        assert line["backward_passes"] == 2
    else:
        assert line["bound"] == "unknown device" and line["value"] == 0.0
        assert "terminal expansion per inner iteration" in line["uncounted"]
        assert line["counted_flops_per_batch"] > 0


def test_oppoints_mode_runs_each_point_as_a_headline_chain(capsys, glide,
                                                           tmp_path):
    out = tmp_path / "operating_points.json"
    bench.main(TINY[:6] + ["--mode", "oppoints", "--points", "1x1",
                           "--line-search", "3", "--warmup", "0", "--reps",
                           "1", "--out", str(out)] + _glide_arg(glide))
    line = _last_json(capsys)
    assert set(MODE_FIELDS["oppoints"]) <= set(line)
    (row,) = line["points"]
    assert "error" not in row, row["error"]
    assert set(OPPOINT_ROW) <= set(row)
    assert (row["al"], row["inner"], row["rowpen"]) == (1, 1, False)
    assert json.loads(out.read_text())["points"] == line["points"]


def test_scaling_mode_runs_gloo_ranks(capsys, glide, tmp_path):
    out = tmp_path / "scaling.json"
    bench.main(TINY[:4] + ["--mode", "scaling", "--devices", "1,2",
                           "--per-device", "1", "--horizon", "4",
                           "--al-iters", "1", "--inner-iters", "1",
                           "--line-search", "3", "--reps", "1", "--out",
                           str(out)] + _glide_arg(glide))
    line = _last_json(capsys)
    assert set(MODE_FIELDS["scaling"]) <= set(line)
    assert line["metric"] == "sharded_solve_topology_efficiency_2dev_cpu"
    assert [(r["devices"], r["mode"]) for r in line["rows"]] == [
        (1, "sharded"), (2, "sharded"), (2, "single")]
    for row in line["rows"]:
        assert set(SCALING_ROW) <= set(row), row
    assert line["rows"][1]["ranks"] == 2
    assert line["rows"][1]["mean_cost"] == line["rows"][2]["mean_cost"]
    assert set(line["curve"]["2dev"]) >= {
        "topology_efficiency", "weak_scaling_efficiency_raw"}
    assert line["skipped"] == [] and out.exists()


def test_scaling_mode_fails_with_a_failing_rank(glide, tmp_path):
    """A rank that raises fails the whole call: no error row is made."""
    import torch_parallel_ranks

    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 0 fails"):
        bench.bench_scaling("cpu", devices=(1,), per_device=1, horizon=4,
                            al_iters=1, inner_iters=1, ls=3, reps=1,
                            glide=glide, rank=torch_parallel_ranks.failing,
                            out_path=tmp_path / "scaling.json")
    assert not (tmp_path / "scaling.json").exists()


@pytest.mark.parametrize("mesh", [[], ["--mesh", "--ranks", "2"]],
                         ids=["unsharded", "mesh"])
def test_batched_mpc_prints_the_reference_lines(capsys, mesh):
    batched_mpc.main(["--device", "cpu", "--batch", "2", "--windows", "1",
                      "--al-iters", "1", "--inner-iters", "1"] + mesh)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"fleet of 2: 1 replan rounds, 2 window solves in "
                        r"[\d.]+s \(\d+ solves/s incl\. compile\)", lines[-2])
    assert re.fullmatch(r"median progress [\d.]+, success rate [\d.]+",
                        lines[-1])
    if mesh:
        assert lines[0] == "sharding batch 2 over 2 cpu ranks"


def _rounds_to(x, printed: str):
    """x printed to the digits of PERF.md's ``printed``."""
    digits = len(printed.split(".")[1].lstrip("0"))
    assert float(f"{x:.{digits}g}") == float(printed), (x, printed)


def test_moved_counts_give_perf_bound_column(glide):
    """K1 and K2 at the fleet (B=256, N=50, 6 step sizes), K5 at its three
    batches, K3/K4 at the kernel mode's (B=1024, N=50, 10 substeps)."""
    _, _, _, _, _, spec = bench.build_problem("cpu", glide=glide)
    op = win.make_window_operands(spec, bench.N_HORIZON,
                                  alphas=win.line_search_alphas(6),
                                  device="cpu")
    _rounds_to(roofline.bound_ms(roofline.backward_work(op, 256))[0], "0.0713")
    _rounds_to(roofline.bound_ms(roofline.forward_work(op, 256))[0],
               "0.00884")
    for (b, m, k), want in (((256, 7, 15), "0.0000792"),
                            ((12800, 7, 15), "0.003958"),
                            ((12800, 7, 8), "0.002461")):
        ms, by = roofline.bound_ms(roofline.cholesky_work(b, m, k))
        _rounds_to(ms, want)
        assert by == "bytes"
    params = AircraftParams.from_config(glider_config().aircraft,
                                        coeff=load_mlp(device="cpu"),
                                        device="cpu")
    rop = rollout_mod.make_rollout_operands(params, horizon=50, dt=bench.DT,
                                            substeps=10)
    _rounds_to(roofline.bound_ms(roofline.rollout_work(
        1024, 50, 10, rop.mlp.numel()))[0], "0.0548")
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (
        roofline.FP32_PEAK, roofline.HBM_BYTES_PER_S)
    assert roofline.peaks("cpu") is None


def test_oppoints_parsing_and_best_point_rule():
    assert [bench.parse_point(s) for s in bench.OPPOINTS.split(",")] == [
        (2, 6, False), (2, 10, False), (3, 8, False), (3, 12, True),
        (3, 16, True), (4, 20, True)]
    with pytest.raises(ValueError):
        bench.parse_point("3by12")
    rows = [{"point": "a", "solves_per_s": 900.0,
             "converged_fraction_1e2": 0.9},
            {"point": "b", "solves_per_s": 500.0,
             "converged_fraction_1e2": 0.95},
            {"point": "c", "solves_per_s": 700.0,
             "converged_fraction_1e2": 0.99},
            {"point": "d", "error": "timeout"}]
    assert bench.best_point(rows)["point"] == "c"
    assert bench.best_point(rows[:1] + rows[3:]) is None
