"""The port's time-optimal planners on the CPU, the port alone:

* the batched candidate sweep (``_uniform_candidate_sweep``, one
  ``solve_impl`` over the candidates with a per-scenario dt) equals one
  fixed-time solve per dt from the same time-warped seed: to 1e-6, and in
  fact bit for bit;
* ``solve_time_optimal``'s control flow on crafted candidates: the
  nominal appended as the last row, the gate (inside the tolerance, finite
  and a true rollout), the fastest feasible schedule chosen, and with
  none feasible the smallest worst miss;
* ``_refine_free_time``'s ladder on crafted candidates, its ``report_out``
  keys, and the lifted B0 winner when the refinement is refused;
* ``python -m aircraft_tpu_torch.examples.glider_time_probe`` on
  ``--device cpu`` at a tiny size prints the reference's keys and writes
  the record where ``--out`` says.

The crafted cases replace the solves the control flow consumes
(``solve_waypoint_racing``, ``_uniform_candidate_sweep``, the defects) so
that they cost nothing; the sweep and the probe run for real.
"""

import json

import numpy as np
import pytest
import torch

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.control import waypoints as wp
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.examples import glider_time_probe
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers import ocp as ocp_mod

N, DT, SUBSTEPS = 6, 0.1, 10
CFG = SolverConfig(max_al_iters=1, max_inner_iters=1)


@pytest.fixture(scope="module")
def course():
    cfg = glider_time_probe.short_course_config()
    return cfg, AircraftParams.from_config(cfg.aircraft, device="cpu")


@pytest.fixture(scope="module")
def nominal(course):
    cfg, params = course
    return wp.solve_waypoint_racing(params, cfg, num_nodes=N, dt=DT,
                                    substeps=SUBSTEPS, warm_start=False,
                                    solver_config=CFG, device="cpu")


def test_candidate_sweep_equals_one_solve_per_dt(course, nominal):
    cfg, params = course
    dts = np.asarray([0.07, 0.1, 0.12], np.float32)
    sweep = wp._uniform_candidate_sweep(params, cfg, nominal, DT, dts,
                                        num_nodes=N, substeps=SUBSTEPS,
                                        solver_config=CFG)
    for i, dt in enumerate(dts):
        z0, _ = wp.initial_guess(cfg, N, dt=float(dt), device="cpu")
        xs = nominal.xs.clone()
        scale = torch.tensor(DT, dtype=torch.float32) / torch.tensor(dt)
        xs[:, 3:6] *= scale
        xs[:, 10:13] *= scale
        ocp = wp.build_waypoint_ocp(params, cfg, dt=float(dt), num_nodes=N,
                                    substeps=SUBSTEPS)
        one = ilqr.solve_impl(ocp, z0[None], nominal.us[None], CFG,
                              xs_init=xs[None])
        for a, b in zip(sweep[:-1], one[:-1]):
            np.testing.assert_allclose(a[i].numpy(), b[0].numpy(),
                                       rtol=1e-6, atol=1e-6)
            assert torch.equal(a[i].nan_to_num(), b[0].nan_to_num())


def _crafted(course, nominal, misses, defects):
    """Candidate solutions whose trajectories pass the first waypoint at
    knot 1 and the second at knot 3, each at the given miss (m), and stay
    far from both elsewhere; with the given defects."""
    cfg, _ = course
    wps = torch.as_tensor(cfg.waypoints.array(), dtype=torch.float32)
    C = len(misses)
    xs = nominal.xs[None].repeat(C, 1, 1).clone()
    xs[:, :, :3] = 1e4
    for i, m in enumerate(misses):
        xs[i, 1, :3] = wps[0] + torch.tensor([0.0, m, 0.0])
        xs[i, 3, :3] = wps[1] + torch.tensor([0.0, 0.0, m])
    sol = ilqr.ILQRSolution(
        xs=xs, us=nominal.us[None].repeat(C, 1, 1),
        cost=torch.arange(C, dtype=torch.float32),
        violation=torch.zeros(C), converged=torch.ones(C, dtype=torch.bool),
        iterations=torch.ones(C, dtype=torch.int64),
        grad_norm=torch.zeros(C),
        al=ocp_mod.ALState(*(getattr(nominal.al, f)[None].repeat(
            (C,) + (1,) * getattr(nominal.al, f).ndim)
            for f in ocp_mod._AL_FIELDS)))
    return sol, np.asarray(defects, np.float64)


@pytest.mark.parametrize("case", ["fastest-feasible", "none-feasible"])
def test_time_optimal_gates_and_appends_the_nominal(course, nominal,
                                                    monkeypatch, case):
    cfg, params = course
    C = 3                               # candidates; the nominal is row 3
    if case == "fastest-feasible":
        # 0: misses by 30 m; 1: defect-gated; 2: feasible; nominal feasible
        misses, defects = [30.0, 1.0, 2.0, 3.0], [0.0, 0.5, 0.0, 0.0]
    else:
        misses, defects = [30.0, 20.0, 12.0, 15.0], [0.0] * 4
    crafted, crafted_defects = _crafted(course, nominal, misses, defects)
    calls = []

    def racing(*a, **k):
        calls.append("racing")
        return ilqr.take(crafted, -1)

    def sweep(params_, config_, sol_nominal, dt_nominal, dts, **k):
        calls.append(("sweep", len(dts), k["cuda_chol"]))
        return ilqr.ILQRSolution(*(t[:C] for t in crafted[:-1]),
                                 al=ocp_mod.ALState(*(
                                     getattr(crafted.al, f)[:C]
                                     for f in ocp_mod._AL_FIELDS)))

    monkeypatch.setattr(wp, "solve_waypoint_racing", racing)
    monkeypatch.setattr(wp, "_uniform_candidate_sweep", sweep)
    monkeypatch.setattr(wp, "_batched_defects",
                        lambda *a, **k: crafted_defects)
    res = wp.solve_time_optimal(params, cfg, num_nodes=N, dt_nominal=DT,
                                substeps=SUBSTEPS, n_candidates=C,
                                dt_span=(0.6, 0.9), solver_config=CFG,
                                cuda_chol=True, device="cpu")
    assert calls == ["racing", ("sweep", C, True)]
    assert set(res) == {"solution", "dt", "total_time", "feasible", "dmins",
                        "candidate_times", "candidate_dts", "defects"}
    assert res["candidate_dts"].shape == res["candidate_times"].shape == (
        C + 1,)
    assert res["candidate_dts"][-1] == pytest.approx(DT)   # the nominal
    assert res["dmins"].shape == (C + 1, 2)
    np.testing.assert_allclose(res["dmins"].max(axis=1), misses, rtol=1e-4)
    if case == "fastest-feasible":
        assert res["feasible"].tolist() == [False, False, True, True]
        best = 2
    else:
        assert not res["feasible"].any()
        best = int(np.argmin(misses))
    assert res["dt"] == pytest.approx(float(res["candidate_dts"][best]))
    assert res["total_time"] == pytest.approx(res["dt"] * N, rel=1e-6)
    assert float(res["solution"].cost) == best
    assert res["solution"].xs.shape == (N + 1, 15)


def test_refine_free_time_reports_the_ladder(course, nominal, monkeypatch):
    cfg, params = course
    # ladder scales 0.70 0.78 0.86 0.93 1.0: 0.78 is the fastest feasible
    misses, defects = [40.0, 2.0, 3.0, 1.0, 1.0], [0.0] * 5
    crafted, crafted_defects = _crafted(course, nominal, misses, defects)
    monkeypatch.setattr(wp, "_uniform_candidate_sweep",
                        lambda *a, **k: crafted)
    monkeypatch.setattr(wp, "_batched_defects",
                        lambda *a, **k: crafted_defects)
    report = {}
    sol = wp._refine_free_time(params, cfg, nominal, num_nodes=N, dt=DT,
                               substeps=SUBSTEPS, time_mode="variable",
                               dt_bounds=(0.01, 0.4), solver_config=CFG,
                               report_out=report, device="cpu")
    assert set(report) == {"b0_ladder", "b0_winner_scale", "b1"}
    assert [r["scale"] for r in report["b0_ladder"]] == [0.7, 0.78, 0.86,
                                                          0.93, 1.0]
    assert [r["feasible"] for r in report["b0_ladder"]] == [
        False, True, True, True, True]
    assert set(report["b0_ladder"][0]) == {
        "scale", "dt", "total_time_s", "max_waypoint_miss_m",
        "rollout_defect", "finite", "feasible"}
    assert report["b0_winner_scale"] == 0.78
    assert set(report["b1"]) == {
        "mode", "trust_region_dt", "refined_total_time_s",
        "refined_max_miss_m", "incumbent_total_time_s",
        "incumbent_max_miss_m", "finite", "accepted"}
    assert report["b1"]["trust_region_dt"] == [0.039, 0.156]
    assert sol.us.shape == (N, 10)              # ν joined the controls
    if not report["b1"]["accepted"]:
        # the B0 winner lifted into the free-time variables
        assert sol.al is None
        assert torch.equal(sol.xs, crafted.xs[1])
        np.testing.assert_allclose(sol.us[:, -1].numpy(), np.sqrt(0.078),
                                   rtol=1e-6)


def test_probe_entry_prints_the_reference_keys(capsys, tmp_path):
    out = tmp_path / "probe.json"
    glider_time_probe.main(["--device", "cpu", "--num-nodes", "4",
                            "--substeps", "2", "--candidates", "2",
                            "--al-iters", "1", "--inner-iters", "1",
                            "--cuda-chol", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    record = json.loads(out.read_text())
    assert set(line) | {"ladder"} == set(record)
    assert {"metric", "value", "unit", "course", "num_nodes", "dt_nominal",
            "substeps", "tolerance_m", "selected_total_time_s",
            "nominal_total_time_s", "n_subnominal_feasible", "sweep_wall_s",
            "solver", "ladder", "device"} <= set(record)
    assert record["device"] == "cpu" and record["num_nodes"] == 4
    assert len(record["ladder"]) == 3            # 2 candidates + nominal
    assert {"scale", "dt", "total_time_s", "max_waypoint_miss_m",
            "rollout_defect", "feasible",
            "failure_mode"} == set(record["ladder"][0])
