"""The port's ablation harness against the JAX package's:

* ``run_case`` on the default model with the quaternion strategies and
  integrators the port added (RK4 renormalised, the exponential map,
  implicit Euler) at N=8, 1 AL round x 3 inner iterations, from the
  reference's own trim (the port draws its trim cloud from a
  ``torch.Generator``, the reference from ``jax.random``: the JAX trim is
  handed to the port's ``multistart_trim``).  Held at the population
  level of the port's solves: cost within 5% and violation within
  0.3 (1 + v); the same row keys and the same feasibility verdict (the
  exponential map in tier-1, the other two ``slow``);
* ``run_time_mode_case`` at the reference test's tiny size: the
  reference's row keys and a finite objective (the reference's own row,
  ~3 min of XLA compile, is ``slow``);
* ``--merge`` of two partials the test writes, and ``--out``: the only
  place the harness writes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from aircraft_tpu import ablation as jabl
from aircraft_tpu.config import SolverConfig as JaxSolverConfig
from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.solvers.trim import multistart_trim as jax_trim

from aircraft_tpu_torch import ablation
from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.solvers.trim import TrimResult

TINY = dict(max_al_iters=1, max_inner_iters=3, line_search_steps=4)
N, DT = 8, 0.05


@pytest.fixture(scope="module")
def goal():
    init = np.asarray(glider_config().waypoints.initial_state)
    return init[:3] + np.array([30.0, 5.0, 2.0])


def _jax_trim_in_port(monkeypatch):
    """Every port trim of this test returns the reference's trim of the
    same plant, drawn from jax.random.PRNGKey(0)."""
    jcfg = jax_glider_config()
    calls = []

    def trim(params, *a, n_starts, target_airspeed, generator, **kw):
        from aircraft_tpu.dynamics.aircraft import AircraftParams as JP

        jp = JP.from_config(jcfg.aircraft,
                            com_in_moments=params.com_in_moments)
        r = jax_trim(jp, jax.random.PRNGKey(0), n_starts=n_starts,
                     target_airspeed=target_airspeed)
        calls.append(generator.initial_seed())
        return TrimResult(*(torch.as_tensor(np.asarray(t)) for t in r))

    monkeypatch.setattr(ablation, "multistart_trim", trim)
    return calls


@pytest.mark.parametrize("quaternion,integration", [
    ("expmap", "explicit"),
    pytest.param("integration", "explicit", marks=pytest.mark.slow),
    pytest.param("integration", "implicit", marks=pytest.mark.slow)])
def test_run_case_matches_the_reference(monkeypatch, goal, quaternion,
                                        integration):
    """Each case costs the reference ~28 s of XLA compile (~75 s with the
    implicit step); the exponential map runs in tier-1, the others are
    ``slow`` (the implicit step is held at step level, with its Jacobian,
    in tests/test_torch_integrators.py)."""
    calls = _jax_trim_in_port(monkeypatch)
    kw = dict(model="default", quaternion=quaternion, substeps=1,
              integration=integration, num_nodes=N, dt=DT, goal=goal)
    ref, rsol = jabl.run_case(jax_glider_config(),
                              solver_config=JaxSolverConfig(**TINY), **kw)
    row, sol = ablation.run_case(glider_config(),
                                 solver_config=SolverConfig(**TINY),
                                 device="cpu", **kw)
    assert calls == [0]                    # one trim, seeded as the reference
    assert set(row) == set(ref)
    assert sol.xs.shape == np.shape(rsol.xs) == (N + 1, 13)
    assert bool(torch.isfinite(sol.xs).all())
    for k in ("model", "quaternion", "substeps", "integration", "num_nodes",
              "dt", "start", "moments", "n_scenarios", "batched"):
        assert row[k] == ref[k], k
    c, cr = row["final_objective"], ref["final_objective"]
    v, vr = row["primal_inf"], ref["primal_inf"]
    assert abs(c - cr) / (1.0 + abs(cr)) < 0.05, (c, cr)
    assert abs(v - vr) < 0.3 * (1.0 + vr), (v, vr)
    assert row["feasible"] == ref["feasible"]
    assert row["quaternion_drift"] < 1e-3


# the keys of the reference's time-axis row (aircraft_tpu/ablation.py,
# run_time_mode_case), free_time_probes included for a free-time mode
TIME_ROW_KEYS = {
    "batched", "n_scenarios", "success_rate", "final_objective",
    "primal_inf", "iterations", "grad_norm", "total_time", "solves_per_s",
    "time", "num_nodes", "waypoint_misses", "passed", "flight_time_s",
    "nominal_time_s", "time_saved_s", "wall_s", "passed_criterion",
    "al_residual_converged", "free_time_probes"}


def _time_row(package, config, solver_config, **kw):
    return package.run_time_mode_case(
        config, time_mode="progress", num_nodes=10, dt=0.1, substeps=2,
        solver_config=solver_config, **kw)


def test_time_mode_case_runs():
    """At the reference test's size (tests/test_ablation.py): the
    reference's keys and a finite objective."""
    row = _time_row(ablation, glider_config(), SolverConfig(**TINY),
                    device="cpu")
    assert row["time"] == "progress"
    assert set(row) == TIME_ROW_KEYS
    assert np.isfinite(row["final_objective"])


@pytest.mark.slow
def test_time_mode_row_keys_are_the_references():
    """The literal key set above against a row of the reference (~3 min
    of XLA compile for its tracking, racing and free-time solves)."""
    ref = _time_row(jabl, jax_glider_config(), JaxSolverConfig(**TINY))
    assert set(ref) == TIME_ROW_KEYS


def test_merge_and_out(tmp_path, monkeypatch, capsys):
    rows = {"a": [{"model": "default", "substeps": 1}],
            "b": [{"time": "fixed"}, {"time": "progress"}]}
    for tag, r in rows.items():
        (tmp_path / f"partial_{tag}.json").write_text(json.dumps(r))
    ablation.main(["--merge", "--out", str(tmp_path)])
    merged = json.loads((tmp_path / "summary.json").read_text())
    assert merged == rows["a"] + rows["b"]

    seen = {}
    monkeypatch.setattr(ablation, "run_ablation",
                        lambda **kw: seen.update(kw) or [{"model": "x"}])
    out = tmp_path / "grid"
    ablation.main(["--models", "default", "--ref-moments", "--device", "cpu",
                   "--out", str(out)])
    assert seen["models"] == ("default",) and seen["ref_moments"]
    assert seen["device"] == "cpu" and seen["out_dir"] == str(out)
    assert json.loads((out / "partial_default_refmom.json").read_text()) == [
        {"model": "x"}]
    ablation.main(["--models", "default", "--substeps", "1,5",
                   "--integrations", "implicit", "--device", "cpu",
                   "--out", str(out)])
    assert seen["substeps_grid"] == (1, 5)
    assert seen["integration_modes"] == ("implicit",)
    assert sorted(p.name for p in tmp_path.rglob("*")) == sorted(
        ["partial_a.json", "partial_b.json", "summary.json", "grid",
         "partial_default_refmom.json", "partial_default_ss1-5_implicit.json"])
    capsys.readouterr()
