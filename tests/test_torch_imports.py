"""The port stands alone: every module of aircraft_tpu_torch imports with
JAX made unimportable, no file of it imports jax, flax, optax or the JAX
package, and its entry points refuse a missing card instead of falling
back to the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "aircraft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aircraft_tpu")


def _modules():
    import aircraft_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        aircraft_tpu_torch.__path__, prefix="aircraft_tpu_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter whose `jax`, `flax` and `optax` are poisoned
    (this process keeps its JAX: other test files share it)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, kernel_times, warm_fallbacks\n"
        "bad = sorted(m for m in sys.modules if m == 'aircraft_tpu' or"
        " m.startswith('aircraft_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


NEW_ENTRY_MODULES = (
    "aircraft_tpu_torch.entry", "aircraft_tpu_torch.parallel.tensor",
    "aircraft_tpu_torch.plotting", "aircraft_tpu_torch.plotting.plotting",
    "aircraft_tpu_torch.examples.full_course",
    "aircraft_tpu_torch.examples.openloop_sim",
    "aircraft_tpu_torch.examples.waypoint_racing")


def test_entry_module_plotting_and_examples_import_alone():
    """The entry module, the tensor-parallel step, plotting and the last
    three examples import with JAX, matplotlib and h5py all poisoned:
    the drawing and the HDF5 files import theirs only when used."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'matplotlib', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {NEW_ENTRY_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'aircraft_tpu' or"
        " m.startswith('aircraft_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for name in NEW_ENTRY_MODULES:
        rel = Path(*name.split(".")).with_suffix(".py")
        path = ROOT / rel if (ROOT / rel).exists() else ROOT / rel.with_suffix(
            "") / "__init__.py"
        assert not set(_imported_roots(path)) & set(FORBIDDEN), path


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "kernel_times.py", "warm_fallbacks.py"])
def test_no_forbidden_imports(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"window_physics.cuh", "window_backward.cu", "window_forward.cu",
            "batched_cholesky.cu", "fused_rollout.cu"} <= names
    from aircraft_tpu_torch.kernels import _build

    assert {f"{n}.cu" for n in _build.SOURCES} <= names


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from aircraft_tpu_torch import ablation, bench, device
    from aircraft_tpu_torch.dynamics import coefficients as co
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control import aircraft as ac
    from aircraft_tpu_torch.control import waypoints as wp
    from aircraft_tpu_torch.control.course import solve_full_course
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch import parallel
    from aircraft_tpu_torch.examples import batched_mpc, glider_time_probe
    from aircraft_tpu_torch.control.mhtt import MHTT
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.solvers import lqr, ocp, trim
    from aircraft_tpu_torch.control import inverse_dynamics, mhe, pid
    from aircraft_tpu_torch.control import quadrotor as quad
    from aircraft_tpu_torch.dynamics import frames
    from aircraft_tpu_torch.dynamics.quadrotor import QuadrotorParams
    from aircraft_tpu_torch.examples import (closed_loop_mhe,
                                             stability_analysis,
                                             time_optimal_quad)
    from aircraft_tpu_torch.examples import fit_surrogates, train_ddpg
    from aircraft_tpu_torch import entry, observability
    from aircraft_tpu_torch.examples import (full_course, openloop_sim,
                                             waypoint_racing)
    from aircraft_tpu_torch.plotting import TrajectoryPlotter
    from aircraft_tpu_torch.rl import ddpg
    from aircraft_tpu_torch.solvers.reference_nlp import solve_reference_nlp
    from aircraft_tpu_torch.surrogates import extras, models

    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device="cpu")
    x0 = torch.tensor(cfg.waypoints.initial_state, dtype=torch.float32)
    u0 = torch.zeros(7)
    track = DubinsInitialiser(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box = ([-1.0] * 7, [1.0] * 7)
    xa, ya = np.ones((8, 5), np.float32), np.ones((8, 6), np.float32)
    layers = [(np.ones((2, 3)), np.zeros(3))]
    for call in (lambda: device.resolve_device(),
                 lambda: load_mlp(),
                 lambda: bench.build_problem(),
                 lambda: bench.bench_kernel(),
                 lambda: bench.bench_chol(),
                 lambda: bench.bench_riccati(),
                 lambda: bench.bench_latency(),
                 lambda: bench.bench_serve(),
                 lambda: MHTT(params, cfg, track),
                 lambda: solve_full_course(cfg),
                 lambda: ocp.make_squash_maps(*box),
                 lambda: ocp.squash_controls(ocp.OCPFunctions(
                     step=None, stage_cost=None, terminal_cost=None), *box),
                 lambda: trim.start_cloud(4, torch.Generator()),
                 lambda: bench.bench_whole(),
                 lambda: ac.goal_cost([0.0, 0.0, 0.0]),
                 lambda: wp.initial_guess(cfg, 4),
                 lambda: wp.tracking_warm_start(params, cfg, num_nodes=4,
                                                dt=0.1),
                 lambda: wp.receding_warm_start(params, cfg, num_nodes=4,
                                                dt=0.1),
                 lambda: wp.solve_waypoint_racing(params, cfg),
                 lambda: wp.solve_time_optimal(params, cfg),
                 lambda: wp.solve_waypoint_legs(params, cfg),
                 lambda: glider_time_probe.run_probe_ladder(),
                 lambda: ablation.run_ablation(models=("default",)),
                 lambda: ablation.run_time_mode_case(cfg, time_mode="fixed"),
                 lambda: ablation.main(["--quick"]),
                 lambda: co.default_artifact_coeff("poly"),
                 lambda: co.load_coefficient_model(
                     "linear", co.NETWORKPATH / "linearised.csv"),
                 lambda: co.MLPCoeffParams.init(torch.Generator()),
                 lambda: co.default_nn_coeff(),
                 lambda: bench.bench_phase(),
                 lambda: bench.bench_warm(),
                 lambda: bench.bench_roofline(),
                 lambda: bench.bench_oppoints(),
                 lambda: bench.bench_scaling(),
                 lambda: parallel.make_mesh(),
                 lambda: parallel.make_seq_mesh(),
                 lambda: parallel.spawn(print, 1),
                 lambda: batched_mpc.run_fleet(),
                 lambda: batched_mpc.main([]),
                 lambda: batched_mpc.main(["--mesh"]),
                 lambda: frames.EarthRotationParams.at_latitude(45.0),
                 lambda: QuadrotorParams.default(),
                 lambda: quad.initial_state_inverted(),
                 lambda: quad.build_quadrotor_ocp([1.0, 0.0, 0.0], dt=0.1),
                 lambda: quad.build_quadrotor_ocp_dynamic(dt=0.1),
                 lambda: quad.build_quadrotor_ocp_variable_time(
                     [1.0, 0.0, 0.0], dt_bounds=(0.01, 0.1)),
                 lambda: quad.solve_quadrotor_control([1.0, 0.0, 0.0]),
                 lambda: quad.solve_quadrotor_time_optimal([1.0, 0.0, 0.0]),
                 lambda: inverse_dynamics.solve_inverse_dynamics(
                     params, cfg, [10.0, 0.0, -200.0]),
                 lambda: lqr.design(params, x0, u0, 0.01),
                 lambda: trim.discrete_stability_analysis(params, x0, u0),
                 lambda: mhe.estimate_wind(params, x0.expand(3, 13),
                                           u0.expand(2, 7), 0.02),
                 lambda: pid.pid_init(),
                 lambda: pid.attitude_pid_init(),
                 lambda: pid.simulate_pid(params, x0, [0.0], [0.0], 0.02),
                 lambda: time_optimal_quad.run(),
                 lambda: time_optimal_quad.main([]),
                 lambda: stability_analysis.run(),
                 lambda: stability_analysis.main([]),
                 lambda: closed_loop_mhe.run(),
                 lambda: closed_loop_mhe.main([]),
                 lambda: solve_reference_nlp(None, [0.0], [[0.0]]),
                 lambda: models.fit_linear(xa, ya),
                 lambda: models.fit_polynomial(xa, ya),
                 lambda: models.train_mlp(xa, ya),
                 lambda: extras.BatchNormMLP.init(torch.Generator(), (2, 3)),
                 lambda: extras.batchnorm_mlp_from_numpy({}),
                 lambda: extras.train_batchnorm_mlp(xa, ya),
                 lambda: extras.gp_params_from_numpy({}),
                 lambda: extras.GPSurrogate.fit(xa, ya[:, 0]),
                 lambda: ddpg.MLPParams.init(torch.Generator(), (2, 3)),
                 lambda: ddpg.mlp_params_from_numpy(layers),
                 lambda: ddpg.ddpg_params_from_numpy(layers, layers),
                 lambda: ddpg.ReplayBuffer(4, 13, 3),
                 lambda: ddpg.DDPGAgent(13, 3),
                 lambda: fit_surrogates.run("aero.csv"),
                 lambda: fit_surrogates.main(["--data", "aero.csv"]),
                 lambda: train_ddpg.run(1, 1),
                 lambda: train_ddpg.main([]),
                 lambda: entry.entry(),
                 lambda: entry.dryrun_multichip(1),
                 lambda: entry.main([]),
                 lambda: openloop_sim.run(),
                 lambda: openloop_sim.main([]),
                 lambda: waypoint_racing.run(),
                 lambda: waypoint_racing.main([]),
                 lambda: full_course.run(),
                 lambda: full_course.main([]),
                 lambda: TrajectoryPlotter(),
                 lambda: observability.check_jacobian(np.sin, np.zeros(2)),
                 lambda: observability.fd_jacobian(np.sin, np.zeros(2)),
                 lambda: observability.locate_nan_in_jacobian(
                     lambda x, u: x, np.zeros(2), np.zeros(1))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert device.resolve_device("cpu").type == "cpu"


def test_full_precision_matmuls():
    import aircraft_tpu_torch  # noqa: F401  (sets the flags)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_native_runtime_builds_into_the_build_directory(tmp_path, monkeypatch):
    """The port's g++ build of its telemetry runtime writes its library
    under the build directory it is given (by default the checkout's
    ``build/aircraft_tpu_torch/``) and nothing under ``aircraft_tpu/``."""
    from aircraft_tpu_torch import native
    from aircraft_tpu_torch.kernels import _build
    from aircraft_tpu_torch.native import telemetry

    assert native.lib_path("telemetry").parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == ROOT / "build" / "aircraft_tpu_torch"

    def tree():
        # other test processes may meanwhile compile the JAX package's
        # bytecode or build its own native libraries: those are not ours
        return {str(p): p.stat().st_mtime_ns
                for p in (ROOT / "aircraft_tpu").rglob("*")
                if "__pycache__" not in p.parts
                and p.name not in ("libtelemetry.so", "libdubins.so")}

    commands = []
    run = subprocess.run

    def spy(cmd, *a, **kw):
        commands.append(cmd)
        return run(cmd, *a, **kw)

    before = tree()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_FAILED", set())
    monkeypatch.setattr(native.subprocess, "run", spy)
    assert telemetry.native_available()
    assert len(commands) == 1
    out = Path(commands[0][commands[0].index("-o") + 1])
    assert out.parent == tmp_path / "build"
    built = list((tmp_path / "build").iterdir())
    assert [p.name for p in built] == [native.lib_path("telemetry").name]
    assert tree() == before
