"""The port on the card: its CUDA kernels against their plain versions
(``-m gpu``, skipped without a card; small batches with an odd B, not a
multiple of 32 or 128), and ``chip_smoke.py``'s refusal to report a
result where there is no card or no package.

Nothing here imports JAX, so the machine with the card, which has no JAX,
runs this file on its own:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["nn", "default"])
def test_cuda_kernels_match_plain_versions(model):
    """chip_smoke.py's small-batch check (reversed-flow lanes, N=10):
    gains and candidate costs within 1e-2, the chosen candidate replayed
    knot by knot within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import window as win

    win.reset_launch_counts()
    op, inp = chip_smoke.reversed_batch(model)
    chip_smoke.hold_kernels(op, inp, f"{model} reversed")
    assert win.window_backward.launches == win.window_forward.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["nn", "default"])
@pytest.mark.parametrize("n_alpha", [2, 16])
def test_cuda_window_kernels_at_edge_shapes(model, n_alpha):
    """B=37 (19 forward, 18 reversed-flow lanes: no multiple of the four
    knot warps per block of the backward kernel's first phase), N=7, and
    the fewest and the most line-search candidates the forward kernel
    takes (one block of 2 or 16 warps per scenario); one launch of each
    wrapper per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import window as win

    op, inp = chip_smoke.reversed_batch(model, N=7, n_fwd=19, n_rev=18,
                                        n_alpha=n_alpha)
    win.reset_launch_counts()
    chip_smoke.hold_kernels(op, inp, f"{model} B=37 N=7 A={n_alpha}")
    assert win.window_backward.launches == win.window_forward.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,k", [(37, 7, 15), (301, 7, 8), (5, 16, 1),
                                   (37, 7, 40), (3, 16, 1), (21, 16, 100)])
def test_cuda_cholesky_matches_plain_version(B, m, k):
    """Random SPD systems (A = W Wᵀ/m + 2I), within 2e-3 (1 + |ref|): B no
    multiple of the systems per block, k below, above and no multiple of
    the lane group, and (21, 16, 100) wider than one column chunk of shared
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import cholesky

    a, rhs = chip_smoke.spd_systems(B, m, k)
    cholesky.reset_launch_counts()
    chip_smoke.hold_cholesky(a, rhs, f"B={B} m={m} k={k}")
    assert cholesky.batched_cholesky_solve.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["nan", "not_pd"])
def test_cuda_cholesky_keeps_a_bad_system_to_itself(fault):
    """One system with a NaN entry, or negated (not positive definite),
    among 37: its X is non-finite, as the plain version's, and every other
    system equals the plain version within 2e-3 (1 + |ref|).  The Riccati
    sweep's whole-batch fallback relies on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import cholesky

    a, rhs = chip_smoke.spd_systems(37, 7, 15)
    bad = 20
    if fault == "nan":
        a[bad, 3, 3] = float("nan")
    else:
        a[bad] = -a[bad]
    xp = cholesky.cholesky_solve_plain(a, rhs)
    assert not bool(torch.isfinite(xp[bad]).all())
    good = torch.arange(37, device="cuda") != bad
    x = cholesky.batched_cholesky_solve(a, rhs)
    assert not bool(torch.isfinite(x[bad]).all())
    ok, err = chip_smoke.close(x[good], xp[good], chip_smoke.CHOL_TOL)
    assert ok, err


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,substeps", [(37, 5, 2), (129, 3, 10), (5, 1, 1)])
def test_cuda_rollout_matches_plain_version(B, N, substeps):
    """Every knot of the kernel's trajectory replayed through the plain
    step within 2e-4 (1 + |ref|): B no multiple of the scenarios per
    block, and one knot of one substep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import rollout

    rollout.reset_launch_counts()
    chip_smoke.hold_rollout(B, N, substeps, f"B={B} N={N} ss={substeps}")
    assert rollout.fused_rollout.launches == 1


@pytest.mark.gpu
def test_cuda_chol_sweep_launches_the_kernel_on_every_knot():
    """The kernel route on CUDA tensors launches the kernel once per knot
    and agrees with the reference route on a well-posed sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    Bz, N, n, m = 33, 6, 14, 7
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(s, device="cuda", generator=gen)
    eye = lambda d: torch.eye(d, device="cuda")
    W, Wu = r(Bz, N, n, n), r(Bz, N, m, m)
    args = (eye(n) + 0.3 * r(Bz, N, n, n), 0.3 * r(Bz, N, n, m), r(Bz, N, n),
            r(Bz, N, m), W @ W.transpose(-1, -2) / n + eye(n),
            Wu @ Wu.transpose(-1, -2) / m + eye(m), 0.1 * r(Bz, N, m, n),
            r(Bz, n), eye(n).expand(Bz, n, n), torch.full((Bz,), 1e-6,
                                                          device="cuda"))
    cholesky.reset_launch_counts()
    riccati.reset_counts()
    out = riccati.backward_sequential(*args, cuda_chol=True)
    ref = riccati.backward_sequential(*args)
    assert cholesky.batched_cholesky_solve.launches == N
    assert riccati.read_fallbacks() == 0
    for o, p in zip(out[:2], ref[:2]):
        assert float((o - p).abs().max()) <= 2e-3 * (1 + float(p.abs().max()))


@pytest.mark.gpu
def test_cuda_chol_sweep_graph_replays_the_eager_sweep_bit_for_bit():
    """The kernel-route sequential sweep's CUDA graph: on a batch where
    some knots fall back (indefinite luu), every replay gives the eager
    sweep's K, k, dv1, dv2, max |Qu| and flags bit for bit, counts the
    eager sweep's fallbacks, and adds N Cholesky launches; a strided
    input is replayed through the same graph, on its contiguous copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    Bz, N, n, m = 37, 9, 14, 7
    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(s, device="cuda", generator=gen)
    eye = lambda d: torch.eye(d, device="cuda")
    W = r(Bz, N, n, n)
    args = [eye(n) + 0.3 * r(Bz, N, n, n), 0.3 * r(Bz, N, n, m),
            r(Bz, N, n), r(Bz, N, m), W @ W.transpose(-1, -2) / n + eye(n),
            r(Bz, N, m, m), 0.1 * r(Bz, N, m, n), r(Bz, n),
            eye(n).expand(Bz, n, n).contiguous(),
            torch.full((Bz,), 1e-6, device="cuda")]
    args[5] = args[5] + args[5].transpose(-1, -2)      # indefinite luu
    graphs = len(riccati._graphs)
    for layout in ("contiguous", "strided"):
        if layout == "strided":
            args[4] = args[4].transpose(-1, -2)
        riccati.reset_counts()
        cholesky.reset_launch_counts()
        eager = riccati._sequential(*(a.contiguous() for a in args),
                                    cuda_chol=True)
        falls = riccati.read_fallbacks()
        assert falls > 0, "the batch never fell back"
        riccati.backward_sequential(*args, cuda_chol=True)  # captures if new
        for _ in range(2):
            riccati.reset_counts()
            cholesky.reset_launch_counts()
            out = riccati.backward_sequential(*args, cuda_chol=True)
            assert cholesky.batched_cholesky_solve.launches == N
            assert riccati.read_fallbacks() == falls
            for o, e in zip(out, eager):
                assert torch.equal(o.nan_to_num(), e.nan_to_num()), layout
    assert len(riccati._graphs) == graphs + 1     # one graph for both


@pytest.mark.gpu
def test_cuda_candidate_sweep_takes_the_cholesky_kernel(monkeypatch):
    """The time-optimal candidate sweep with cuda_chol at B=3, N=6 (exact
    Hessian), from a nominal with its tracking warm start: N Cholesky
    launches per backward pass, the kernel held against its plain version
    on the sweep's first batch of systems (the same non-finite systems in
    both, the rest within 2e-3 of each system's largest entry), and the
    sweep's result held against the same sweep on the CPU, where the
    kernel route takes the kernel's plain version: each candidate's cost
    within 5% and violation within 0.3 (1 + v), the tolerance the port's
    racing solve is held to.  The reference route is no yardstick here:
    where Quu is singular or indefinite the kernel's clamped pivots keep X
    finite and the knot does not fall back (a rule the reference's kernel
    shares), so the two routes compute different steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control import waypoints as wp
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.examples.glider_time_probe import (
        short_course_config)
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    N = 6
    cfg = SolverConfig(max_al_iters=1, max_inner_iters=2)
    course = short_course_config()
    params = {d: AircraftParams.from_config(course.aircraft, device=d)
              for d in ("cuda", "cpu")}
    nominal = wp.solve_waypoint_racing(params["cuda"], course, num_nodes=N,
                                       dt=0.1, substeps=10, warm_start=True,
                                       solver_config=cfg, device="cuda")
    first = []
    real = riccati.batched_cholesky_solve

    def capture(a, rhs):
        if not first:
            first.append((a.clone(), rhs.clone()))
        return real(a, rhs)

    monkeypatch.setattr(riccati, "batched_cholesky_solve", capture)
    sols = {}
    for d in ("cuda", "cpu"):
        cholesky.reset_launch_counts()
        riccati.reset_counts()
        sols[d] = wp._uniform_candidate_sweep(
            params[d], course, nominal, 0.1,
            np.asarray([0.08, 0.1, 0.12], np.float32), num_nodes=N,
            substeps=10, solver_config=cfg, cuda_chol=True)
        if d == "cuda":
            assert cholesky.batched_cholesky_solve.launches == 2 * N
        assert 0 <= riccati.read_fallbacks() <= 2 * N
    a, rhs = first[0]
    assert tuple(a.shape) == (3, 9, 9) and tuple(rhs.shape) == (3, 9, 16)
    chip_smoke.hold_cholesky_indefinite(a, rhs, "candidate sweep B=3")
    sol, cpu = sols["cuda"], sols["cpu"]
    assert sol.xs.shape == (3, N + 1, 15) and sol.us.shape == (3, N, 9)
    assert bool(torch.isfinite(sol.xs).all() & torch.isfinite(sol.us).all())
    # the sweep took steps: the comparison is not of two untouched seeds
    moved = (cpu.us - nominal.us.cpu()[None]).abs().flatten(1).amax(1)
    assert bool((moved > 0).any()), moved
    for c, cr, v, vr in zip(sol.cost.tolist(), cpu.cost.tolist(),
                            sol.violation.tolist(), cpu.violation.tolist()):
        assert abs(c - cr) / (1.0 + abs(cr)) < 0.05, (c, cr)
        assert abs(v - vr) < 0.3 * (1.0 + vr), (v, vr)


def _smoke(cwd: Path, env_extra: dict):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no card the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory the script exits non-zero and prints no result
    line, card or not."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path, {})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
