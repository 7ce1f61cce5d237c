#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (aircraft_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  In phases, each of which
must pass or the script exits non-zero without a result line:

1. device   - the card's name, and its name and power limit from nvidia-smi;
2. build    - nvcc builds every kernel of csrc/ (one process per source,
              all at once) and prints ptxas' registers, shared memory and
              spills;
3. kernels  - each kernel against its plain PyTorch version on the same
              inputs: at full width (B=256, N=50, the bench knobs, states
              from a rollout of the fleet) and on a small batch with
              reversed-flow lanes under both coefficient models.  Gains
              and line-search candidate costs within 1e-2 relative; the
              chosen candidate, replayed knot by knot through the plain
              knot function, within 2e-4 (controls: of the magnitudes
              their feedback sum adds).
              Times from CUDA events;
4. main     - the serving-chain headline (python -m aircraft_tpu_torch.bench)
              at full width: a cold window and three chained windows, with
              every launch counter reset just before and read just after;
5. report   - one JSON line of the kernels, the card's name and power
              limit, and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FP32_PEAK = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
GAIN_TOL = 1e-2
COST_TOL = 2e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def phase(name):
    print(f"== {name}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# work of the two kernels, counted from their source for this run's shapes
# ---------------------------------------------------------------------------


def knot_flops(op) -> int:
    """fp32 operations of one primal knot (window_physics.cuh::knot),
    an FMA counted as two."""
    mlp = 2 * (5 * 16 + 16 * 32 + 32 * 6) + 32 if op.is_mlp else 24
    deriv = mlp + 160                       # flow, forces, Newton-Euler
    rk4 = 4 * deriv + 13 * 9 + 12           # stages, combination, renorm
    extras = 60 + 40 + 4 * op.nr + 6 * op.ng + 10
    return op.spec.substeps * rk4 + extras


def backward_work(op, B):
    N, nr, ng = op.spec.N, op.nr, op.ng
    f = knot_flops(op)
    tangents = 21 * 2 * f                   # a dual op: value + tangent
    assembly = 2 * 21 * 21 * (nr + ng) + 2 * 21 * (nr + ng)
    riccati = (2 * 21 * 14 * 14 + 2 * 21 * 21 * 14 + 2 * 21 * 14
               + 7 ** 3 // 3 + 2 * 15 * 49 + 2 * 14 * 7 * 7
               + 2 * 14 * 14 * 7 * 2 + 2 * 14 * 7 * 3)
    flops = B * N * (f + tangents + assembly + riccati)
    floats_in = (B * (N + 1) * 14 + B * N * 7 + B * N * ng + 2 * B
                 + B * ng + B * 14 + B * 196 + op.mlp.numel()
                 + op.table.numel() + N)
    floats_out = B * N * 98 + B * N * 7 + 3 * B
    return flops, 4 * (floats_in + floats_out) + B


def forward_work(op, B):
    N, A = op.spec.N, len(op.alphas)
    per_knot = knot_flops(op) + 2 * 7 * 14 + 3 * 7 + 2 * 14 + 8 * op.ng + 10
    flops = B * A * (N * per_knot + 12)
    floats_in = (B * (N + 1) * 14 + B * N * 7 + B * N * 98 + B * N * 7
                 + B * N * op.ng + B + B * op.ng + op.mlp.numel()
                 + op.table.numel() + N)
    floats_out = B * (N + 1) * 14 + B * N * 7 + B * (A + 3)
    return flops, 4 * (floats_in + floats_out)


def bound_ms(work):
    flops, nbytes = work
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def rel_err(a, ref):
    import torch

    return float(torch.max(torch.abs(a - ref))) / (
        1.0 + float(torch.max(torch.abs(ref))))


def close(a, ref, tol):
    """Elementwise |a - ref| <= tol (1 + |ref|), equal infinities allowed."""
    import torch

    both_inf = torch.isinf(a) & torch.isinf(ref) & (torch.sign(a) == torch.sign(ref))
    ok = (torch.abs(a - ref) <= tol * (1.0 + torch.abs(ref))) | both_inf
    return bool(ok.all()), float(torch.max(torch.where(
        both_inf, torch.zeros_like(a), torch.abs(a - ref))))


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def window_inputs(ocp, spec, z0s, us, config, N):
    """Backward/forward inputs from a rollout of (z0s, us): multipliers
    after one update (so active sets are live), the terminal expansion."""
    import torch

    from aircraft_tpu_torch.ops.autodiff import batched_grad_hessian
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    xs = [z0s]
    x = z0s
    for k in range(N):
        x_next = ocp.step(x, us[:, k], torch.tensor(k, device=x.device))
        ok = torch.isfinite(x_next).all(-1) & (x_next.abs().amax(-1) < 1e6)
        x = torch.where(ok[:, None], x_next, x)
        xs.append(x)
    xs = torch.stack(xs, dim=1).contiguous()
    al = ocp_mod.init_al_state(ocp, z0s, us[:, 0], N, mu0=config.penalty_init)
    al = ocp_mod.update_multipliers(ocp, al, xs, us, config.penalty_scale,
                                    config.penalty_max, row_adapt=True)
    vx, vxx = batched_grad_hessian(
        lambda xT: ocp_mod.al_terminal_cost(ocp, al, xT), xs[:, -1])
    B = z0s.shape[0]
    return dict(xs=xs, ws=us.contiguous(), lam=al.lam_ineq.contiguous(),
                mu=al.mu.contiguous(), reg=torch.full((B,), 1e-6, device=xs.device),
                mu_row=al.mu_row.contiguous(), vx=vx.contiguous(),
                vxx=vxx.contiguous())


def hold_kernels(op, inp, label, timing_reps=0):
    """Both kernels against their plain versions on `inp`; returns the
    errors and, with timing_reps, the times."""
    import torch

    from aircraft_tpu_torch.kernels import window as win

    bw_args = (inp["xs"], inp["ws"], inp["lam"], inp["mu"], inp["reg"],
               inp["mu_row"], inp["vx"], inp["vxx"])
    K, kff, dv1, dv2, qu, fail = win.window_backward(op, *bw_args)
    Kp, kffp, dv1p, dv2p, qup, failp = win.backward_plain(op, *bw_args)
    torch.cuda.synchronize()
    errs = {"K": rel_err(K, Kp), "k": rel_err(kff, kffp),
            "qu_max": float(torch.max(torch.abs(qu - qup) / (1.0 + qup))),
            "dv1": rel_err(dv1, dv1p), "dv2": rel_err(dv2, dv2p)}
    print(f"{label} backward: rel err {json.dumps(errs)} (tol {GAIN_TOL}); "
          f"fail flags kernel {int(fail.sum())} plain {int(failp.sum())}",
          flush=True)
    for name, e in errs.items():
        check(e < GAIN_TOL, f"{label} backward {name}: rel err {e} >= {GAIN_TOL}")
    check(bool((fail == failp).all()), f"{label} backward: fail flags differ")

    fw_args = (inp["xs"], inp["ws"], Kp, kffp, inp["lam"], inp["mu"],
               inp["mu_row"])
    xs_n, ws_n, misc = win.window_forward(op, *fw_args)
    xs_p, ws_p, misc_p = win.forward_plain(op, *fw_args)
    torch.cuda.synchronize()
    A = len(op.alphas)
    # every candidate within the gain tolerance: a far step sends a
    # 50-knot closed-loop rollout of this plant through regimes where the
    # rounding of two summation orders grows by orders of magnitude
    ok, cand_err = close(misc[:, :A], misc_p[:, :A], GAIN_TOL)
    if not ok:
        d = torch.abs(misc[:, :A] - misc_p[:, :A]) / (1 + torch.abs(misc_p[:, :A]))
        d = torch.nan_to_num(d, nan=float("inf"))
        for i in torch.argsort(d.flatten(), descending=True)[:5].tolist():
            b, a = divmod(i, A)
            print(f"  scenario {b} alpha {op.alphas[a]}: kernel {misc[b].tolist()} "
                  f"plain {misc_p[b].tolist()}", flush=True)
    check(ok, f"{label} forward: candidate costs differ beyond {GAIN_TOL}")
    # the pick may only differ where two plain candidates tie within that
    srt = torch.sort(misc_p[:, :A], dim=1).values
    near_tie = torch.abs(srt[:, 1] - srt[:, 0]) <= GAIN_TOL * (1 + torch.abs(srt[:, 0]))
    same = misc[:, A + 2] == misc_p[:, A + 2]
    check(bool((same | near_tie).all()), f"{label} forward: best alpha differs")
    # the chosen candidate, replayed knot by knot through the plain knot
    # function: every control, next state and the total cost tight
    cost_err, x_err, w_err = replay_chosen(op, inp, Kp, kffp, xs_n, ws_n, misc)
    print(f"{label} forward: max abs err candidate costs {cand_err:.3e} (tol "
          f"{GAIN_TOL} x (1+|ref|)); chosen candidate replayed: cost "
          f"{cost_err:.3e}, next states {x_err:.3e}, controls {w_err:.3e} (tol "
          f"{COST_TOL} x (1+|ref|)); same alpha on {int(same.sum())}/"
          f"{same.numel()} (rest within a tie)", flush=True)
    out = {"backward_err": float(torch.max(torch.abs(K - Kp))),
           "forward_err": cost_err}
    if timing_reps:
        out["backward_ms"] = cuda_ms(lambda: win.window_backward(op, *bw_args),
                                     timing_reps)
        out["backward_plain_ms"] = cuda_ms(
            lambda: win.backward_plain(op, *bw_args), 2)
        out["forward_ms"] = cuda_ms(lambda: win.window_forward(op, *fw_args),
                                    timing_reps)
        out["forward_plain_ms"] = cuda_ms(
            lambda: win.forward_plain(op, *fw_args), 2)
    return out


def replay_chosen(op, inp, K, kff, xs_n, ws_n, misc):
    """Replay the kernel's stored trajectory through the plain knot
    function, one knot at a time, so no rounding difference accumulates:
    each stored control is w_ref + α k + K (x - x_ref) at the chosen α,
    each stored next state is the (freeze-guarded) step of the stored
    state, and the best cost is the sum of the plain stage costs plus the
    terminal cost and the freeze penalties."""
    import torch

    from aircraft_tpu_torch.kernels import window as win

    A = len(op.alphas)
    alpha = misc[:, A + 2]
    xs, ws = inp["xs"], inp["ws"]
    cost = torch.zeros_like(alpha)
    nfro = torch.zeros_like(alpha)
    x_err = w_err = 0.0
    for k in range(op.spec.N):
        x = xs_n[:, k]
        dx = x - xs[:, k]
        w = (ws[:, k] + alpha[:, None] * kff[:, k]
             + (K[:, k] @ dx[..., None])[..., 0])
        # a feedback sum of gains up to gain_clip rounds in proportion to
        # the magnitudes it adds, not to its result
        scale = (1.0 + ws[:, k].abs() + (alpha[:, None] * kff[:, k]).abs()
                 + (K[:, k].abs() @ dx.abs()[..., None])[..., 0])
        e = float(torch.max(torch.abs(ws_n[:, k] - w)))
        check(bool((torch.abs(ws_n[:, k] - w) <= COST_TOL * scale).all()),
              f"replay: control of knot {k} differs by {e}")
        w_err = max(w_err, e)
        c, xn = win.al_stage_cost(op, x, ws_n[:, k], op.restfac[k],
                                  inp["lam"][:, k], inp["mu"], inp["mu_row"])
        fin = torch.isfinite(xn).all(-1) & (xn.abs().amax(-1) < 1e6)
        xn = torch.where(fin[:, None], xn, x)
        ok, e = close(xs_n[:, k + 1], xn, COST_TOL)
        check(ok, f"replay: state after knot {k} differs by {e}")
        x_err = max(x_err, e)
        cost, nfro = cost + c, nfro + (~fin).float()
    cost = cost + win.terminal_cost(op, xs_n[:, -1])
    cost = torch.where(torch.isnan(cost), torch.full_like(cost, float("inf")), cost)
    cost = cost + win.FREEZE_PENALTY * nfro
    ok, cost_err = close(misc[:, A], cost, COST_TOL)
    check(ok, f"replay: best cost differs by {cost_err}")
    check(bool((misc[:, A + 1] == nfro).all()), "replay: frozen knot counts differ")
    return cost_err, x_err, w_err


def reversed_batch(model, N=10, n_fwd=8, n_rev=8):
    """A small batch on the bench problem: fleet states plus the same
    states flying backwards through the air (body-frame u_rel < 0)."""
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.dynamics.aircraft import v_frd_rel
    from aircraft_tpu_torch.dynamics.coefficients import DefaultCoeffParams, load_mlp
    from aircraft_tpu_torch.kernels import window as win

    coeff = load_mlp(device="cuda") if model == "nn" else DefaultCoeffParams()
    cfg, params, ocp, track, v_ref, spec = bench.build_problem(
        "cuda", coeff=coeff)
    config = bench.headline_config()
    z0s, trim = bench.fleet_states(params, track, n_fwd, v_ref)
    rev = z0s.clone()
    rev[:, 3:6] = -rev[:, 3:6]
    z0s = torch.cat([z0s, rev], dim=0)
    u_rel = v_frd_rel(params, z0s[:, :13], torch.zeros(z0s.shape[0], 7,
                                                      device="cuda"))[:, 0]
    check(bool((u_rel[n_fwd:] < 0).all()), "reversed lanes have u_rel >= 0")
    w0 = ocp.control_unsquash(trim.control[:7])
    gen = torch.Generator(device="cuda").manual_seed(1)
    us = (w0 + 0.05 * torch.randn((z0s.shape[0], N, 7), device="cuda",
                                  generator=gen)).contiguous()
    op = win.make_window_operands(spec, N, alphas=win.line_search_alphas(6),
                                  device="cuda")
    return op, window_inputs(ocp, spec, z0s, us, config, N)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from aircraft_tpu_torch import bench
        from aircraft_tpu_torch.kernels import _build
        from aircraft_tpu_torch.kernels import window as win
    except ImportError as e:
        print(f"chip_smoke: the aircraft_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
          f"nvidia-smi: {smi}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"nvcc build of {len(logs)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  {name}: {line.strip()}")

    phase("kernels at full width")
    cfg, params, ocp, track, v_ref, spec = bench.build_problem("cuda")
    config = bench.headline_config()
    B, N = 256, bench.N_HORIZON
    z0s, trim = bench.fleet_states(params, track, B, v_ref)
    w0 = ocp.control_unsquash(trim.control[:7])
    us = w0.reshape(1, 1, 7).expand(B, N, 7).contiguous()
    op = win.make_window_operands(spec, N, alphas=win.line_search_alphas(
        config.line_search_steps), device="cuda")
    inp = window_inputs(ocp, spec, z0s, us, config, N)
    full = hold_kernels(op, inp, "B=256 N=50 nn", timing_reps=20)
    work = {"window_backward": backward_work(op, B),
            "window_forward": forward_work(op, B)}

    phase("kernels on reversed-flow lanes, both coefficient models")
    for model in ("nn", "default"):
        op_s, inp_s = reversed_batch(model)
        hold_kernels(op_s, inp_s, f"B=16 N=10 {model} reversed")

    phase("main path")
    win.reset_launch_counts()
    head = bench.run_headline("cuda", batch=256, warmup=1, reps=2)
    launches = {fn.__name__: fn.launches for fn in win.KERNELS}
    print(json.dumps(head), flush=True)
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    check(head["finite_fraction"] == 1.0,
          f"finite_fraction {head['finite_fraction']}")
    check(head["fused_kernels"], "main path did not run the kernels")

    phase("report")
    kernels = []
    for name, replaces, key in (
            ("window_backward", "aircraft_tpu/kernels/window_kernel.py:482",
             "backward"),
            ("window_forward", "aircraft_tpu/kernels/window_kernel.py:700",
             "forward")):
        bms, by = bound_ms(work[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aircraft_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": full[f"{key}_err"], "ms": full[f"{key}_ms"],
            "plain_ms": full[f"{key}_plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": None})
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
