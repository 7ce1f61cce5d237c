#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (aircraft_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  In phases, each of which
must pass or the script exits non-zero without a result line:

1. device   - the card's name, and its name and power limit from nvidia-smi;
2. build    - nvcc builds every kernel of csrc/ (one process per source,
              all at once) and prints ptxas' registers, stack, spills and
              shared memory for every kernel entry;
3. window kernels - both window kernels against their plain PyTorch
              versions on the same inputs: at full width (B=256, N=50, the
              bench knobs, states from a rollout of the fleet) and on a
              small batch with reversed-flow lanes under both coefficient
              models.  Gains and line-search candidate costs within 1e-2
              relative; the chosen candidate, replayed knot by knot through
              the plain knot function, within 2e-4 (controls: of the
              magnitudes their feedback sum adds).  At full width it also
              prints the resident warps per SM of each window kernel and
              the time of each of window_backward's two launches (phase A,
              the knot-parallel linearisation; phase B, the Riccati sweep);
4. cholesky - the batched-Cholesky kernel against its plain version within
              2e-3 (1 + |ref|): on the Quu and [Qu | Qux] of the last knot
              (B=256) and of every knot (B=12800) of one backward sweep of
              the fleet (m=7, k=15), and on the chol bench mode's batch
              (B=12800, m=7, k=8), each timed beside one library
              factor-and-solve of the same systems; and at the
              quadrotor's shapes, one system per knot (k = 14): every
              knot's system of the first backward pass of a fixed-time
              solve (m = 4) and of the free-time refinement (m = 5, its
              indefinite knots non-finite in both, the reference's
              fallback rule), 60 systems each, from a 1 x 1 solve;
5. rollout  - the fused rollout kernel at B=1024, N=50, 10 substeps: every
              knot replayed from the kernel's own previous state through
              the plain step within 2e-4 (1 + |ref|), the whole
              trajectory's difference printed (open-loop rounding grows);
   After the rollout phase, both window kernels are held the same way at B=1
   and B=6 on the headline problem (N=50, MLP), at B=6 on the course
   problem (N=30, 5 substeps, default aero, the course track and knobs,
   the AL control box) and at B=1 on the whole mode's warm-start window
   (N=50, default aero, 12 step sizes), and timed in a CUDA graph of 20
   calls (`ms_b1`, `ms_b6`, `ms_course_b6`, `ms_whole_b1` on the kernels
   line);
6. sync audit - under torch.cuda.set_sync_debug_mode("error"), after a
              warm-up call each: MHTT._serve_step on the window kernels
              (B=1) and on the iLQR path, _serve_step_multi with its six
              candidates on both, up to the blob's pull, and both Riccati
              sweeps on the Cholesky kernel route at B=256, N=50 on the
              exact expansion (the sequential one as its CUDA graph's
              replay and eagerly).  A synchronising call raises there: the
              phase prints its traceback and the smoke fails
              ("sync audit: <what>: <error>"); a clean call prints
              "sync audit: <what>: no synchronising call";
7. paths    - each path with every launch counter reset just before and
              read just after: the fused serving chain at the bench's
              default depth (python -m aircraft_tpu_torch.bench: a cold
              window, 6 warm-up and 3 timed chained windows at B=256),
              each window's converged fraction, mean cost and mean
              violation on a line of its own, each window kernel launched
              once per inner iteration, finite fraction 1.0, the gate
              printed and not held (at the default seed the chain ends
              near the gate on the reference's set-up, chain_crossing.py);
              before it, the set-up (best-glide speed and L/D, the track
              laid out on them, the fleet trim) that build_problem("cuda")
              and build_problem("cpu") each find, held equal bit for bit
              (both search on the host in float64), v_ref held at the
              reference bench's 32.0 and glide_ld within 1% of its
              9.4444, printed beside them;
              one fused and one iLQR inner iteration timed
              piece by piece (host wall; the device's busy share from
              torch.profiler), and one backward pass on each Quu-solve
              route; the iLQR chain (--solver ilqr --cuda-chol: a cold and
              a chained window, 50 Cholesky launches per backward pass,
              the numeric fallback on at most a tenth of them, no window
              kernel); one fleet window with the exact Hessian on the
              Cholesky kernel route (1 AL x 4 inner), sequential (50
              launches per backward pass) and associative (1 launch per
              backward pass, its B*N = 12800 systems), the kernel held
              against its plain version on the associative sweep's first
              batch of those (indefinite) systems, and the two sweeps
              held at 2e-3 on an LQ batch at the fleet's shape; the
              kernel, chol and riccati bench modes; the serving loop: the
              latency mode (5 reps), the serve mode pipelined and then
              synchronous over 5 windows each (native telemetry, nothing
              dropped; the two cadences printed side by side), 5 windows
              of MHTT.run on the headline plant and budget pipelined and
              then synchronous (the same commits, bit for bit) and 4
              windows of the course flight with 6 candidates, each window
              kernel launched once per inner iteration of every window
              solve; the planners: the whole mode's warm start in full
              (MHTT along the Dubins line to the goal, N=297, window 50,
              overlap 30, 2 x 10 on the window kernels at B=1, default
              aero, 20 launches of each per window) and its constrained
              solve at 1 x 2 (no kernel) with one of its inner iterations
              timed piece by piece, then the time-optimal sweep at
              the probe's shapes (N=70, 10 substeps, 8 candidates + the
              nominal, 1 x 3 throughout) on the Cholesky kernel route:
              exactly N launches per backward pass of the candidate sweep
              and none in the B=1 solves, the kernel held against its
              plain version on the sweep's first batch (B=8, m=9, k=16,
              exact expansion), the result arrays' shapes checked.
              Beside the sweeps' times, the kernel-route sequential sweep's
              CUDA graph is held bit for bit against its eager sweep (K,
              k, fallbacks, N launches per replay) on the fleet's
              Gauss-Newton expansion and the exact window's, and the exact
              window prints each sweep's float32 gains against its own
              float64 run on the reference route; and the plant breadth
              (no kernel of the port runs on it): each coefficient model
              (linear and polynomial from data/networks, the MLP, a
              seeded mini-MLP, the default, the MLP's Taylor expansion
              about the fleet's trim) held on the card against the same
              code on the CPU at the 256 fleet states, its state
              derivative and its step's Jacobian within 2e-4 (1 + |ref|);
              the exponential-map step (10 substeps) over 40 knots at
              B=256, |q| within 1e-5 of 1; the implicit-Euler step (1 and
              5 substeps) and its linearisation at B=256, finite, under
              the sync audit; five rows of the ablation grid at its full
              width (N=40, glider, trim warm start) cut to 1 x 2, none
              carrying an error; one MHTT window of the polynomial plant
              at the headline window (N=50, B=1): iLQR, no window kernel;
              and the fleet scale (the bench's phase, warm, roofline,
              oppoints and scaling modes, parallel/ and the batched MPC
              example): the phase mode at B=256 on the Cholesky kernel
              route, every piece finite and positive and exactly 50
              Cholesky launches per timed backward call; the warm mode
              with --cuda-chol at B=256 and its own 2 x 6, exactly 50
              Cholesky launches per backward pass, the fallback on at
              most a tenth of them, finite fraction 1.0; the roofline
              mode at B=256, 2 x 6, its value in (0, 1.05] (above 1.05 is
              impossible) and each window kernel launched once per inner
              iteration; oppoints at 2x6 and 3x12r, no row carrying an
              error, each window kernel launched once per inner iteration
              of its two windows; the horizon-sharded sweep's three
              pieces in 5 blocks in this process
              (backward_associative_blocked, the aggregates stacked where
              ranks all-gather them) on the kernel route against
              backward_associative on the LQ batch at the fleet's shape
              (B=256, N=50), K and k within 2e-3 (1 + |ref|), one Cholesky
              launch per block; the scaling mode at one device (a fleet
              of 8, N=50, Cholesky kernel route), its one rank over NCCL
              (one card: NCCL takes one rank per card) also running
              solve_batch_sharded once more against the unsharded
              ilqr.solve_batch on the same inputs, the solutions and the
              summary bit for bit, 50 launches per backward pass;
              batched_mpc at batch 64 for 2 windows (N=25, 2 substeps,
              2 x 10), each window kernel launched once per inner
              iteration of every window solve; then the quadrotor's
              time-optimal solve (examples/time_optimal_quad.py's goal,
              N=60, the six scales and the two free-time refinements) on
              the Cholesky kernel route at 1 x 3: exactly N launches per
              backward pass of its eight solves; and, in the main
              process after the plant breadth, the estimator, the LQR and
              the stability analysis on the card against the same code on
              the CPU within 2e-4 (1 + |ref|): one estimate_wind (W=20),
              one LQR design about the default-aero trim with one
              closed_loop_step of 8 states, one
              discrete_stability_analysis (25 states, 20 time steps);
              and, in the main process after those, the learning path:
              an aero CSV of 131,072 samples (inputs input_mean +
              input_std·N(0, 1), numpy seed 0, with data/networks/
              mlp.npz's scalers; labels the shipped MLP in float64 on
              the host) written under the build directory and read back
              bit for bit by load_aero_csv; examples/fit_surrogates.py on
              it (linear and polynomial fits, the 5-16-32-6 MLP at batch
              512), every RMSE and loss finite and the MLP's validation
              loss below its first epoch's; one train_mlp step on the card
              against the CPU from the same weights and batch within 1e-4
              (1 + |ref|); the trained MLP on the headline window (B=256,
              N=50): both window kernels held against their plain
              versions as above, then one fused window solve, each
              window kernel launched once per inner iteration (36); the
              batch-norm MLP (5-64-64-6, 3 epochs of 4,096 samples at
              batch 256; its train-mode outputs, as its pre-norm biases'
              gradients are rounding noise) and the GP (n=256, 50 Adam
              iterations; hyperparameters and predictions) card against
              CPU within 1e-3 (1 + |ref|); the default DDPG agent (obs 13,
              act 3, hidden (256, 128)): 200 updates at batch 64 and 200
              at 256 timed, one update card against CPU within 1e-4
              (1 + |ref|) in every net and loss, examples/train_ddpg.py
              (in the side process, below) for 60 episodes of at most 150 steps (its curriculum's
              first 50 episodes, goal distance 0, end after one step, so
              its replay buffer passes the 1,000 transitions that start
              training only in the second stage: the advance and at least
              one update held); torch.profiler traces of one train_mlp
              epoch (10 steps at batch 512) and of 20 DDPG updates at
              batch 64: launches and device records per step and the
              device's busy share, printed; the NLP oracle
              (solve_reference_nlp) on the quadrotor control problem
              (N=20, dt 0.1) on the card against the CPU (max |du| <
              1e-4, relative cost < 1e-9), both walls printed;
              and, in the main process after the learning path, the
              tooling (tooling_path), each piece held on the card
              against the same code on the CPU within 2e-4 (1 + |ref|):
              aircraft_tpu_torch.entry's flagship step (B=256, 10
              substeps, MLP aero) timed by timed_jit_call;
              check_jacobian of the plant "ok" and a profile_trace of
              one step holding a kernel record; native_available() and
              4,096 random Dubins problems, native against the Python
              path within 1e-9; examples/full_course.py cut to 4
              windows: each window kernel once per inner iteration of
              every window solve; and, in the side process after
              train_ddpg, the last examples (examples_path):
              examples/openloop_sim.py at its full 500 steps, finite,
              its first 50 knots held (the whole flight's difference
              printed), aero_polars (71 alpha, default and MLP aero) and
              the plotter's plant panels (with and without wind) on its
              flight, the h5 round trip and the dashboard only where
              h5py and matplotlib are installed (checked with find_spec,
              one line naming what was skipped), and
              examples/waypoint_racing.py --cuda-chol cut to 1 x 3 (warm
              start 1 x 3): exactly N = 70 Cholesky launches per
              backward pass; then entry.dryrun_multichip(1) over NCCL
              (the sharded solve, the tensor-parallel MLP step and the
              horizon-sharded sweep at 1 x 1; one card).
              Cuts, never a width or a
              shape: fit_surrogates' 150 epochs -> 20; the phase mode's reps 5 -> 2; the warm
              mode's 6 warm windows -> 2; the roofline mode's reps 3 -> 2; oppoints'
              six points -> two, warmup 6 -> 0, reps 3 -> 1; the scaling
              mode's 2 x 6 -> 1 x 2 and reps 3 -> 1; batched_mpc's 5
              windows -> 2; waypoint_racing's 6 x 20 (warm 1 x 30) ->
              1 x 3; full_course's whole course -> 4 windows;
   Every entry point that builds the headline problem is handed the
   plant's best glide, found once per process (mlp_glide): its three trim
   searches took ~8 s at each of a dozen call sites.  Once the kernels'
   device times are taken (after the serving shapes), the planners and
   the fleet scale (and the quadrotor, train_ddpg, openloop_sim,
   waypoint_racing and the entry module's dry run) run in a second
   process on the same card
   (chip_smoke.py --side RESULT, its own counts and clock) beside the
   other paths, to keep the smoke within its limit; its log is printed
   after the learning path, and its failure fails the smoke.  Every
   process the smoke starts is stopped before it exits.
8. report   - one JSON line of the kernels, the card's name and power
              limit, and the last line {"ok": true, "device": {...}}.

Every kernel has two times.  `ms` is its device time, the kernel's own:
the summed durations of its entries in a torch.profiler trace of timed
calls, per call (K1's two entries summed); `share` is bound_ms / ms.
`wrapper_ms` is CUDA events around back-to-back wrapper calls, per call:
where the wrapper's host work outlasts its kernel, it is host time.  The
library call has both too: `library_ms` (every device activity of one
call) and `library_wrapper_ms`.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

GAIN_TOL = 1e-2
COST_TOL = 2e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mlp_glide(device="cuda"):
    """The headline plant's (v_ref, glide_ld), found once per process and
    handed to every bench entry point that builds the headline problem
    (``bench.plant_best_glide``: three trim searches, ~8 s on the card)."""
    from aircraft_tpu_torch import bench

    return bench.plant_best_glide(fleet_problem_params(device))


# the reference bench's (v_ref, glide_ld) for data/networks/mlp.npz
# (chain_crossing.REFERENCE_GLIDE, which imports the JAX side)
REFERENCE_SETUP = (32.0, 9.444397062835858)


def setup_holds():
    """The headline's set-up as ``bench.build_problem("cuda")`` and
    ``build_problem("cpu")`` each find it (their trim searches run on the
    host in float64 from the reference's start clouds), held equal bit for
    bit: v_ref, the track laid out on the best glide, the fleet trim; and
    against the reference bench's.  Returns the line it prints."""
    from aircraft_tpu_torch import bench

    found = {}
    for dev in ("cuda", "cpu"):
        _, params, _, track, v_ref, _ = bench.build_problem(dev)
        _, trim = bench.fleet_states(params, track, 1, v_ref)
        found[dev] = (v_ref, track.track_points.cpu(),
                      [t.cpu() for t in trim])
    (vc, tc, trim_c), (vh, th, trim_h) = found["cuda"], found["cpu"]
    check(vc == vh and torch_equal(tc, th)
          and all(torch_equal(a, b) for a, b in zip(trim_c, trim_h)),
          "set-up: build_problem('cuda') and build_problem('cpu') differ")
    glide = mlp_glide()
    check(glide[0] == vc == REFERENCE_SETUP[0]
          and abs(glide[1] / REFERENCE_SETUP[1] - 1.0) <= 1e-2,
          f"set-up: (v_ref, glide_ld) {glide} against the reference's "
          f"{REFERENCE_SETUP}")
    return (f"set-up: v_ref, glide_ld {json.dumps(list(glide))} (the "
            f"reference bench's {json.dumps(list(REFERENCE_SETUP))}); "
            "fleet trim control "
            f"{json.dumps(trim_c[1].numpy().round(5).tolist())}; "
            "build_problem on cuda and on cpu bit-equal (v_ref, track, "
            "fleet trim)")


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def fleet_problem_params(device="cuda"):
    """The headline plant's parameters (the trained MLP) on ``device``."""
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp

    return AircraftParams.from_config(glider_config().aircraft,
                                      coeff=load_mlp(device=device),
                                      device=device)


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


def backward_phase_ms(op, bw_args, reps):
    """Times of window_backward's phase A and phase B, each launched alone
    on the wrapper's buffers (no launch count)."""
    import torch

    from aircraft_tpu_torch.kernels import window as win

    B, N = bw_args[1].shape[:2]
    dev = bw_args[0].device
    quad = torch.empty((B, N, win.KNOT_FLOATS), device=dev)
    outs = win.window_backward(op, *bw_args)
    return {f"phase_{name}_ms": cuda_ms(
        lambda: win.launch_backward(op, bw_args, quad, outs, phases=bit), reps)
        for name, bit in (("a", 1), ("b", 2))}


def occupancy(op, B):
    """Resident warps per SM of each window kernel entry, from the CUDA
    occupancy calculator for this build, beside the warps a call needs."""
    import ctypes

    import torch

    from aircraft_tpu_torch.kernels import _build
    from aircraft_tpu_torch.kernels import window as win

    N, A = op.spec.N, len(op.alphas)
    smem = win.forward_smem_bytes(N, op.ng, A)
    wa, wb, wf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(_build.library("window_backward").window_backward_occupancy(
        ctypes.byref(wa), ctypes.byref(wb)) == 0, "occupancy query failed")
    check(_build.library("window_forward").window_forward_occupancy(
        A, smem, ctypes.byref(wf)) == 0, "occupancy query failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"resident warps per SM ({sms} SMs): window_backward phase A "
          f"{wa.value} ({B * N} knot warps: {B * N / (sms * wa.value):.2f} "
          f"waves), phase B {wb.value} ({B} scenario blocks); "
          f"window_forward {wf.value} at A={A} and {smem} bytes of shared "
          f"memory per block ({B * A} rollout warps: "
          f"{B * A / (sms * wf.value):.2f} waves)", flush=True)


def cuda_ms(fn, reps):
    """Wrapper time: CUDA events around `reps` back-to-back calls, per
    call.  Where a call's host work outlasts its kernels, this is host
    time."""
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


PREROLL_CALLS = 10
PREROLL_GAP_S = 0.01
TRACE_TRIES = 3
TIMED = "chip_smoke: timed calls"
# traces taken, those whose pre-roll lost kernel records, and how many
# (printed in the report phase)
TRACES = {"traces": 0, "preroll_lost_in": 0, "preroll_records_lost": 0}


def _trace(fn, reps):
    """({name: [duration, us]}, lost) for `reps` calls of fn in one
    torch.profiler trace: the device records of the calls, and how many
    of the calls' kernel launches (host-side records) left no device
    record.  A trace can lose the records of its first launches, so fn
    runs PREROLL_CALLS times first, inside the trace, and the device idles
    PREROLL_GAP_S before the timed calls; only records that start after
    that count (TRACES tallies the pre-roll's losses)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PREROLL_CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(PREROLL_GAP_S)
        with torch.profiler.record_function(TIMED):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events if e.name == TIMED)
    by_name = {}
    launches = [0, 0]    # pre-roll, timed
    kernels = [0, 0]
    for e in events:
        timed = e.time_range.start >= t0
        if e.device_type != torch.autograd.DeviceType.CUDA:
            launches[timed] += "LaunchKernel" in e.name
        elif e.name != TIMED:
            kernels[timed] += not e.name.startswith(("Memcpy", "Memset"))
            if timed:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    TRACES["traces"] += 1
    TRACES["preroll_lost_in"] += launches[0] > kernels[0]
    TRACES["preroll_records_lost"] += launches[0] - kernels[0]
    return by_name, launches[1] - kernels[1]


def device_ms(fn, reps, entries=None):
    """Device time: the summed durations of the device records of `reps`
    calls in a torch.profiler trace, per call.  With `entries`, the
    kernels whose name holds one of them, each launched once per call;
    without, every device activity of the call (a library call's kernels,
    copies and fills).  Only a whole trace counts: every kernel launch of
    the calls with its record, and of each name a whole number of records
    per call (one per entry).  A trace that lost records is printed and
    taken again, up to TRACE_TRIES times."""
    for _ in range(TRACE_TRIES):
        trace, lost = _trace(fn, reps)
        if entries is not None:
            trace = {n: [t for name, d in trace.items() if n in name
                         for t in d] for n in entries}
        seen = {n: len(d) for n, d in trace.items()}
        whole = lost == 0 and bool(seen) and all(
            c > 0 and c % reps == 0 and (entries is None or c == reps)
            for c in seen.values())
        if whole:
            return sum(sum(d) for d in trace.values()) * 1e-3 / reps
        print(f"device_ms: the trace of {reps} calls lost {lost} kernel "
              f"records ({sorted(seen.values())} records per name); tracing "
              "again", flush=True)
    raise SmokeFailure(f"{TRACE_TRIES} traces of {reps} calls lost records")


def graph_ms(fn, launches, replays=5):
    """A cross-check of a device time that needs no trace: `launches` calls
    of fn captured in one CUDA graph, the graph replayed back to back
    between CUDA events, per call.  The host is out of it; the graph adds
    its gap between dependent launches and the trace adds its overhead to
    each record, so the two agree to a few percent, not exactly."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


K1_ENTRIES = ("window_linearize_kernel", "window_riccati_kernel")
K2_ENTRIES = ("window_forward_kernel",)
K5_ENTRIES = ("batched_cholesky_kernel",)
K34_ENTRIES = ("fused_rollout_kernel",)


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
        bw = lambda: win.window_backward(op, *bw_args)
        fw = lambda: win.window_forward(op, *fw_args)
        out["backward_ms"] = cuda_ms(bw, timing_reps)
        out["backward_device_ms"] = device_ms(bw, timing_reps, K1_ENTRIES)
        out.update(backward_phase_ms(op, bw_args, timing_reps))
        print(f"{label} window_backward: wrapper {out['backward_ms']:.4f} ms, "
              f"device {out['backward_device_ms']:.4f} ms per call; phase A "
              f"{out['phase_a_ms']:.4f} ms + phase B {out['phase_b_ms']:.4f} "
              f"ms launched alone (wrapper)", flush=True)
        out["backward_plain_ms"] = cuda_ms(
            lambda: win.backward_plain(op, *bw_args), 2)
        out["forward_ms"] = cuda_ms(fw, timing_reps)
        out["forward_device_ms"] = device_ms(fw, timing_reps, K2_ENTRIES)
        print(f"{label} window_forward: wrapper {out['forward_ms']:.4f} ms, "
              f"device {out['forward_device_ms']:.4f} ms per call", flush=True)
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


def reversed_batch(model, N=10, n_fwd=8, n_rev=8, n_alpha=6):
    """A small batch on the bench problem: n_fwd fleet states plus n_rev of
    them flying backwards through the air (body-frame u_rel < 0), and
    operands with n_alpha line-search candidates."""
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.dynamics.aircraft import v_frd_rel
    from aircraft_tpu_torch.dynamics.coefficients import DefaultCoeffParams, load_mlp
    from aircraft_tpu_torch.kernels import window as win

    coeff = load_mlp(device="cuda") if model == "nn" else DefaultCoeffParams()
    cfg, params, ocp, track, v_ref, spec = bench.build_problem(
        "cuda", coeff=coeff, glide=mlp_glide() if model == "nn" else None)
    config = bench.headline_config()
    z0s, trim = bench.fleet_states(params, track, n_fwd, v_ref)
    rev = z0s[:n_rev].clone()
    rev[:, 3:6] = -rev[:, 3:6]
    z0s = torch.cat([z0s, rev], dim=0)
    u_rel = v_frd_rel(params, z0s[:, :13], torch.zeros(z0s.shape[0], 7,
                                                      device="cuda"))[:, 0]
    check(bool((u_rel[n_fwd:] < 0).all()), "reversed lanes have u_rel >= 0")
    w0 = ocp.control_unsquash(trim.control[:7])
    gen = torch.Generator(device="cuda").manual_seed(1)
    us = (w0 + 0.05 * torch.randn((z0s.shape[0], N, 7), device="cuda",
                                  generator=gen)).contiguous()
    op = win.make_window_operands(spec, N, alphas=win.line_search_alphas(n_alpha),
                                  device="cuda")
    return op, window_inputs(ocp, spec, z0s, us, config, N)


CHOL_TOL = 2e-3
ROLL_TOL = 2e-4


def hold_cholesky(a, rhs, label, timing_reps=0):
    """The batched-Cholesky kernel against its plain version on (a, rhs);
    returns the max abs error and, with timing_reps, the kernel's, the
    plain version's and one library factor-and-solve's times."""
    import torch

    from aircraft_tpu_torch.kernels import cholesky

    x = cholesky.batched_cholesky_solve(a, rhs)
    xp = cholesky.cholesky_solve_plain(a, rhs)
    torch.cuda.synchronize()
    ok, err = close(x, xp, CHOL_TOL)
    check(bool(torch.isfinite(x).all()), f"{label}: non-finite kernel output")
    print(f"{label}: max abs err {err:.3e} (tol {CHOL_TOL} x (1+|ref|))",
          flush=True)
    check(ok, f"{label}: kernel and plain version differ by {err}")
    out = {"err": err}
    if timing_reps:
        out.update(cholesky_times(a, rhs, label, timing_reps))
    return out


def cholesky_times(a, rhs, label, timing_reps):
    """The batched-Cholesky kernel's, its plain version's and one library
    factor-and-solve's times on (a, rhs), and the bound."""
    from aircraft_tpu_torch import bench, roofline
    from aircraft_tpu_torch.kernels import cholesky

    out = {}
    kern = lambda: cholesky.batched_cholesky_solve(a, rhs)
    lib = lambda: bench.library_cholesky_solve(a, rhs)
    out["wrapper_ms"] = cuda_ms(kern, timing_reps)
    out["ms"] = device_ms(kern, timing_reps, K5_ENTRIES)
    out["graph_ms"] = graph_ms(kern, timing_reps)
    out["plain_ms"] = cuda_ms(lambda: cholesky.cholesky_solve_plain(a, rhs),
                              timing_reps)
    out["library_wrapper_ms"] = cuda_ms(lib, timing_reps)
    out["library_ms"] = device_ms(lib, timing_reps)
    out["bound"] = roofline.bound_ms(roofline.cholesky_work(*rhs.shape))
    print(f"{label}: kernel device {out['ms']:.5f} ms, in a CUDA graph "
          f"{out['graph_ms']:.5f} ms, wrapper {out['wrapper_ms']:.5f} ms; "
          f"plain {out['plain_ms']:.4f} ms; library device "
          f"{out['library_ms']:.5f} ms, call "
          f"{out['library_wrapper_ms']:.4f} ms; bound "
          f"{out['bound'][0]:.6f} ms ({out['bound'][1]})", flush=True)
    return out


def spd_systems(B, m, k):
    """B random SPD systems on the card, A = W Wᵀ/m + 2I, with rhs
    (B, m, k)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(B)
    W = torch.randn((B, m, m), device="cuda", generator=gen)
    a = W @ W.transpose(-1, -2) / m + 2.0 * torch.eye(m, device="cuda")
    return a, torch.randn((B, m, k), device="cuda", generator=gen)


def sweep_systems(ocp, z0s, us, inp):
    """½(Quu+Quuᵀ) + reg·I and [Qu | Qux] of every knot of one backward
    sweep of the fleet (z0s, us) on the kernel route, from the last knot
    to the first as the sweep hands them to the kernel: a (N·B, 7, 7),
    rhs (N·B, 7, 15).  The expansion point is window_inputs' rollout
    `inp` with the multipliers after one update."""
    import torch

    from aircraft_tpu_torch.solvers import ilqr, riccati
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    N = us.shape[1]
    xs, al = inp["xs"], ocp_mod.init_al_state(ocp, z0s, us[:, 0], N)
    al = ocp_mod.update_multipliers(ocp, al, xs, us, 10.0, 1e8, row_adapt=True)
    A, Bm = ilqr.linearize(ocp, xs, us)
    quad = [ilqr._san(t, 1e8) for t in ilqr.quadraticize_gn(ocp, al, xs, us)]
    captured = []
    route = riccati.chol_solve_kernel

    def capture(M, rhs, reg):
        eye = torch.eye(M.shape[-1], device=M.device)
        captured.append((0.5 * (M + M.transpose(-1, -2))
                         + reg[:, None, None] * eye, rhs))
        return route(M, rhs, reg)

    riccati.chol_solve_kernel = capture
    try:
        # the eager sweep: the graph's first sweep would hand every system
        # twice (the eager pass, then the capture)
        riccati._sequential(A, Bm, *quad, inp["reg"], cuda_chol=True)
    finally:
        riccati.chol_solve_kernel = route
    check(len(captured) == N, f"sweep handed {len(captured)} solves, not {N}")
    return (torch.cat([a for a, _ in captured]).contiguous(),
            torch.cat([r for _, r in captured]).contiguous())


def hold_rollout(B, N, substeps, label, timing_reps=0):
    """The fused rollout kernel against the plain step: every knot of the
    kernel's trajectory replayed from its own previous state, and the
    whole plain rollout's difference printed."""
    import numpy as np
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.kernels import rollout as krollout
    from aircraft_tpu_torch.solvers import integrators

    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft,
                                        coeff=load_mlp(device="cuda"),
                                        device="cuda")
    x0 = torch.as_tensor(np.asarray(cfg.waypoints.initial_state, np.float32),
                         device="cuda").expand(B, 13).contiguous()
    # the kernel mode's zero controls, plus small surface deflections so
    # every control channel reaches the MLP
    gen = torch.Generator(device="cuda").manual_seed(2)
    us = 0.5 * torch.rand((B, N, 7), device="cuda", generator=gen) - 0.25
    us[..., 3:6] = 0.0
    op = krollout.make_rollout_operands(params, horizon=N, dt=bench.DT,
                                        substeps=substeps)
    step = integrators.make_step_fn(params, substeps=substeps, normalize="step")

    def replay(xs, what):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(xs).all()), f"{what}: non-finite states")
        check(bool((xs[:, 0] == x0).all()), f"{what}: first knot is not x0")
        prev = xs[:, :-1].reshape(-1, 13)
        nxt = step(prev, us.reshape(-1, 7), bench.DT)
        got = xs[:, 1:].reshape(-1, 13)
        ok, err = close(got, nxt, ROLL_TOL)
        if not ok:
            bad = torch.abs(got - nxt) > ROLL_TOL * (1 + torch.abs(nxt))
            r, i = divmod(int(torch.argmax(
                (torch.abs(got - nxt) / (1 + torch.abs(nxt))).flatten())), 13)
            print(f"{what}: {int(bad.sum())} of {bad.numel()} state entries "
                  f"beyond the tolerance, in {int(bad.any(-1).sum())} knots; "
                  f"worst: scenario {r // N} knot {r % N} entry {i}: kernel "
                  f"{float(got[r, i])!r} plain {float(nxt[r, i])!r}; state "
                  f"before {prev[r].tolist()}; kernel after {got[r].tolist()}; "
                  f"plain after {nxt[r].tolist()}", flush=True)
        return ok, err

    xs = krollout.fused_rollout(op, x0, us)
    ok, err = replay(xs, label)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = krollout.rollout_plain(op, x0, us)   # one call: seconds of launches
    stop.record()
    torch.cuda.synchronize()
    whole = float(torch.max(torch.abs(xs - plain)))
    print(f"{label}: every knot replayed through the plain step: max abs err "
          f"{err:.3e} (tol {ROLL_TOL} x (1+|ref|)); whole-trajectory max abs "
          f"difference from the plain rollout {whole:.3e}", flush=True)
    check(ok, f"{label}: a knot differs from the plain step by {err}")
    out = {"err": err, "op": op}
    if timing_reps:
        kern = lambda: krollout.fused_rollout(op, x0, us)
        out["wrapper_ms"] = cuda_ms(kern, timing_reps)
        out["ms"] = device_ms(kern, timing_reps, K34_ENTRIES)
        out["plain_ms"] = start.elapsed_time(stop)
        print(f"{label}: kernel device {out['ms']:.4f} ms, wrapper "
              f"{out['wrapper_ms']:.4f} ms; plain rollout "
              f"{out['plain_ms']:.1f} ms", flush=True)
    return out


def ilqr_breakdown(ocp, z0s, us, config):
    """Host wall time of each piece of one inner iteration of the iLQR
    solver on (z0s, us) (the second of two runs, after lazy
    initialisation), the device's busy share over that iteration (the
    kernels' summed durations in torch.profiler's trace over the wall;
    None where the profiler saw no device time) and the number of device
    kernels it ran."""
    import torch

    from aircraft_tpu_torch.solvers import ilqr
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    B, N = us.shape[:2]
    xs, _ = ilqr.initial_rollout(ocp, z0s, us)
    al = ocp_mod.init_al_state(ocp, z0s, us[:, 0], N, mu0=config.penalty_init)
    reg = torch.full((B,), config.reg_init, device=z0s.device)
    alphas = torch.tensor(ilqr.line_search_alphas(config.line_search_steps),
                          device=z0s.device)

    def iteration(times):
        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return r

        timed("al_total_cost", lambda: ocp_mod.al_total_cost(ocp, al, xs, us))
        A, Bm = timed("linearize", lambda: ilqr.linearize(ocp, xs, us))
        quad = timed("quadraticize_gn", lambda: [
            ilqr._san(t, 1e8) for t in ilqr.quadraticize_gn(ocp, al, xs, us)])
        K, kff, *_ = timed("backward_kernel_route", lambda: ilqr.backward_pass(
            A, Bm, *quad, reg, cuda_chol=True))
        timed("backward_reference_route",
              lambda: ilqr.backward_pass(A, Bm, *quad, reg))
        timed("forward_pass", lambda: ilqr.forward_pass(
            ocp, al, xs, us, K, kff, alphas))

    iteration({})
    times = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        iteration(times)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy = device_us * 1e-6 / wall if device_us > 0 else None
    return times, wall, busy, len(kernels)


def fleet_problem(B=256):
    """The bench problem for a fleet of B gliders at cruise trim over the
    horizon, and window_inputs' expansion point: (ocp, spec, config, z0s,
    us, inp)."""
    from aircraft_tpu_torch import bench

    _, params, ocp, track, v_ref, spec = bench.build_problem(
        "cuda", glide=mlp_glide())
    config = bench.headline_config()
    N = bench.N_HORIZON
    z0s, trim = bench.fleet_states(params, track, B, v_ref)
    w0 = ocp.control_unsquash(trim.control[:7])
    us = w0.reshape(1, 1, 7).expand(B, N, 7).contiguous()
    return ocp, spec, config, z0s, us, window_inputs(ocp, spec, z0s, us,
                                                      config, N)


def cholesky_phase(ocp, z0s, us, inp):
    """The batched-Cholesky kernel held and timed at its three batches: the
    last knot of one backward sweep of the fleet, every knot of it, and
    the chol bench mode's systems."""
    import torch

    from aircraft_tpu_torch import bench

    B, N = us.shape[:2]
    a, rhs = sweep_systems(ocp, z0s, us, inp)
    chol = hold_cholesky(a[:B], rhs[:B], f"sweep, last knot B={B} m=7 k=15",
                         timing_reps=200)
    chol_all = hold_cholesky(a, rhs, f"sweep, all {N} knots B={N * B} m=7 k=15",
                             timing_reps=50)
    A_cm, rhs_cm = (torch.as_tensor(t, device="cuda")
                    for t in bench.chol_problem())
    chol_cm = hold_cholesky(A_cm, rhs_cm, "chol mode B=12800 m=7 k=8",
                            timing_reps=50)
    print("batched_cholesky device ms: " + json.dumps({
        "sweep_last_knot_B256_k15": chol["ms"],
        "sweep_all_knots_B12800_k15": chol_all["ms"],
        "chol_mode_B12800_k8": chol_cm["ms"]}), flush=True)
    return chol, chol_all, chol_cm


def rollout_phase():
    """The fused rollout kernel held and timed at the kernel mode's shape."""
    from aircraft_tpu_torch import bench

    N = bench.N_HORIZON
    return hold_rollout(1024, N, 10, f"B=1024 N={N} ss=10", timing_reps=10)


def serving_holds(op, config):
    """Both window kernels held against their plain versions at the
    serving shapes and timed in a CUDA graph: B=1 and B=6 on the headline
    problem (one glider at s = 0.1 with the trim warm start, and six warm
    starts around it), B=6 on the course problem.  Returns {label: hold}
    with each hold's device times and bounds."""
    import torch

    from aircraft_tpu_torch import bench, roofline
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.course import build_course_mhtt
    from aircraft_tpu_torch.kernels import window as win
    from aircraft_tpu_torch.solvers.trim import multistart_trim

    _, ocp, _, z0, us0, _ = bench.serving_problem("cuda", glide=mlp_glide())
    gen = torch.Generator(device="cuda").manual_seed(5)
    us6 = us0[None].repeat(6, 1, 1)
    us6[1:] += 0.05 * torch.randn(us6[1:].shape, device="cuda", generator=gen)
    # the course: six gliders in a trimmed 30 m/s glide at the course's
    # start (±1 m), trim controls (±0.02 deg on the surfaces); further from
    # trim the 1.5 s open-loop rollout departs and every sweep fails
    course, _, _ = build_course_mhtt(glider_config(), device="cuda")
    Nc = course.N
    trim = multistart_trim(course.params, n_starts=32, target_airspeed=30.0,
                           generator=torch.Generator().manual_seed(0))
    zc = torch.cat([trim.state, trim.state.new_zeros(1)]).to(torch.float32)
    zc[:3] = torch.as_tensor(course.config.waypoints.initial_state[:3],
                             dtype=torch.float32)
    zc = zc[None].repeat(6, 1)
    zc[1:, :3] += torch.randn((5, 3), device="cuda", generator=gen)
    usc = trim.control[:7].to(torch.float32)[None, None].repeat(6, Nc, 1)
    usc[1:, :, :3] += 0.02 * torch.randn((5, Nc, 3), device="cuda",
                                         generator=gen)
    # the whole mode's warm start: one glider at the initial state, zero
    # controls, its MHTT window (default aero, 12 step sizes)
    whole = whole_warm_start_mhtt()
    zw = torch.zeros((1, 14), device="cuda")
    zw[0, :13] = torch.as_tensor(whole.config.waypoints.initial_state,
                                 dtype=torch.float32)
    cases = (
        ("B=1 N=50 nn", op, ocp, z0[None], us0[None].contiguous(), config),
        ("B=6 N=50 nn", op, ocp, z0[None].repeat(6, 1), us6.contiguous(),
         config),
        ("course B=6 N=30 ss=5 default", course._fused_solve.operands,
         course.ocp, zc, usc.contiguous(), course.solver_config),
        ("whole warm start B=1 N=50 default", whole._fused_solve.operands,
         whole.ocp, zw, torch.zeros((1, whole.N, 7), device="cuda"),
         whole.solver_config),
    )
    out = {}
    for label, op_i, ocp_i, z, us, cfg_i in cases:
        inp = window_inputs(ocp_i, None, z, us, cfg_i, us.shape[1])
        hold = hold_kernels(op_i, inp, label)
        B = us.shape[0]
        bw_args = (inp["xs"], inp["ws"], inp["lam"], inp["mu"], inp["reg"],
                   inp["mu_row"], inp["vx"], inp["vxx"])
        K, kff, *_ = win.backward_plain(op_i, *bw_args)
        fw_args = (inp["xs"], inp["ws"], K, kff, inp["lam"], inp["mu"],
                   inp["mu_row"])
        # timed in a CUDA graph of 20 calls: traces of these short
        # launches lost records of the timed calls themselves
        hold["backward_ms"] = graph_ms(
            lambda: win.window_backward(op_i, *bw_args), 20)
        hold["forward_ms"] = graph_ms(
            lambda: win.window_forward(op_i, *fw_args), 20)
        hold["backward_bound"] = roofline.bound_ms(
            roofline.backward_work(op_i, B))
        hold["forward_bound"] = roofline.bound_ms(
            roofline.forward_work(op_i, B))
        print(f"{label}: in a CUDA graph, window_backward "
              f"{hold['backward_ms']:.4f} ms (bound "
              f"{hold['backward_bound'][0]:.5f} ms), window_forward "
              f"{hold['forward_ms']:.4f} ms (bound "
              f"{hold['forward_bound'][0]:.5f} ms) per call", flush=True)
        out[label] = hold
    return out


class CountWindowSolves:
    """Counts MHTT's window solves (one-candidate and multi-candidate
    serve steps) while active, so the launches a path must make are
    known exactly: each window kernel once per inner iteration of every
    solve, a multi-candidate batch being one solve."""

    def __enter__(self):
        from aircraft_tpu_torch.control.mhtt import MHTT

        self.n = 0
        self.saved = {}
        for name in ("_serve_step", "_serve_step_multi"):
            orig = getattr(MHTT, name)
            self.saved[name] = orig

            def counted(mhtt, *a, _orig=orig, **k):
                self.n += 1
                return _orig(mhtt, *a, **k)

            setattr(MHTT, name, counted)
        return self

    def __exit__(self, *exc):
        from aircraft_tpu_torch.control.mhtt import MHTT

        for name, orig in self.saved.items():
            setattr(MHTT, name, orig)


def check_window_launches(label, solves, per_solve):
    """Every window kernel launched once per inner iteration of each of
    `solves` window solves; returns the counts."""
    from aircraft_tpu_torch import bench

    counts = bench.kernel_launches()
    want = solves * per_solve
    print(f"{label}: {solves} window solves x {per_solve} inner iterations; "
          f"window_backward {counts['window_backward']}, window_forward "
          f"{counts['window_forward']} launches (expected {want} each)",
          flush=True)
    for name in ("window_backward", "window_forward"):
        check(counts[name] == want,
              f"{label}: {counts[name]} {name} launches, expected {want}")
    return {name: counts[name] for name in ("window_backward",
                                            "window_forward")}


def headline_mhtt(solver_config, fused=None, device="cuda", coeff=None):
    """MHTT on the headline plant (or on ``coeff``'s), track and knobs (no
    tanh squash: MHTT has no squash knob, as in the reference), and the
    fleet's first glider at s = 0.1 with its trim controls: (mhtt, z0
    (1, 14), us0 (N, 7))."""
    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.control.course import COURSE_OCP_KNOBS
    from aircraft_tpu_torch.control.mhtt import MHTT

    cfg, params, _, track, v_ref, _ = bench.build_problem(
        device, coeff=coeff, glide=None if coeff is not None
        else mlp_glide(device))
    knobs = dict(COURSE_OCP_KNOBS)
    knobs["envelope_overrides"] = {**knobs["envelope_overrides"],
                                   "unit_scales": True}
    mhtt = MHTT(params, cfg, track, num_nodes=bench.N_HORIZON, dt=bench.DT,
                overlap=bench.OVERLAP, v_ref=v_ref,
                solver_config=solver_config, fused=fused, device=device,
                **knobs)
    z0, trim = bench.fleet_states(params, track, 1, v_ref, s_span=(0.1, 0.1))
    us0 = trim.control[:7][None].expand(bench.N_HORIZON, 7).contiguous()
    return mhtt, z0, us0


def strict(what, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"), once the work
    queued before it has finished: a call that synchronises the stream
    raises there, and fails the smoke with its traceback printed."""
    import traceback

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        traceback.print_exc()
        raise SmokeFailure(f"sync audit: {what}: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"sync audit: {what}: no synchronising call", flush=True)
    return out


def sync_audit(ocp, us, inp):
    """A warm MHTT._serve_step on the window kernels (B=1) and on the iLQR
    path, and a warm _serve_step_multi with its six candidates on each,
    up to the blob's pull (start_pull runs outside the audit), then both
    Riccati sweeps on the kernel route at the fleet's shape on the exact
    expansion of inp's point: each under strict()."""
    import numpy as np

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.control import mhtt as mhtt_mod
    from aircraft_tpu_torch.solvers import ilqr, riccati
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    real_pull = mhtt_mod.start_pull

    def pull_outside_the_audit(blob):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        return real_pull(blob)

    mhtt_mod.start_pull = pull_outside_the_audit
    try:
        for fused in (True, False):
            label = "window kernels" if fused else "iLQR"
            m, z0, us0 = headline_mhtt(bench.headline_config(1, 2),
                                       fused=fused, device=us.device)
            check(m.fused == fused, f"MHTT fused={m.fused}, asked {fused}")
            z, u, al, pull = m._serve_step(z0[0], us0, m._al0)   # warm-up
            mhtt_mod.finish_pull(pull)
            z, u, al, pull = strict(
                f"warm MHTT._serve_step ({label}, B=1)",
                lambda: m._serve_step(z, u, al))
            check(np.isfinite(mhtt_mod.finish_pull(pull)).all(),
                  f"{label} serve step: a non-finite blob")
            mhtt_mod.finish_pull(m._serve_step_multi(z, u, us0, al, 6)[3])
            *_, pull = strict(
                f"warm MHTT._serve_step_multi ({label}, 6 candidates)",
                lambda: m._serve_step_multi(z, u, us0, al, 6))
            check(np.isfinite(mhtt_mod.finish_pull(pull)).all(),
                  f"{label} six candidates: a non-finite blob")
    finally:
        mhtt_mod.start_pull = real_pull

    B, N = us.shape[:2]
    xs = inp["xs"]
    al = ocp_mod.init_al_state(ocp, xs[:, 0], us[:, 0], N)
    A, Bm = ilqr.linearize(ocp, xs, us)
    quad = [ilqr._san(t, 1e8) for t in ilqr.quadraticize(ocp, al, xs, us)]
    for mode in ("sequential", "associative"):
        sweep = lambda: ilqr.backward_pass(A, Bm, *quad, inp["reg"], mode,
                                           cuda_chol=True)
        sweep()                          # warm-up (the sequential: capture)
        replay = " (CUDA graph replay)" if mode == "sequential" else ""
        strict(f"riccati backward_{mode} on the kernel route{replay} "
               f"(B={B}, N={N}, exact expansion)", sweep)
    strict(f"riccati backward_sequential on the kernel route, eager (B={B}, "
           f"N={N}, exact expansion)",
           lambda: riccati._sequential(A, Bm, *quad, inp["reg"],
                                       cuda_chol=True))
    riccati.read_fallbacks()


def lq_batch(B, N, device="cuda", n=14, m=7):
    """A well-posed LQ batch at the fleet's shape: the bench riccati
    mode's stage data, one horizon per scenario, and reg = 1e-6."""
    import numpy as np
    import torch

    from aircraft_tpu_torch import bench

    rng = np.random.default_rng(7)
    per = [bench.riccati_problem(N, rng, n=n, m=m) for _ in range(B)]
    return tuple(torch.as_tensor(np.concatenate(t), device=device)
                 for t in zip(*per)) + (
        torch.full((B,), 1e-6, device=device),)


def lq_sweeps(B, N, device="cuda", n=14, m=7):
    """Both sweeps on the kernel route on a well-posed LQ batch at the
    fleet's shape (the bench riccati mode's stage data, one horizon per
    scenario): their gains within 2e-3 (1 + |ref|), and the Cholesky
    launches of each, counted just around it."""
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    args = lq_batch(B, N, device, n, m)
    out, launches = {}, {}
    riccati.reset_counts()
    for mode in ("sequential", "associative"):
        cholesky.reset_launch_counts()
        out[mode] = getattr(riccati, f"backward_{mode}")(*args,
                                                         cuda_chol=True)
        launches[mode] = cholesky.batched_cholesky_solve.launches
    check(riccati.read_fallbacks() == 0, "LQ sweeps fell back")
    errs = {}
    for i, name in enumerate(("K", "k")):
        ok, errs[name] = close(out["associative"][i], out["sequential"][i],
                               2e-3)
        check(ok, f"LQ B={B} N={N}: associative {name} differs from "
              f"sequential by {errs[name]}")
    print(f"LQ batch B={B} N={N} n={n} m={m} on the kernel route: "
          f"associative against sequential gains max abs err "
          f"{json.dumps(errs)} (tol 2e-3 x (1+|ref|)); Cholesky launches "
          f"{json.dumps(launches)}", flush=True)
    check(launches == {"sequential": N, "associative": 1},
          f"LQ sweeps: Cholesky launches {launches}")
    return {"errs": errs, "launches": launches}


def exact_window(ocp, z0s, us):
    """One fleet window with the exact Hessian on the kernel route (the
    headline knobs at 1 AL round x 4 inner iterations), once with the
    sequential sweep and once with the associative one, each with every
    count reset just before it: returns {mode: record}, the associative
    solve's first Cholesky batch (B·N systems) and both sweeps' gains at
    the window's first expansion point."""
    import dataclasses

    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import ilqr, riccati
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    B, N = us.shape[:2]
    records, first = {}, []
    real = riccati.batched_cholesky_solve

    def capture(a, rhs):
        if not first:
            first.append((a.clone(), rhs.clone()))
        return real(a, rhs)

    for mode in ("sequential", "associative"):
        config = dataclasses.replace(bench.headline_config(1, 4),
                                     hessian="exact", riccati=mode)
        reset_all_counts()
        if mode == "associative":
            riccati.batched_cholesky_solve = capture
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = ilqr.solve_batch(ocp, z0s, us, config, cuda_chol=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            riccati.batched_cholesky_solve = real
        passes = config.max_al_iters * config.max_inner_iters
        per_pass = N if mode == "sequential" else 1
        rec = {"wall_s": wall, "backward_passes": passes,
               "cholesky_launches": cholesky.batched_cholesky_solve.launches,
               "expected_launches": passes * per_pass,
               "chol_fallbacks": riccati.chol_fallbacks,
               "mean_cost": float(sol.cost.mean()),
               "mean_violation": float(sol.violation.mean()),
               "converged_fraction_1e2": float(
                   (sol.violation < 1e-2).float().mean()),
               "finite": all(bool(t.isfinite().all()) for t in (
                   sol.xs, sol.us, sol.cost, sol.violation))}
        print(f"exact window, {mode} sweep on the kernel route (B={B}, "
              f"N={N}, 1 x 4): " + json.dumps(rec), flush=True)
        check(rec["finite"], f"exact window, {mode}: non-finite results")
        check(rec["cholesky_launches"] == rec["expected_launches"],
              f"exact window, {mode}: {rec['cholesky_launches']} Cholesky "
              f"launches, expected {rec['expected_launches']}")
        records[mode] = rec
    check(bool(first) and first[0][0].shape[0] == B * N,
          "the associative sweep did not hand the kernel its B*N systems")
    # both sweeps at the window's first expansion point
    config = bench.headline_config(1, 4)
    xs, _ = ilqr.initial_rollout(ocp, z0s, us)
    al = ocp_mod.init_al_state(ocp, z0s, us[:, 0], N,
                               mu0=config.penalty_init)
    A, Bm = ilqr.linearize(ocp, xs, us)
    quad = [ilqr._san(t, 1e8) for t in ilqr.quadraticize(ocp, al, xs, us)]
    reg = torch.full((B,), config.reg_init, device=us.device)
    gains = {mode: ilqr.backward_pass(A, Bm, *quad, reg, mode,
                                      cuda_chol=True)
             for mode in ("sequential", "associative")}
    riccati.read_fallbacks()
    args = (A, Bm, *quad, reg)
    hold_sweep_graph(args, f"exact window's first expansion (B={B}, N={N})")
    # each sweep in float32 against itself in float64 on the same float32
    # expansion, on the reference route and on the kernel route, the two
    # float64 sweeps against each other, and where Quu is indefinite
    args64 = tuple(t.double() for t in args)

    def rel(a, b):
        d = (a.double() - b).abs().flatten(1).amax(1)
        r = (d / (1 + b.abs().flatten(1).amax(1))).nan_to_num(nan=math.inf)
        return {"max": float(r.max()), "median": float(r.median()),
                "scenarios_over_1e-2": int((r > 1e-2).sum())}

    min_eig, K64 = [], {}
    real = riccati.chol_solve_reference

    def recording(M, rhs, reg):
        min_eig.append(torch.linalg.eigvalsh(riccati._sym(M)).amin(-1))
        return real(M, rhs, reg)

    a2 = {}
    for mode in ("sequential", "associative"):
        K32 = ilqr.backward_pass(*args, mode)[0]
        if mode == "sequential":
            riccati.chol_solve_reference = recording
        try:
            K64[mode] = ilqr.backward_pass(*args64, mode)[0]
        finally:
            riccati.chol_solve_reference = real
        a2[f"{mode}_reference_route_f32_vs_f64"] = rel(K32, K64[mode])
        a2[f"{mode}_kernel_route_f32_vs_f64"] = rel(gains[mode][0],
                                                     K64[mode])
    a2["associative_vs_sequential_f64"] = rel(K64["associative"],
                                              K64["sequential"])
    eig = torch.stack(min_eig, dim=1)
    a2["indefinite_knots"] = int((eig < 0).sum())
    a2["knots"] = eig.numel()
    a2["min_eigenvalue"] = float(eig.min())
    print("first inner iteration of the exact window, gains max |dK| / "
          "(1 + max |K|) per scenario, float32 against float64 on the same "
          "float32 expansion; Quu of the float64 sequential sweep: "
          + json.dumps(a2), flush=True)
    records["float32_vs_float64"] = a2
    return records, first[0], gains


def hold_sweep_graph(args, label):
    """The kernel-route sequential sweep's CUDA graph against its eager
    sweep on contiguous copies of ``args`` (what the graph sweeps): K, k,
    dv1, dv2, max |Qu| and the flags bit for bit (NaN where NaN), the same
    fallback count, and the sweep's N Cholesky launches added at the
    replay."""
    import torch

    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    N = args[0].shape[1]
    reset_all_counts()
    eager = riccati._sequential(*(a.contiguous() for a in args),
                                cuda_chol=True)
    falls = riccati.read_fallbacks()
    riccati.backward_sequential(*args, cuda_chol=True)   # captures if new
    reset_all_counts()
    replay = riccati.backward_sequential(*args, cuda_chol=True)
    falls_r = riccati.read_fallbacks()
    launches = cholesky.batched_cholesky_solve.launches
    same = [bool(torch.equal(r.nan_to_num(), e.nan_to_num()))
            for r, e in zip(replay, eager)]
    print(f"{label}: the kernel-route sweep's CUDA graph against its eager "
          f"sweep: bit-equal {same} (K, k, dv1, dv2, max |Qu|, flags); "
          f"fallbacks {falls_r} (eager {falls}); Cholesky launches per "
          f"replay {launches}", flush=True)
    check(all(same) and falls_r == falls and launches == N,
          f"{label}: the graph's sweep differs from the eager one")
    return {"bit_equal": all(same), "fallbacks": falls}


def hold_cholesky_indefinite(a, rhs, label):
    """The batched-Cholesky kernel against its plain version on systems
    that need not be positive definite: the same systems non-finite in
    both, the rest within CHOL_TOL of the largest entry of each system's
    solution (a solve's rounding scales with its solution, not with each
    entry).  Returns the error, the share of non-finite systems and the
    largest relative error on the finite ones."""
    import torch

    from aircraft_tpu_torch.kernels import cholesky

    x = cholesky.batched_cholesky_solve(a, rhs)
    xp = cholesky.cholesky_solve_plain(a, rhs)
    torch.cuda.synchronize()
    fin, finp = (t.isfinite().flatten(1).all(1) for t in (x, xp))
    n_bad = int((~finp).sum())
    d = torch.abs(x[fin] - xp[fin]).flatten(1).amax(1)
    scale = 1.0 + torch.abs(xp[fin]).flatten(1).amax(1)
    err = float(d.max()) if d.numel() else 0.0
    worst = float((d / scale).max()) if d.numel() else 0.0
    print(f"{label}: {n_bad} of {a.shape[0]} systems non-finite in the "
          f"plain version, {int((~fin).sum())} in the kernel; finite "
          f"systems: max abs err {err:.3e}, max err over (1 + the system's "
          f"largest |X|) {worst:.3e} (tol {CHOL_TOL})", flush=True)
    check(bool((fin == finp).all()), f"{label}: kernel and plain version "
          "disagree on which systems are finite")
    check(worst <= CHOL_TOL, f"{label}: kernel and plain version differ "
          f"by {worst} of a system's solution")
    return err, n_bad / a.shape[0], worst


def fused_breakdown(ocp, spec, z0s, us, config):
    """Host wall time of each piece of one inner iteration of the fused
    solver (solvers/fused.py's loop body, piece by piece; the second of
    two runs, outside the profiler), the per-solve and per-AL-round
    pieces beside it, and, from a third run of the inner iteration's
    pieces under torch.profiler, its wall, the device's busy share over
    it and the number of device kernels it ran."""
    import torch

    from aircraft_tpu_torch.kernels import window as win
    from aircraft_tpu_torch.ops.autodiff import batched_grad_hessian
    from aircraft_tpu_torch.solvers import fused, ilqr
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    B, N = us.shape[:2]
    dev = us.device
    op = win.make_window_operands(
        spec, N, gain_clip=config.gain_clip,
        alphas=win.line_search_alphas(config.line_search_steps), device=dev)
    A = len(op.alphas)
    al = ocp_mod.init_al_state(ocp, z0s, us[:, 0], N,
                               mu0=config.penalty_init)
    lam, mu, mu_row = (t.contiguous() for t in (al.lam_ineq, al.mu,
                                                al.mu_row))
    ws = us.contiguous()

    def timed(times, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return r

    def run(times, xs):
        timed_ = lambda name, fn: timed(times, name, fn)
        reg = torch.full((B,), config.reg_init, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        vx, vxx = timed_("terminal_expansion", lambda: [
            fused._san(t).contiguous() for t in batched_grad_hessian(
                lambda x: ocp_mod.al_terminal_cost(ocp, al, x), xs[:, -1])])
        K, kff, _, _, qu_max, fail = timed_("window_backward", lambda: (
            win.window_backward(op, xs, ws, lam, mu, reg, mu_row, vx, vxx)))
        xs_new, ws_new, misc = timed_("window_forward", lambda: (
            win.window_forward(op, xs, ws, K, kff, lam, mu, mu_row)))

        def masks():
            cost_prev, cost_new = misc[:, A - 1], misc[:, A]
            improved = (cost_new < cost_prev - 1e-12) & ~fail
            torch.where(fail | ~improved,
                        torch.clamp_max(reg * config.reg_escalate,
                                        config.reg_max),
                        torch.clamp_min(reg / config.reg_relax,
                                        config.reg_init))
            accept = improved & ~done
            torch.where(accept[:, None, None], xs_new, xs)
            torch.where(accept[:, None, None], ws_new, ws)
            converged = (qu_max < config.tol) | (improved & (
                torch.abs(cost_prev - cost_new)
                < config.tol * (1.0 + torch.abs(cost_prev))))
            return done | (converged & ~fail)

        timed_("accept_and_masks", masks)

    times = {}
    for _ in range(2):
        xs = timed(times, "initial_rollout (per solve)", lambda: (
            ilqr.initial_rollout(ocp, z0s, us)[0].contiguous()))
        timed(times, "update_multipliers (per AL round)",
              lambda: ocp_mod.update_multipliers(
                  ocp, al, xs, ws, config.penalty_scale, config.penalty_max,
                  row_adapt=config.penalty_per_row))
        run(times, xs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run({}, xs)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy = device_us * 1e-6 / wall if device_us > 0 else None
    inner = sum(v for k, v in times.items() if "per " not in k)
    return times, inner, wall, busy, len(kernels)


def sweep_host_s(ocp, us, inp, reps=5):
    """Host wall time of one backward pass at the fleet's shape on each
    Quu-solve route (synchronised before and after, the median of reps,
    the routes in turns), on the Gauss-Newton expansion of inp's point:
    the kernel route as the solver takes it (a CUDA graph where the
    package has one, its first pass capturing it), that route's eager
    sweep where there is a graph, and the reference route."""
    import numpy as np
    import torch

    from aircraft_tpu_torch.solvers import ilqr, riccati
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    N = us.shape[1]
    xs = inp["xs"]
    al = ocp_mod.init_al_state(ocp, xs[:, 0], us[:, 0], N)
    A, Bm = ilqr.linearize(ocp, xs, us)
    quad = [ilqr._san(t, 1e8) for t in ilqr.quadraticize_gn(ocp, al, xs, us)]
    args = (A, Bm, *quad, inp["reg"])
    routes = {"kernel_route": lambda: ilqr.backward_pass(*args,
                                                         cuda_chol=True),
              "reference_route": lambda: ilqr.backward_pass(
                  *args, cuda_chol=False)}
    if hasattr(riccati, "_sequential"):
        routes["kernel_route_eager"] = lambda: riccati._sequential(
            *args, cuda_chol=True)
    walls = {name: [] for name in routes}
    for _ in range(reps + 1):
        for name, sweep in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return {k: float(np.median(v[1:])) for k, v in walls.items()}


# the serving loop's depth (each halved to make room for the fleet phase
# within the smoke's time limit)
LATENCY_REPS = 5
SERVE_WINDOWS = 5
COURSE_WINDOWS = 4


def serving_loop_paths():
    """The serving loop's four drives, each with the launch counters reset
    just before it and read just after; returns the launches per path and
    the drives' records."""
    import numpy as np
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.course import solve_full_course

    per_window = 3 * 12
    launches, records = {}, {}

    reset_all_counts()
    lat = bench.bench_latency("cuda", reps=LATENCY_REPS, glide=mlp_glide())
    print(json.dumps(lat), flush=True)
    check(lat["fused_kernels"], "latency mode did not run the kernels")
    check(math.isfinite(lat["cost"]) and math.isfinite(lat["violation"]),
          "latency mode: a non-finite solve")
    launches["latency"] = check_window_launches(
        "latency mode", 1 + lat["reps"], per_window)
    records["latency"] = lat

    # the serve mode pipelined and synchronous over the same windows
    reset_all_counts()
    srv = bench.bench_serve("cuda", windows=SERVE_WINDOWS, glide=mlp_glide())
    print(json.dumps(srv), flush=True)
    check(srv["telemetry_backend"] == "native",
          f"serve mode telemetry backend {srv['telemetry_backend']}")
    check(srv["telemetry_dropped"] == 0
          and srv["telemetry_records"] == 20 * SERVE_WINDOWS,
          f"serve mode telemetry: {srv['telemetry_records']} records, "
          f"{srv['telemetry_dropped']} dropped")
    check(srv["pipelined"] and srv["fused_kernels"],
          "serve mode: not pipelined on the kernels")
    check(math.isfinite(srv["mean_violation"]), "serve mode: non-finite")
    # the set-up call, then one solve per window
    launches["serve"] = check_window_launches(
        "serve mode (pipelined)", SERVE_WINDOWS + 1, per_window)
    records["serve"] = srv

    reset_all_counts()
    sync = bench.bench_serve("cuda", windows=SERVE_WINDOWS, pipeline=False,
                             glide=mlp_glide())
    print(json.dumps(sync), flush=True)
    check(sync["telemetry_dropped"] == 0
          and sync["telemetry_records"] == 20 * SERVE_WINDOWS
          and not sync["pipelined"], f"serve mode, synchronous: {sync}")
    launches["serve_sync"] = check_window_launches(
        "serve mode (synchronous)", SERVE_WINDOWS + 1, per_window)
    records["serve_sync"] = sync
    print(f"serve cadence over {SERVE_WINDOWS} windows each: pipelined p50 "
          f"{srv['p50_ms']} ms, p99 {srv['p99_ms']} ms; synchronous p50 "
          f"{sync['p50_ms']} ms, p99 {sync['p99_ms']} ms", flush=True)

    mhtt, z0, us0 = headline_mhtt(bench.headline_config())
    check(mhtt.fused, "MHTT on the card did not take the window kernels")
    runs = {}
    for pipeline in (True, False):
        reset_all_counts()
        t0 = time.perf_counter()
        with CountWindowSolves() as solves:
            out = mhtt.run(z0[0, :13], s0=float(z0[0, 13]), max_windows=5,
                           progress_target=2.0, us_init=us0,
                           pipeline=pipeline, diagnose_on_abort=False)
        wall = time.perf_counter() - t0
        key = "mhtt_run_pipelined" if pipeline else "mhtt_run_sync"
        launches[key] = check_window_launches(
            f"MHTT.run {'pipelined' if pipeline else 'synchronous'}",
            solves.n, per_window)
        rec = {"windows": out["windows"], "retries": out["retries"],
               "abort_reason": out["abort_reason"], "solves": solves.n,
               "progress": out["progress"], "wall_s": wall,
               "window_walls_s": out["window_walls_s"],
               "finite": bool(np.isfinite(out["states"]).all())}
        print(f"{key}: " + json.dumps(rec), flush=True)
        check(out["windows"] == 5 and out["abort_reason"] is None
              and rec["finite"], f"{key}: {rec}")
        runs[pipeline] = out
        records[key] = rec
    check(np.array_equal(runs[True]["states"], runs[False]["states"])
          and np.array_equal(runs[True]["controls"], runs[False]["controls"])
          and runs[True]["progress"] == runs[False]["progress"],
          "MHTT.run: pipelined and synchronous commits differ")
    print("MHTT.run: pipelined and synchronous commits bit-equal over "
          f"{runs[True]['controls'].shape[0]} knots", flush=True)

    reset_all_counts()
    t0 = time.perf_counter()
    with CountWindowSolves() as solves:
        crs = solve_full_course(glider_config(), max_windows=COURSE_WINDOWS,
                                device="cuda")
    wall = time.perf_counter() - t0
    rec = {"windows": crs["windows"], "retries": crs["retries"],
           "abort_reason": crs["abort_reason"], "solves": solves.n,
           "progress": crs["progress"], "misses": crs["misses"],
           "wall_s": wall, "window_walls_s": crs["window_walls_s"],
           "finite": bool(np.isfinite(crs["states"]).all())}
    print(f"course, {COURSE_WINDOWS} windows: " + json.dumps(rec), flush=True)
    check(crs["windows"] == COURSE_WINDOWS and crs["abort_reason"] is None
          and rec["finite"], f"course: {rec}")
    launches["course"] = check_window_launches(
        "course (6 candidates per window as one batch)", solves.n, 4 * 20)
    records["course"] = rec
    torch.cuda.synchronize()
    return launches, records


WHOLE_WINDOW, WHOLE_OVERLAP = 50, 30
WHOLE_WARM = (2, 10)         # the warm start's AL rounds x inner iterations


def whole_warm_start_mhtt():
    """The MHTT that ``waypoints.receding_warm_start`` builds for the whole
    mode: window 50, overlap 30, 2 x 10 Gauss-Newton, the default-aero
    plant along the Dubins line to the goal, on the window kernels."""
    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.control.mhtt import MHTT

    params, _, _, track_config = bench.whole_problem("cuda")
    mhtt = MHTT(params, track_config, DubinsInitialiser(track_config),
                num_nodes=WHOLE_WINDOW, dt=bench.DT, overlap=WHOLE_OVERLAP,
                solver_config=SolverConfig(
                    max_al_iters=WHOLE_WARM[0], max_inner_iters=WHOLE_WARM[1],
                    hessian="gauss_newton"), device="cuda")
    check(mhtt.fused, "the whole warm start's MHTT did not take the kernels")
    return mhtt
PROBE = dict(num_nodes=70, dt_nominal=0.1, substeps=10, n_candidates=8,
             dt_span=(0.6, 0.95))


def planners_paths():
    """The planners, each with every count reset just before it and read
    just after: the whole mode's warm start in full (MHTT along the Dubins
    line to the goal, N=297, window 50, overlap 30, 2 x 10 Gauss-Newton
    on the window kernels at B=1, default aero, 12 step sizes), then its
    constrained solve at 1 x 2; and the time-optimal sweep at the probe's
    course and shapes (N=70, dt 0.1, 10 substeps, 8 candidates) with the
    Cholesky kernel route, its tracking warm start, racing solve and
    candidate sweep cut to 1 x 3.  Returns (launches by path, records,
    the sweep's first Cholesky batch)."""
    import numpy as np
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control import waypoints as wp
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.examples.glider_time_probe import (
        short_course_config)
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import ilqr, riccati

    launches, records = {}, {}
    N = bench.WHOLE_HORIZON
    params, ocp, x0, track_config = bench.whole_problem("cuda")
    warm = SolverConfig(max_al_iters=WHOLE_WARM[0],
                        max_inner_iters=WHOLE_WARM[1], hessian="gauss_newton")
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CountWindowSolves() as solves:
        us0 = wp.receding_warm_start(params, track_config, num_nodes=N,
                                     dt=bench.DT, window=WHOLE_WINDOW,
                                     overlap=WHOLE_OVERLAP,
                                     solver_config=warm, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "windows": solves.n,
           "finite": bool(torch.isfinite(us0).all()),
           "shape": list(us0.shape)}
    print(f"whole: receding warm start N={N}, window {WHOLE_WINDOW}, overlap "
          f"{WHOLE_OVERLAP}: " + json.dumps(rec), flush=True)
    check(rec["finite"] and rec["shape"] == [N, 7],
          f"whole warm start: {rec}")
    launches["whole_warm_start"] = check_window_launches(
        "whole warm start", solves.n,
        warm.max_al_iters * warm.max_inner_iters)
    records["whole_warm_start"] = rec

    config = SolverConfig(max_al_iters=1, max_inner_iters=2,
                          hessian="gauss_newton", penalty_init=10.0)
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = ilqr.solve_impl(ocp, x0[None], us0[None], config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bench.kernel_launches()
    rec = {"wall_s_per_inner_iteration": wall / 2,
           "goal_miss_m": bench.whole_goal_miss(sol),
           "violation": float(sol.violation[0]), "cost": float(sol.cost[0]),
           "finite": all(bool(torch.isfinite(t).all()) for t in (
               sol.xs, sol.us, sol.cost, sol.violation))}
    print(f"whole: constrained solve N={N} at 1 x 2 (reference route): "
          + json.dumps(rec), flush=True)
    check(rec["finite"], f"whole solve: non-finite results {rec}")
    check(not any(counts[k] for k in ("window_backward", "window_forward",
                                      "batched_cholesky_solve")),
          f"whole solve launched a kernel: {counts}")
    times, wall, busy, n_launch = ilqr_breakdown(ocp, x0[None], us0[None],
                                                 config)
    rec["inner_iteration_pieces_s"] = times
    print(f"whole: one inner iteration at N={N}, B=1 (host wall, s): "
          + json.dumps({k: round(v, 4) for k, v in times.items()})
          + f"; profiled iteration wall {wall:.3f} s, device busy share "
          + (f"{busy:.3f}" if busy is not None else "not measured (the "
             "profiler saw no device time)")
          + f", {n_launch} kernel launches", flush=True)
    records["whole_solve"] = rec

    course = short_course_config()
    params = AircraftParams.from_config(course.aircraft, device="cuda")
    cut = SolverConfig(max_al_iters=1, max_inner_iters=3)
    first, in_sweep = [], {}
    real_kernel, real_sweep = (riccati.batched_cholesky_solve,
                               wp._uniform_candidate_sweep)

    def capture(a, rhs):
        if not first:
            first.append((a.clone(), rhs.clone()))
        return real_kernel(a, rhs)

    def counted_sweep(*a, **k):
        before = cholesky.batched_cholesky_solve.launches
        out = real_sweep(*a, **k)
        in_sweep["launches"] = cholesky.batched_cholesky_solve.launches - before
        return out

    reset_all_counts()
    riccati.batched_cholesky_solve = capture
    wp._uniform_candidate_sweep = counted_sweep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = wp.solve_time_optimal(params, course, solver_config=cut,
                                    warm_start_config=cut, cuda_chol=True,
                                    device="cuda", **PROBE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        riccati.batched_cholesky_solve = real_kernel
        wp._uniform_candidate_sweep = real_sweep
    n_chol = cholesky.batched_cholesky_solve.launches
    n = PROBE["num_nodes"]
    want = n * cut.max_al_iters * cut.max_inner_iters
    C = PROBE["n_candidates"] + 1
    rec = {"wall_s": wall, "cholesky_launches": n_chol,
           "cholesky_launches_in_sweep": in_sweep.get("launches"),
           "expected": want, "chol_fallbacks": riccati.read_fallbacks(),
           "feasible": res["feasible"].tolist(),
           "max_miss_m": res["dmins"].max(axis=1).round(2).tolist(),
           "defects": [float(d) for d in res["defects"]],
           "total_time": res["total_time"]}
    print(f"time-optimal: probe course, N={n}, {PROBE['n_candidates']} "
          "candidates + the nominal, 1 x 3, Cholesky kernel route: "
          + json.dumps(rec), flush=True)
    check(in_sweep.get("launches") == want and n_chol == want,
          f"time-optimal: {n_chol} Cholesky launches, {in_sweep} in the "
          f"sweep, expected {want} there ({n} per backward pass) and none "
          "in the B=1 solves")
    shapes = {k: tuple(np.shape(res[k])) for k in (
        "feasible", "dmins", "candidate_times", "candidate_dts", "defects")}
    check(shapes == {"feasible": (C,), "dmins": (C, 2),
                     "candidate_times": (C,), "candidate_dts": (C,),
                     "defects": (C,)}, f"time-optimal: shapes {shapes}")
    launches["planners_candidate_sweep"] = n_chol
    records["time_optimal"] = rec
    check(bool(first), "the candidate sweep never reached the kernel")
    return launches, records, first[0]


QUAD_TARGET = [30.0, 20.0, -15.0]   # examples/time_optimal_quad.py's goal
QUAD_BUDGET = (1, 3)     # the example's 6 x 25, cut


QUAD_N = 60
QUAD_SCALES = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _quad_solve(scales, al_iters, inner_iters, capture_first=None):
    """``solve_quadrotor_time_optimal`` at N=60 on the Cholesky kernel
    route; ``capture_first`` (a dict) gathers each m's first N systems
    as the sweep hands them to the kernel.  Returns (result, wall)."""
    import torch

    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control.quadrotor import (
        solve_quadrotor_time_optimal)
    from aircraft_tpu_torch.solvers import riccati

    cut = SolverConfig(max_al_iters=al_iters, max_inner_iters=inner_iters,
                       hessian="gauss_newton")
    real_kernel = riccati.batched_cholesky_solve

    def capture(a, rhs):
        got = capture_first.setdefault(a.shape[-1], [])
        if len(got) < QUAD_N:
            got.append((a.clone(), rhs.clone()))
        return real_kernel(a, rhs)

    if capture_first is not None:
        riccati.batched_cholesky_solve = capture
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_quadrotor_time_optimal(
            QUAD_TARGET, num_nodes=QUAD_N, scales=scales, solver_config=cut,
            cuda_chol=True, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        riccati.batched_cholesky_solve = real_kernel


def quadrotor_holds():
    """The batched-Cholesky kernel at the quadrotor's shapes, one system
    per knot (k = 1 + n = 14): every knot's system of the first backward
    pass of a fixed-time solve (m = 4) and of the free-time refinement
    (m = 5), from a 1 x 1 solve at the nominal scale, each held against
    the plain version as one batch of 60 (at m = 5 the free-time cost's
    indefinite knots non-finite in both, the reference's fallback rule)
    and timed beside one library factor-and-solve.  Returns holds by m."""
    import torch

    first = {}
    _quad_solve((1.0,), 1, 1, capture_first=first)
    holds = {}
    for m in (4, 5):
        check(len(first.get(m, ())) == QUAD_N,
              f"quadrotor: {len(first.get(m, ()))} m={m} systems captured")
        a = torch.cat([x for x, _ in first[m]]).contiguous()
        rhs = torch.cat([r for _, r in first[m]]).contiguous()
        check(tuple(a.shape) == (QUAD_N, m, m)
              and tuple(rhs.shape) == (QUAD_N, m, 14),
              f"quadrotor: m={m} systems {tuple(a.shape)}, {tuple(rhs.shape)}")
        label = (f"quadrotor first backward pass, every knot's system "
                 f"(B={QUAD_N}, m={m}, k=14)")
        if m == 4:
            holds[m] = hold_cholesky(a, rhs, label, timing_reps=20)
        else:
            # the free-time stage cost W·ν²·|u|² has an indefinite Hessian
            # in (u, ν): its knots may fall back, by the reference's rule
            _, bad, worst = hold_cholesky_indefinite(a, rhs, label)
            holds[m] = {"rel_err": worst, "nonfinite_share": bad,
                        **cholesky_times(a, rhs, label, 20)}
    return holds


def quadrotor_path():
    """The quadrotor's time-optimal solve at its full width (N=60, the six
    scales of the ladder, then the two free-time refinements) with every
    Quu solve on the Cholesky kernel route, cut to 1 x 3: exactly N
    launches per backward pass of its eight solves (m = 4 in the ladder,
    m = 5 in the refinements).  The fallbacks are printed: the m = 5
    solves take them by design.  Returns (launches, record)."""
    import torch

    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati

    reset_all_counts()
    out, wall = _quad_solve(QUAD_SCALES, *QUAD_BUDGET)
    n_chol = cholesky.batched_cholesky_solve.launches
    solves = len(QUAD_SCALES) + 2
    want = QUAD_N * solves * QUAD_BUDGET[0] * QUAD_BUDGET[1]
    sol = out["solution"]
    rec = {"wall_s": wall, "cholesky_launches": n_chol, "expected": want,
           "chol_fallbacks": riccati.read_fallbacks(),
           "feasible": [r["feasible"] for r in out["candidates"]],
           "dt_uniform": out["dt_uniform"], "T_final": out["T_final"],
           "T_variable": out["T_variable"],
           "finite": bool(torch.isfinite(sol.xs).all()
                          and torch.isfinite(sol.us).all())}
    print(f"quadrotor: time-optimal N={QUAD_N}, {len(QUAD_SCALES)} scales + "
          f"2 free-time solves, {QUAD_BUDGET[0]} x {QUAD_BUDGET[1]}, "
          "Cholesky kernel route: " + json.dumps(rec), flush=True)
    check(n_chol == want, f"quadrotor: {n_chol} Cholesky launches, expected "
          f"{want} ({QUAD_N} per backward pass of {solves} solves)")
    check(rec["finite"] and len(rec["feasible"]) == len(QUAD_SCALES),
          f"quadrotor: {rec}")
    return {"quadrotor_time_optimal": n_chol}, rec


CONTROL_TOL = 2e-4   # card against CPU, of 1 + |ref|


def control_pieces():
    """The estimator, the LQR and the stability analysis, each on the card
    against the same code on the CPU, within CONTROL_TOL (1 + |ref|): one
    ``estimate_wind`` (W=20 measurements flown on the CPU in a known
    wind), one LQR design about the default-aero glider's 50 m/s trim
    with one ``closed_loop_step`` of 8 perturbed states, and one
    ``discrete_stability_analysis`` (25 perturbed states, the 20-point dt
    sweep; eigenvalues matched to their nearest partner).  No kernel of
    the port runs here."""
    import numpy as np
    import torch
    from dataclasses import replace

    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.mhe import estimate_wind
    from aircraft_tpu_torch.dynamics import aircraft as ac
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.solvers import integrators, lqr
    from aircraft_tpu_torch.solvers import trim as trim_mod

    def held(label, out, ref):
        out = np.asarray(out, np.complex128 if np.iscomplexobj(out)
                         else np.float64)
        ref = np.asarray(ref, out.dtype)
        err = float(np.max(np.abs(out - ref) / (1.0 + np.abs(ref))))
        print(f"control on the card: {label}: max err over (1 + |ref|) "
              f"{err:.3e} (tol {CONTROL_TOL})", flush=True)
        check(err <= CONTROL_TOL, f"{label}: card and CPU differ by {err}")
        return err

    cfg = glider_config()
    cpu = AircraftParams.from_config(cfg.aircraft, device="cpu")
    wind = torch.tensor([4.0, -3.0, 0.5])
    step = integrators.make_step_fn(
        cpu, substeps=2, normalize="step",
        derivative_fn=lambda x, u: ac.state_derivative(cpu, x, u, wind=wind))
    gen = torch.Generator().manual_seed(0)
    us = torch.zeros(20, 7)
    us[:, :3] = 2.0 * torch.rand((20, 3), generator=gen) - 1.0
    xs = [torch.tensor(cfg.waypoints.initial_state, dtype=torch.float32)]
    for u in us:
        xs.append(step(xs[-1], u, 0.02))
    xs = torch.stack(xs)
    errs = {}
    t0 = time.perf_counter()
    card = estimate_wind(cpu, xs.cuda(), us.cuda(), 0.02, 2, 8, device="cuda")
    ref = estimate_wind(cpu, xs, us, 0.02, 2, 8, device="cpu")
    errs["estimate_wind"] = held("estimate_wind (W=20)", card.wind.cpu(),
                                 ref.wind)
    print(f"estimate_wind: card {card.wind.cpu().numpy().round(5).tolist()}, "
          f"CPU {ref.wind.numpy().round(5).tolist()}, true "
          f"{wind.numpy().tolist()}", flush=True)

    trim_p = AircraftParams.from_config(cfg.aircraft, com_in_control=True,
                                        device="cpu")
    res = trim_mod.multistart_trim(trim_p, n_starts=16, target_airspeed=50.0,
                                   generator=torch.Generator().manual_seed(0))
    check(float(res.residual) < 1e-2, f"trim residual {float(res.residual)}")
    plant = replace(cpu, com=res.control[7:10].clone())
    x_ref, u_ref = res.state, res.control[:7]
    c_card = lqr.design(plant, x_ref, u_ref, dt=0.01, substeps=2,
                        device="cuda")
    c_cpu = lqr.design(plant, x_ref, u_ref, dt=0.01, substeps=2, device="cpu")
    errs["lqr_gain"] = held("LQR gain K (12 x 7)", c_card.K.cpu(), c_cpu.K)
    xi = 0.05 * torch.randn((8, 12), generator=gen)
    x0 = lqr.inject(x_ref, xi)
    x1_card, _ = lqr.closed_loop_step(plant.to("cuda"), c_card, 0.01,
                                      substeps=2)(x0.cuda())
    x1_cpu, _ = lqr.closed_loop_step(plant, c_cpu, 0.01, substeps=2)(x0)
    errs["closed_loop_step"] = held("closed_loop_step (8 states)",
                                    x1_card.cpu(), x1_cpu)

    r_card = trim_mod.discrete_stability_analysis(
        trim_p, res.state, res.control, dt=0.01, n_perturb=25, device="cuda")
    r_cpu = trim_mod.discrete_stability_analysis(
        trim_p, res.state, res.control, dt=0.01, n_perturb=25, device="cpu")
    pair = np.stack([e_card[np.argmin(np.abs(e_card[None, :] - e[:, None]),
                                      axis=1)]
                     for e_card, e in zip(r_card.eigenvalues,
                                          r_cpu.eigenvalues)])
    errs["stability_eigenvalues"] = held(
        "discrete_stability_analysis eigenvalues (25 x 13)", pair,
        r_cpu.eigenvalues)
    errs["stability_dt_radius"] = held(
        "discrete_stability_analysis dt-sweep spectral radius (20)",
        r_card.dt_spectral_radius, r_cpu.dt_spectral_radius)
    print(f"control on the card: {time.perf_counter() - t0:.1f} s; spectral "
          f"radius {r_card.spectral_radius.min():.5f}.."
          f"{r_card.spectral_radius.max():.5f}", flush=True)
    return errs


# the learning phase: the aero dataset, its cuts and tolerances
LEARN_SAMPLES = 131072     # the aero dataset the smoke writes
LEARN_WINDOW_B = 256       # the trained MLP's window: the headline fleet
LEARN_EPOCHS = 20          # fit_surrogates' 150 epochs, cut
LEARN_TOL = 1e-4           # one step card against CPU, of 1 + |ref|
LEARN_RUN_TOL = 1e-3       # a few epochs or iterations, of 1 + |ref|
BN_SAMPLES, BN_HIDDEN, BN_EPOCHS, BN_BATCH = 4096, (64, 64), 3, 256
GP_N, GP_ITERS = 256, 50
DDPG_UPDATES, DDPG_BATCHES, DDPG_FILL = 200, (64, 256), 10000
TRAIN_DDPG = (60, 150)     # 10 episodes past the curriculum's first stage
MLP_TRACE_SAMPLES = 5689   # train_mlp's split: 5,121 to train, 10 batches
DDPG_TRACE = 20            # traced DDPG updates at batch 64
NLP_QUAD = dict(N=20, dt=0.1, target=(2.0, 1.0, -4.0), maxiter=250)


def learn_held(label, out, ref, tol, path="learning"):
    """max |out - ref| / (1 + |ref|) printed and held within tol."""
    import numpy as np

    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    check(out.shape == ref.shape, f"{label}: shapes {out.shape}, {ref.shape}")
    err = float(np.max(np.abs(out - ref) / (1.0 + np.abs(ref))))
    print(f"{path} on the card: {label}: max err over (1 + |ref|) "
          f"{err:.3e} (tol {tol})", flush=True)
    check(err <= tol, f"{label}: card and CPU differ by {err}")
    return err


def learning_trace(label, fn, steps):
    """fn (which takes ``steps`` train steps) in a torch.profiler trace,
    after one untraced call: its kernel launches and device records per
    step, the wall per step under the trace (which adds its own cost to
    each launch) and the device's busy share over that wall (None where
    the profiler saw no device time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum("LaunchKernel" in e.name for e in events
                   if e.device_type != torch.autograd.DeviceType.CUDA)
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    out = {"launches_per_step": launches / steps,
           "device_records_per_step": len(on_device) / steps,
           "traced_ms_per_step": wall * 1e3 / steps,
           "device_busy": device_us * 1e-6 / wall if device_us > 0 else None}
    print(f"{label}: traced {json.dumps(out)}", flush=True)
    return out


def learning_dataset(path):
    """LEARN_SAMPLES aero samples written as an aero CSV at ``path``:
    inputs input_mean + input_std·N(0, 1) (numpy seed 0) with the
    scalers of data/networks/mlp.npz, the spread of the data it was
    trained on; labels the shipped MLP evaluated in float64 on the host.
    Returns (x, y) as float32."""
    import numpy as np

    from aircraft_tpu_torch.config import NETWORKPATH
    from aircraft_tpu_torch.surrogates.preprocess import (INPUT_COLS,
                                                          OUTPUT_COLS)

    with np.load(NETWORKPATH / "mlp.npz") as d:
        w = {k: d[k].astype(np.float64) for k in d.files}
    rng = np.random.default_rng(0)
    x = (w["input_mean"] + w["input_std"] * rng.standard_normal(
        (LEARN_SAMPLES, 5))).astype(np.float32)
    h = (x.astype(np.float64) - w["input_mean"]) / w["input_std"]
    h = np.tanh((h @ w["w0"] + w["b0"]) @ w["w1"] + w["b1"])
    y = ((h @ w["w2"] + w["b2"]) * w["output_std"]
         + w["output_mean"]).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, np.concatenate([x, y], axis=1), fmt="%.9g",
               delimiter=",", header=",".join(INPUT_COLS + OUTPUT_COLS),
               comments="")
    return x, y


def learning_trained_window(mlp_path, device="cuda"):
    """The trained MLP in the serving path: the headline window problem
    (B=256, N=50, the course track at the shipped plant's glide) on the
    trained plant, both window kernels held against their plain versions
    at its expansion point (hold_kernels), then one fused window solve
    with every count reset just before it: each window kernel launched
    once per inner iteration.  Returns (hold, counts)."""
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.kernels import window as win
    from aircraft_tpu_torch.solvers import ocp as ocp_mod
    from aircraft_tpu_torch.solvers.fused import make_fused_solver

    coeff = load_mlp(mlp_path, device=device)
    _, params, ocp, track, v_ref, spec = bench.build_problem(
        device, coeff=coeff, glide=mlp_glide(device))
    config = bench.headline_config()
    N = bench.N_HORIZON
    B = LEARN_WINDOW_B
    z0s, trim = bench.fleet_states(params, track, B, v_ref)
    w0 = ocp.control_unsquash(trim.control[:7])
    us = w0.reshape(1, 1, 7).expand(B, N, 7).contiguous()
    op = win.make_window_operands(spec, N, alphas=win.line_search_alphas(
        config.line_search_steps), device=device)
    hold = hold_kernels(op, window_inputs(ocp, spec, z0s, us, config, N),
                        f"trained MLP B={B} N={N}")
    solve = make_fused_solver(ocp, spec, N, config)
    reset_all_counts()
    t0 = time.perf_counter()
    sols = solve(z0s, us)
    sols.cost.cpu()
    wall = time.perf_counter() - t0
    counts = check_window_launches(
        "trained MLP window", 1, config.max_al_iters * config.max_inner_iters)
    summary = bench.window_summary(sols.violation.cpu().numpy(),
                                   sols.cost.cpu().numpy())
    print(f"trained MLP window: {wall:.2f} s, " + json.dumps(summary),
          flush=True)
    check(bool(torch.isfinite(sols.cost).all()),
          "trained MLP window: a non-finite cost")
    return hold, counts


def learning_path(device="cuda"):
    """The learning tools on the card: surrogate fitting and training
    (examples/fit_surrogates.py on the smoke's aero CSV), the trained MLP
    flying a window on the window kernels, the batch-norm MLP and the GP,
    the DDPG agent's timed, traced and held updates, and the NLP oracle on the quadrotor; every piece held on the card against the
    same code on the CPU.  Returns (record, trained-window launches).
    ``device="cpu"`` rehearses the control flow (each hold then compares
    the CPU with itself)."""
    import numpy as np
    import torch

    from aircraft_tpu_torch.control.quadrotor import build_quadrotor_ocp
    from aircraft_tpu_torch.dynamics.coefficients import MLP_KEYS, MLPCoeffParams
    from aircraft_tpu_torch.examples import fit_surrogates
    from aircraft_tpu_torch.kernels._build import BUILD_DIR
    from aircraft_tpu_torch.rl import ddpg
    from aircraft_tpu_torch.solvers.reference_nlp import solve_reference_nlp
    from aircraft_tpu_torch.surrogates import extras, load_aero_csv, train_mlp

    out = BUILD_DIR / "chip_smoke_learning"
    rec = {}
    t0 = time.perf_counter()
    x, y = learning_dataset(out / "aero.csv")
    xr, yr = load_aero_csv(out / "aero.csv")
    check(np.array_equal(xr, x) and np.array_equal(yr, y),
          "load_aero_csv did not read back the CSV written")
    print(f"learning: dataset of {x.shape[0]} samples written and read back "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    fit = fit_surrogates.run(out / "aero.csv", out / "networks",
                             epochs=LEARN_EPOCHS, device=device,
                             log=lambda line: print(line, flush=True))
    numbers = (fit["linear_rmse"] + fit["poly_rmse"] + fit["mlp_val_history"]
               + [fit["mlp_train_loss"], fit["mlp_val_loss"]])
    check(all(math.isfinite(v) for v in numbers),
          "fit_surrogates: a non-finite RMSE or loss")
    check(fit["mlp_val_loss"] < fit["mlp_val_history"][0],
          f"fit_surrogates: validation loss {fit['mlp_val_loss']} not below "
          f"its first epoch's {fit['mlp_val_history'][0]}")
    rec["fit"] = {k: fit[k] for k in (
        "linear_rmse", "poly_rmse", "mlp_train_loss", "mlp_val_loss",
        "mlp_epochs", "mlp_steps", "mlp_steps_per_s", "mlp_wall_s")}
    rec["fit"]["mlp_first_val_loss"] = fit["mlp_val_history"][0]

    # one train_mlp step: 569 samples, 513 to train, one batch of 512
    init = MLPCoeffParams.init(torch.Generator().manual_seed(1), device="cpu")
    step = {dev: train_mlp(x[:569], y[:569], init=init, epochs=1, seed=1,
                           device=dev) for dev in (device, "cpu")}
    rec["train_step_err"] = max(
        learn_held(f"one train_mlp step {k}",
                   getattr(step[device].params, k).cpu(),
                   getattr(step["cpu"].params, k), LEARN_TOL)
        for k in MLP_KEYS)
    learn_held("one train_mlp step loss", step[device].train_loss,
               step["cpu"].train_loss, LEARN_TOL)
    rec["mlp_trace"] = learning_trace(
        "train_mlp, one epoch of 10 steps at batch 512 with its validation",
        lambda: train_mlp(x[:MLP_TRACE_SAMPLES], y[:MLP_TRACE_SAMPLES],
                          init=init, epochs=1, seed=1, device=device), 10)

    hold, counts = learning_trained_window(out / "networks" / "mlp.npz",
                                           device)
    rec["trained_window_hold"] = {k: hold[k] for k in ("backward_err",
                                                       "forward_err")}

    # the batch-norm MLP: the standardised inputs, a few epochs
    xs = (x[:BN_SAMPLES] - x.mean(0)) / x.std(0)
    ys = (y[:BN_SAMPLES] - y.mean(0)) / y.std(0)
    bn_init = extras.BatchNormMLP.init(torch.Generator().manual_seed(0),
                                       [5, *BN_HIDDEN, 6], device="cpu")
    t1 = time.perf_counter()
    bn = {dev: extras.train_batchnorm_mlp(
        xs, ys, hidden=BN_HIDDEN, epochs=BN_EPOCHS, batch_size=BN_BATCH,
        init=bn_init, device=dev) for dev in (device, "cpu")}
    # the hidden biases feed a batch norm, whose batch mean removes them:
    # their gradients are rounding noise that Adam scales to full steps,
    # so the trained nets are held through their train-mode outputs
    xb = torch.as_tensor(xs[:BN_BATCH])
    bn_out = {dev: extras.batchnorm_mlp_apply(bn[dev][0], xb.to(dev),
                                              train=True)[0].cpu()
              for dev in bn}
    rec["batchnorm_err"] = learn_held(
        f"batch-norm MLP {BN_HIDDEN}, {BN_EPOCHS} epochs: train-mode outputs",
        bn_out[device], bn_out["cpu"], LEARN_RUN_TOL)
    learn_held("batch-norm MLP last loss", bn[device][1], bn["cpu"][1],
               LEARN_RUN_TOL)
    print(f"batch-norm MLP: both devices {time.perf_counter() - t1:.1f} s",
          flush=True)

    # the GP on the first GP_N standardised samples, one output (CZ)
    t1 = time.perf_counter()
    gp = {dev: extras.GPSurrogate.fit(xs[:GP_N], ys[:GP_N, 2], iters=GP_ITERS,
                                      device=dev) for dev in (device, "cpu")}
    pred = {dev: [t.cpu() for t in gp[dev].predict(xs[GP_N:GP_N + 64])]
            for dev in gp}
    rec["gp_err"] = max(
        learn_held(f"GP n={GP_N}, {GP_ITERS} iterations: hyperparameters",
                   torch.cat([t.reshape(-1).cpu()
                              for t in gp[device].params]),
                   torch.cat([t.reshape(-1) for t in gp["cpu"].params]),
                   LEARN_RUN_TOL),
        learn_held("GP predictive mean", pred[device][0], pred["cpu"][0],
                   LEARN_RUN_TOL),
        learn_held("GP predictive std", pred[device][1], pred["cpu"][1],
                   LEARN_RUN_TOL))
    print(f"GP: both devices {time.perf_counter() - t1:.1f} s", flush=True)

    # DDPG: the default agent (obs 13, act 3, hidden (256, 128))
    rng = np.random.default_rng(0)
    buf = ddpg.ReplayBuffer(DDPG_FILL, 13, 3, device=device)
    for _ in range(DDPG_FILL):
        buf.add(rng.normal(0, 1, 13), rng.uniform(-5, 5, 3), rng.normal(),
                rng.normal(0, 1, 13), rng.random() < 0.05)
    agent = ddpg.DDPGAgent(13, 3, seed=0, device=device)
    rec["ddpg_updates_per_s"] = {}
    for batch in DDPG_BATCHES:
        agent.train_step(buf.sample(rng, batch))
        t1 = time.perf_counter()
        for _ in range(DDPG_UPDATES):
            losses = agent.train_step(buf.sample(rng, batch))
        rate = DDPG_UPDATES / (time.perf_counter() - t1)
        check(all(math.isfinite(v) for v in losses),
              f"DDPG at batch {batch}: non-finite losses {losses}")
        rec["ddpg_updates_per_s"][batch] = rate
        print(f"DDPG: {DDPG_UPDATES} updates at batch {batch}: {rate:.1f} "
              f"updates/s (losses {losses})", flush=True)
    rec["ddpg_trace"] = learning_trace(
        f"DDPG, {DDPG_TRACE} updates at batch 64, each with its sample",
        lambda: [agent.train_step(buf.sample(rng, 64))
                 for _ in range(DDPG_TRACE)], DDPG_TRACE)
    cpu_agent = ddpg.DDPGAgent(13, 3, seed=1, device="cpu")
    card_agent = ddpg.DDPGAgent(13, 3, params=cpu_agent.params,
                                device=device)
    b = buf.sample(rng, 64)
    l_cpu = cpu_agent.train_step(ddpg.Transition(*(t.cpu() for t in b)))
    l_card = card_agent.train_step(b)
    nets = ("actor", "critic", "target_actor", "target_critic")
    rec["ddpg_update_err"] = max([learn_held(
        f"one DDPG update: {net}",
        torch.cat([t.detach().reshape(-1).cpu() for t in getattr(
            card_agent.params, net).tensors()]),
        torch.cat([t.detach().reshape(-1) for t in getattr(
            cpu_agent.params, net).tensors()]), LEARN_TOL) for net in nets]
        + [learn_held("one DDPG update: losses", l_card, l_cpu, LEARN_TOL)])

    # the NLP oracle on the quadrotor control problem
    q = NLP_QUAD
    x0 = np.zeros(13, np.float32)
    x0[6] = 1.0
    us0 = np.full((q["N"], 4), 9.81 / 4.0, np.float32)
    nlp, walls = {}, {}
    for dev in (device, "cpu"):
        t1 = time.perf_counter()
        nlp[dev] = solve_reference_nlp(
            build_quadrotor_ocp(q["target"], dt=q["dt"], device=dev), x0, us0,
            maxiter=q["maxiter"], device=dev)
        walls[dev] = time.perf_counter() - t1
        check(nlp[dev].success, f"NLP oracle on {dev}: {nlp[dev].message}")
    max_du = float(np.abs(nlp[device].us - nlp["cpu"].us).max())
    rel_cost = abs(nlp[device].cost - nlp["cpu"].cost) / abs(nlp["cpu"].cost)
    print(f"NLP oracle, quadrotor N={q['N']} dt={q['dt']}: card "
          f"{walls[device]:.1f} s ({nlp[device].nit} iterations, violation "
          f"{nlp[device].violation:.2e}), CPU {walls['cpu']:.1f} s "
          f"({nlp['cpu'].nit}); max |du| {max_du:.3e} (tol 1e-4), relative "
          f"cost {rel_cost:.3e} (tol 1e-9)", flush=True)
    check(max_du < 1e-4 and rel_cost < 1e-9,
          "NLP oracle: card and CPU solutions differ")
    rec["nlp"] = {"wall_s_card": walls[device], "wall_s_cpu": walls["cpu"],
                  "nit": nlp[device].nit, "max_du": max_du,
                  "rel_cost": rel_cost}
    print("learning record: " + json.dumps(rec), flush=True)
    return rec, counts


def learning_train_ddpg(device="cuda"):
    """examples/train_ddpg.py on the card for TRAIN_DDPG episodes: finite
    returns, the curriculum past its first stage, at least one update.
    Run in the side process: its B=1 plant steps are host-bound."""
    from aircraft_tpu_torch.examples import train_ddpg
    from aircraft_tpu_torch.rl import ddpg

    ep = train_ddpg.run(*TRAIN_DDPG, device=device, log=lambda line: None)
    print(f"train_ddpg: {ep['episodes']} episodes, {ep['env_steps']} env "
          f"steps, {ep['updates']} updates, stage {ep['stage']}, "
          f"{ep['wall_s']} s", flush=True)
    check(all(math.isfinite(v) for v in ep["returns"]),
          f"train_ddpg: non-finite returns {ep['returns']}")
    check(ep["updates"] > 0 and ep["stage"] != ddpg.DEFAULT_CURRICULUM[0].name,
          f"train_ddpg: {ep['updates']} updates, stage {ep['stage']}")
    return {k: ep[k] for k in ("episodes", "env_steps", "updates", "stage",
                               "wall_s")}


TOOL_TOL = 2e-4            # card against CPU, of 1 + |ref|
TOOL_PATHS = 4096          # random Dubins problems, native against Python
TOOL_OPENLOOP_HELD = 50    # knots of openloop_sim held card against CPU
TOOL_RACING = (1, 3)       # waypoint_racing's 6 x 20 (and warm 1 x 30), cut
TOOL_COURSE_WINDOWS = 4    # full_course's whole course, cut


def tooling_path(device="cuda"):
    """The tooling remainders in the main process (profiler traces taken
    in the side process have lost records), each held against the same
    code on the CPU (``TOOL_TOL``): entry()'s flagship step at B=256
    (timed by ``timed_jit_call``); check_jacobian and a profile_trace
    holding a kernel record; the native batch Dubins against its Python
    path on TOOL_PATHS problems; full_course cut to TOOL_COURSE_WINDOWS
    windows (each window kernel once per inner iteration of every window
    solve).  The other examples run in the side process
    (``examples_path``).  Returns (record, launches by path)."""
    import numpy as np
    import torch

    from aircraft_tpu_torch import entry, native
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dubins.dubins2d import WORDS, shortest_path
    from aircraft_tpu_torch.dynamics.aircraft import (AircraftParams,
                                                      state_derivative)
    from aircraft_tpu_torch.examples import full_course
    from aircraft_tpu_torch.kernels._build import BUILD_DIR
    from aircraft_tpu_torch.observability import (check_jacobian,
                                                  profile_trace,
                                                  timed_jit_call)

    out_dir = BUILD_DIR / "chip_smoke_tooling"
    rec, launches = {}, {}
    held = lambda label, a, b: learn_held(label, a, b, TOOL_TOL, "tooling")
    sync = lambda: torch.cuda.synchronize() if device == "cuda" else None

    # entry(): the flagship step, card against CPU
    fn, (x0, us) = entry.entry(device)
    run = timed_jit_call(fn, x0, us, reps=10)
    fn_c, (x0_c, us_c) = entry.entry("cpu")
    held("entry() step B=256", run.result.cpu().numpy(),
         fn_c(x0_c, us_c).numpy())
    rec["entry"] = {"first_call_excess_s": run.compile_s,
                    "step_s": run.execute_s}
    print(f"tooling: entry() B=256 step {run.execute_s * 1e3:.3f} ms warm, "
          f"first call {run.compile_s:.3f} s above it", flush=True)

    # check_jacobian and profile_trace
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=device)
    xj = torch.tensor(cfg.waypoints.initial_state, dtype=torch.float32,
                      device=device)
    uj = torch.zeros(7, device=device)
    jac = check_jacobian(lambda xx: state_derivative(params, xx, uj), xj)
    print(f"tooling: check_jacobian of the plant on the card: "
          f"{json.dumps(jac)}", flush=True)
    check(jac["ok"], f"check_jacobian: {jac}")
    with profile_trace(out_dir / "trace") as tr:
        fn(x0, us)
        sync()
    n_rec = tr.kernel_records()
    print(f"tooling: profile_trace wrote {tr.path.name} with {n_rec} kernel "
          "records", flush=True)
    check(device != "cuda" or n_rec > 0, "profile_trace: no kernel record")
    rec["check_jacobian"], rec["trace_kernel_records"] = jac, n_rec

    # the native batch Dubins against its Python path
    check(native.native_available(), "the native Dubins engine did not build")
    rng = np.random.default_rng(0)
    qis = np.column_stack([rng.uniform(-50, 50, TOOL_PATHS),
                           rng.uniform(-50, 50, TOOL_PATHS),
                           rng.uniform(0, 2 * np.pi, TOOL_PATHS)])
    qfs = np.column_stack([rng.uniform(-50, 50, TOOL_PATHS),
                           rng.uniform(-50, 50, TOOL_PATHS),
                           rng.uniform(0, 2 * np.pi, TOOL_PATHS)])
    rhos = rng.uniform(1.0, 60.0, TOOL_PATHS)
    t0 = time.perf_counter()
    paths, ok = native.shortest_batch(qis, qfs, rhos)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = np.zeros_like(paths)
    for b in range(TOOL_PATHS):
        p = shortest_path(qis[b], qfs[b], float(rhos[b]))
        py[b] = [WORDS.index(p.word), *p.params, p.length]
    py_s = time.perf_counter() - t0
    d_err = float(np.abs(paths - py).max())
    print(f"tooling: native Dubins {TOOL_PATHS} paths in {native_s * 1e3:.2f} "
          f"ms, Python {py_s:.2f} s, max |difference| {d_err:.3e}",
          flush=True)
    check(ok.all() and d_err <= 1e-9, f"native Dubins: {d_err}, "
          f"{int((~ok).sum())} not found")
    rec["dubins_max_abs_diff"] = d_err

    # full_course, cut
    reset_all_counts()
    t0 = time.perf_counter()
    with CountWindowSolves() as solves:
        report, flight = full_course.run(max_windows=TOOL_COURSE_WINDOWS,
                                         device=device, verbose=False)
    course_s = time.perf_counter() - t0
    print(f"tooling: full_course cut to {TOOL_COURSE_WINDOWS} windows in "
          f"{course_s:.1f} s: " + json.dumps({k: report[k] for k in (
              "windows", "retries", "abort_reason", "misses_m",
              "p50_window_wall_s")}), flush=True)
    check(report["windows"] == TOOL_COURSE_WINDOWS
          and report["abort_reason"] is None
          and bool(np.isfinite(flight["states"]).all()),
          f"full_course: {report}")
    if device == "cuda":
        launches["full_course"] = check_window_launches(
            "full_course (6 candidates per window as one batch)", solves.n,
            4 * 20)
    rec["full_course"] = {"wall_s": course_s, "windows": report["windows"]}
    return rec, launches


def examples_path(device="cuda"):
    """The last examples in the side process, each held against the same
    code on the CPU (``TOOL_TOL``): openloop_sim at its full 500 steps
    (its first TOOL_OPENLOOP_HELD knots held, the whole difference
    printed), aero_polars (71 α, default and MLP aero) and the plotter's
    plant panels on its flight (with and without wind), its h5 round trip
    and dashboard where h5py and matplotlib are installed;
    waypoint_racing --cuda-chol cut to TOOL_RACING (exactly N Cholesky
    launches per backward pass).  Returns (record, launches by path)."""
    import numpy as np

    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.examples import openloop_sim, waypoint_racing
    from aircraft_tpu_torch.kernels._build import BUILD_DIR
    from aircraft_tpu_torch.plotting import TrajectoryPlotter, aero_polars
    from aircraft_tpu_torch.utils import TrajectoryData, missing_packages

    out_dir = BUILD_DIR / "chip_smoke_tooling"
    out_dir.mkdir(parents=True, exist_ok=True)
    rec, launches = {}, {}
    held = lambda label, a, b: learn_held(label, a, b, TOOL_TOL, "tooling")
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=device)

    # openloop_sim at its full length, card against CPU from the card's trim
    t0 = time.perf_counter()
    ol = openloop_sim.run(device=device)
    ol_s = time.perf_counter() - t0
    ol_c = openloop_sim.run(u_trim=ol["u_trim"], device="cpu")
    xs, xs_c = ol["xs"], ol_c["xs"]
    check(np.isfinite(xs).all(), f"openloop_sim: first NaN {ol['first_nan']}")
    held(f"openloop_sim first {TOOL_OPENLOOP_HELD} knots",
         xs[:TOOL_OPENLOOP_HELD + 1], xs_c[:TOOL_OPENLOOP_HELD + 1])
    whole = float(np.max(np.abs(xs - xs_c) / (1.0 + np.abs(xs_c))))
    print(f"tooling: openloop_sim {xs.shape[0] - 1} steps in {ol_s:.1f} s "
          f"(trim {ol['trim_s']:.1f} s, rollout {ol['rollout_s']:.1f} s); "
          f"card against CPU over the whole flight: max err over (1 + |ref|)"
          f" {whole:.3e} (printed, not held: open-loop rounding grows)",
          flush=True)
    rec["openloop"] = {"wall_s": ol_s, "whole_err": whole}

    # the numbers behind the panels, card against CPU
    mlp = load_mlp(device=device)
    for label, coeff in (("default", None), ("mlp", mlp)):
        pc = AircraftParams.from_config(cfg.aircraft, coeff=coeff,
                                        device=device)
        alphas = np.linspace(-15.0, 20.0, 71)
        held(f"aero_polars {label} 71 alpha", aero_polars(pc, alphas),
             aero_polars(pc.to("cpu"), alphas))
    for wind in (None, [5.0, -2.0, 1.0]):
        card = TrajectoryPlotter(params=params, wind=wind)._plant_panels(
            xs, ol["us"])
        host = TrajectoryPlotter(params=params.to("cpu"), wind=wind)\
            ._plant_panels(xs, ol["us"])
        for name, a, b in zip(("alpha", "beta", "forces", "moments"), card,
                              host):
            held(f"plant panels {name} wind {wind}", a, b)

    missing = missing_packages("h5py", "matplotlib")
    if missing:
        print(f"tooling: not installed on this host: {', '.join(missing)}; "
              "skipped " + ", ".join({"h5py": "the h5 round trip",
                                      "matplotlib": "the dashboards"}[m]
                                     for m in missing), flush=True)
    data = TrajectoryData(state=xs, control=ol["us"],
                          time=np.arange(xs.shape[0]) * openloop_sim.DT)
    if "h5py" not in missing:
        h5 = out_dir / "openloop.h5"
        h5.unlink(missing_ok=True)
        data.save_h5(h5)
        back = TrajectoryData.load_h5(h5)
        check(np.array_equal(back.state, xs), "h5 round trip")
    if "matplotlib" not in missing:
        TrajectoryPlotter(params=params).save(data, out_dir / "openloop.png")

    # waypoint_racing on the Cholesky kernel, cut
    reset_all_counts()
    t0 = time.perf_counter()
    race, _ = waypoint_racing.run(al_iters=TOOL_RACING[0],
                                  inner_iters=TOOL_RACING[1],
                                  warm_iters=TOOL_RACING, cuda_chol=True,
                                  device=device)
    race_s = time.perf_counter() - t0
    n = race["num_nodes"]
    want = n * TOOL_RACING[0] * TOOL_RACING[1]
    print(f"tooling: waypoint_racing --cuda-chol at {TOOL_RACING[0]} x "
          f"{TOOL_RACING[1]} in {race_s:.1f} s: "
          + json.dumps({k: race[k] for k in (
              "closest_approaches", "cost", "violation", "finite",
              "cholesky_launches", "chol_fallbacks", "max_real_eig")}),
          flush=True)
    check(race["finite"], "waypoint_racing: non-finite trajectory")
    if device == "cuda":
        check(race["cholesky_launches"] == want,
              f"waypoint_racing: {race['cholesky_launches']} Cholesky "
              f"launches, expected {want} ({n} per backward pass)")
    launches["waypoint_racing"] = race["cholesky_launches"]
    rec["waypoint_racing"] = {"wall_s": race_s, **{k: race[k] for k in (
        "closest_approaches", "cholesky_launches", "chol_fallbacks")}}

    return rec, launches


# the plant-breadth phase: (model, quaternion, substeps, integration) rows
# of the ablation grid at its full width (glider, N=40, dt=0.05, goal
# +[120, 20, 10] m, trim warm start), cut to 1 x 2 iterations
PLANT_ROWS = (("linear", "integration", 1, "explicit"),
              ("poly", "integration", 1, "explicit"),
              ("nn", "expmap", 5, "explicit"),
              ("default", "integration", 1, "implicit"),
              ("default", "expmap", 1, "implicit"))
PLANT_TOL = 2e-4     # the rk4 rows' tolerance; the linearisation's too


def plant_models(params, trim):
    """The six coefficient models built once on the CPU: the fitted
    linear and polynomial artifacts, the trained MLP, a mini-MLP drawn
    from a seeded generator, the default, and the MLP's Taylor expansion
    about the fleet's trim (its model inputs)."""
    import torch

    from aircraft_tpu_torch.dynamics import aircraft as ac
    from aircraft_tpu_torch.dynamics import coefficients as co

    nn = co.load_mlp(device="cpu")
    cpu = params.to("cpu")
    aero = ac.aero_state(cpu, trim.state.cpu(), trim.control[:7].cpu())
    anchor = co.model_inputs(aero, trim.control[0].cpu(),
                             trim.control[1].cpu())
    return {"default": co.DefaultCoeffParams(),
            "linear": co.default_artifact_coeff("linear", device="cpu"),
            "poly": co.default_artifact_coeff("poly", device="cpu"),
            "nn": nn,
            "nn_mini": co.MiniMLPCoeffParams.init(
                torch.Generator().manual_seed(0), device="cpu"),
            "nn_taylor": co.TaylorCoeffParams.from_model(nn, anchor)}


def plant_breadth(device="cuda"):
    """Every coefficient model on the card held against the same code on
    the CPU at the 256 fleet states; the exponential-map and implicit
    steps at B=256 (the implicit step and its linearisation with no host
    sync); the ablation rows of PLANT_ROWS; one MHTT window of the
    polynomial plant at the headline window (no window kernel).  Returns
    (records, launches of the polynomial window)."""
    import dataclasses

    import numpy as np
    import torch

    from aircraft_tpu_torch import ablation, bench
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control.mhtt import finish_pull
    from aircraft_tpu_torch.dynamics import aircraft as ac
    from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
    from aircraft_tpu_torch.solvers import ilqr, integrators
    from aircraft_tpu_torch.solvers.rollout import rollout

    records = {}
    cuda = device != "cpu"
    _, params, _, track, v_ref, _ = bench.build_problem(
        device, glide=mlp_glide(device))
    z0s, trim = bench.fleet_states(params, track, 256, v_ref)
    x = z0s[:, :13].contiguous()
    u = trim.control[:7].expand(x.shape[0], 7).contiguous()
    models = plant_models(params, trim)
    for name, cp in models.items():
        cpu = dataclasses.replace(params.to("cpu"), coeff=cp)
        dev = cpu.to(device)
        ref_f = ac.state_derivative(cpu, x.cpu(), u.cpu())
        f = ac.state_derivative(dev, x, u).cpu()
        steps = [integrators.make_step_fn(p, normalize="step")
                 for p in (cpu, dev)]
        ref_J = batched_jacfwd(lambda a, b: steps[0](a, b, bench.DT),
                               x.cpu(), u.cpu())
        J = batched_jacfwd(lambda a, b: steps[1](a, b, bench.DT), x, u).cpu()
        rec = {"derivative_rel_err": rel_err(f, ref_f),
               "jacobian_rel_err": rel_err(J, ref_J),
               "finite": bool(torch.isfinite(J).all()
                              and torch.isfinite(f).all())}
        print(f"plant: {name} aero at the {x.shape[0]} fleet states, card "
              f"against CPU: " + json.dumps(rec), flush=True)
        check(rec["finite"] and close(f, ref_f, PLANT_TOL)[0]
              and close(J, ref_J, PLANT_TOL)[0],
              f"plant: {name}: card and CPU differ: {rec}")
        records[f"model_{name}"] = rec

    us40 = u[:, None].expand(x.shape[0], 40, 7)
    expmap = integrators.make_step_fn(params, substeps=10, normalize="expmap")
    xs = rollout(expmap, x, us40, bench.DT)
    drift = float((torch.linalg.norm(xs[..., 6:10], dim=-1) - 1.0).abs()
                  .max())
    rec = {"finite": bool(torch.isfinite(xs).all()), "quaternion_drift": drift}
    print(f"plant: expmap step, 10 substeps, B={x.shape[0]}, 40 knots: "
          + json.dumps(rec), flush=True)
    check(rec["finite"] and drift <= 1e-5, f"plant: expmap rollout {rec}")
    records["expmap_rollout"] = rec
    for ss in (1, 5):
        step = integrators.make_step_fn(params, substeps=ss,
                                        normalize="step",
                                        integration="implicit")
        lin = lambda: batched_jacfwd(lambda a, b: step(a, b, bench.DT), x, u)
        step(x, u, bench.DT)
        lin()                                       # warm-up
        what = f"implicit step, {ss} substep(s), B={x.shape[0]}"
        run = (lambda w, fn: strict(w, fn)) if cuda else (
            lambda w, fn: fn())
        xn = run(what, lambda: step(x, u, bench.DT))
        J = run(f"linearisation of the {what}", lin)
        rec = {"finite": bool(torch.isfinite(xn).all()
                              and torch.isfinite(J).all())}
        check(rec["finite"], f"plant: {what}: non-finite")
        records[f"implicit_ss{ss}"] = rec

    cut = SolverConfig(max_al_iters=1, max_inner_iters=2, constraint_tol=0.1)
    rows = []
    for model, qmode, ss, integ in PLANT_ROWS:
        row = ablation.run_ablation(
            models=(model,), quaternion_modes=(qmode,), substeps_grid=(ss,),
            integration_modes=(integ,), num_nodes=40, dt=0.05,
            solver_config=cut, device=device)[0]
        label = f"{model}/{qmode}/ss{ss}/{integ}"
        print(f"plant: ablation row {label}: wall {row.get('wall_s')} s",
              flush=True)
        check("error" not in row, f"plant: ablation row {label}: "
              f"{row.get('error')}")
        check(np.isfinite(row["final_objective"]),
              f"plant: ablation row {label}: objective "
              f"{row['final_objective']}")
        rows.append({"row": label, **{k: row[k] for k in (
            "wall_s", "final_objective", "primal_inf", "goal_distance",
            "quaternion_drift", "feasible")}})
    records["ablation_rows"] = rows

    poly = models["poly"].to(device)
    m, z0, us0 = headline_mhtt(SolverConfig(
        max_al_iters=1, max_inner_iters=2, hessian="gauss_newton"),
        device=device, coeff=poly)
    check(not m.fused, "the polynomial plant's MHTT took the window kernels")
    calls = []
    real = ilqr.solve_batch
    ilqr.solve_batch = lambda *a, **k: calls.append(1) or real(*a, **k)
    reset_all_counts()
    try:
        t0 = time.perf_counter()
        z, _, _, pull = m._serve_step(z0[0], us0, m._al0)
        finish_pull(pull)
        wall = time.perf_counter() - t0
    finally:
        ilqr.solve_batch = real
    counts = bench.kernel_launches()
    launches = {k: counts[k] for k in ("window_backward", "window_forward")}
    rec = {"wall_s": wall, "ilqr_solve_batch_calls": len(calls),
           "finite": bool(torch.isfinite(z).all()), **launches}
    print("plant: MHTT window of the polynomial plant, N=50, B=1, 1 x 2: "
          + json.dumps(rec), flush=True)
    check(calls == [1] and rec["finite"] and not any(launches.values()),
          f"plant: polynomial MHTT window {rec}")
    records["poly_mhtt_window"] = rec
    return records, launches


# the fleet-scale phase's shapes and cuts (the module docstring lists them)
FLEET_B = 256
PHASE_REPS = 2
WARM_WINDOWS = 2
ROOFLINE_REPS = 2
OPPOINTS_SMOKE = "2x6,3x12r"
SCALING_BUDGET = (1, 2)     # the scaling mode's 2 x 6, cut
SEQ_BLOCKS = 5
MPC_BATCH, MPC_WINDOWS = 64, 2
PHASE_PIECES = ("rollout_s", "linearize_s", "quadraticize_s", "backward_s",
                "forward_12alpha_s", "linearize_fused_s")


def scaling_check_rank(mesh, job, n_dev, mode):
    """``bench.scaling_rank``'s row, and under ``check``: the job's
    ``solve_batch_sharded`` once more with every count reset, then the
    unsharded ``ilqr.solve_batch`` of the same inputs on the same rank,
    whether every field of the solutions and the summary are bit for bit
    equal, the backend, and the sharded solve's launches."""
    import torch
    import torch.distributed as dist

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.parallel import batched, solve_batch_sharded
    from aircraft_tpu_torch.solvers import ilqr

    row = bench.scaling_rank(mesh, job, n_dev, mode)
    _, _, ocp, *_ = bench.build_problem(mesh.device, glide=job["glide"])
    z0s = torch.as_tensor(job["z0s"], device=mesh.device)
    us0 = torch.as_tensor(job["us0"], device=mesh.device)
    reset_all_counts()
    sols, summary = solve_batch_sharded(ocp, z0s, us0, mesh, job["config"],
                                        cuda_chol=job["cuda_chol"])
    launches = bench.kernel_launches()
    ref = ilqr.solve_batch(ocp, z0s, us0, job["config"],
                           cuda_chol=job["cuda_chol"])
    ref_summary = batched.summarize(*batched.batch_sums(ref), z0s.shape[0])
    fields = ("xs", "us", "cost", "violation", "converged", "iterations",
              "grad_norm")
    equal = {f: bool(torch.equal(getattr(sols, f), getattr(ref, f)))
             for f in fields}
    equal.update({f"summary.{f}": bool(torch.equal(a, b)) for f, a, b in zip(
        summary._fields, summary, ref_summary)})
    row["check"] = {"backend": dist.get_backend(), "world": mesh.size,
                    "equal": equal, "launches": launches,
                    "finite": bool(torch.isfinite(sols.cost).all())}
    return row


def fleet_scale(device="cuda"):
    """The fleet-scale modes and parallel/, each path with every count
    reset just before it: the phase mode on the kernel route, the warm
    mode with --cuda-chol, the roofline mode, oppoints at two points, the
    horizon-sharded sweep's three pieces in SEQ_BLOCKS blocks in this
    process against the associative sweep, the scaling mode at one device
    with the sharded solve held against the unsharded one, and the batched
    MPC example, each handed the plant's best glide (``mlp_glide``).
    Returns {path: launches}."""
    import torch

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.examples import batched_mpc
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.parallel import seq_riccati
    from aircraft_tpu_torch.solvers import riccati

    import chip_smoke as this     # the rank function by its import path

    cuda = device != "cpu"
    N = bench.N_HORIZON
    K5 = "batched_cholesky_solve"
    paths = {}

    glide = mlp_glide(device)

    def timed(label, fn):
        reset_all_counts()
        t0 = time.perf_counter()
        out = fn()
        print(json.dumps(out), flush=True)
        print(f"fleet scale: {label} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    ph = timed("phase mode", lambda: bench.bench_phase(
        device, batch=FLEET_B, reps=PHASE_REPS, cuda_chol=True, glide=glide))
    check(all(math.isfinite(ph[k]) and ph[k] > 0 for k in PHASE_PIECES),
          f"phase mode: a piece is not finite and positive: {ph}")
    check(not cuda or ph["backward_cholesky_launches_per_call"] == N,
          f"phase mode: {ph['backward_cholesky_launches_per_call']} "
          f"Cholesky launches per backward call, expected {N}")
    paths["phase"] = bench.kernel_launches()

    wm = timed("warm mode", lambda: bench.bench_warm(
        device, batch=FLEET_B, windows=WARM_WINDOWS, cuda_chol=True,
        glide=glide))
    n_chol = wm["kernel_launches"][K5]
    check(not cuda or wm["cholesky_launches_per_backward_pass"] == N,
          f"warm mode: {n_chol} Cholesky launches in "
          f"{wm['backward_passes']} backward passes, expected {N} each")
    check(wm["kernel_launches"]["chol_fallbacks"] <= n_chol / 10,
          f"warm mode: {wm['kernel_launches']['chol_fallbacks']} fallbacks "
          f"in {n_chol} launches")
    check(wm["finite_fraction"] == 1.0,
          f"warm mode: finite_fraction {wm['finite_fraction']}")
    paths["warm"] = wm["kernel_launches"]

    rf = timed("roofline mode", lambda: bench.bench_roofline(
        device, batch=FLEET_B, reps=ROOFLINE_REPS, glide=glide))
    check(not cuda or 0.0 < rf["value"] <= 1.05,
          f"roofline mode: value {rf['value']} outside (0, 1.05]")
    per = (ROOFLINE_REPS + 1) * rf["al_iters"] * rf["inner_iters"]
    check(not cuda or all(rf["kernel_launches"][k] == per for k in (
        "window_backward", "window_forward")),
          f"roofline mode: launches {rf['kernel_launches']}, expected {per} "
          "of each window kernel")
    paths["roofline"] = rf["kernel_launches"]

    op = timed("oppoints mode", lambda: bench.bench_oppoints(
        device, points=OPPOINTS_SMOKE, warmup=0, reps=1, glide=glide))
    bad = [r for r in op["points"] if "error" in r]
    check(not bad, f"oppoints mode: rows with an error: {bad}")
    for row in op["points"]:
        want = 2 * row["al"] * row["inner"]     # a cold and a timed window
        check(not cuda or all(row["kernel_launches"][k] == want for k in (
            "window_backward", "window_forward")),
              f"oppoints {row['point']}: launches {row['kernel_launches']}, "
              f"expected {want} of each window kernel")
    paths["oppoints"] = {k: sum(r["kernel_launches"][k] for r in op["points"])
                         for k in op["points"][0]["kernel_launches"]}

    reset_all_counts()
    args = lq_batch(FLEET_B, N, device)
    ref = riccati.backward_associative(*args, cuda_chol=True)
    cholesky.reset_launch_counts()
    blocked = seq_riccati.backward_associative_blocked(SEQ_BLOCKS, *args,
                                                       cuda_chol=True)
    n_blocks = cholesky.batched_cholesky_solve.launches
    errs = {}
    for i, name in enumerate(("K", "k")):
        ok, errs[name] = close(blocked[i], ref[i], 2e-3)
        check(ok, f"seq_riccati {SEQ_BLOCKS} blocks: {name} differs from "
              f"the associative sweep by {errs[name]}")
    check(not bool(blocked[5].any()), "seq_riccati blocks: fail flag set")
    print(f"horizon-sharded sweep, {SEQ_BLOCKS} blocks in one process, LQ "
          f"B={FLEET_B} N={N} on the kernel route: against the associative "
          f"sweep max abs err {json.dumps(errs)} (tol 2e-3 x (1+|ref|)); "
          f"Cholesky launches {n_blocks}", flush=True)
    check(not cuda or n_blocks == SEQ_BLOCKS,
          f"seq_riccati blocks: {n_blocks} Cholesky launches, expected "
          f"{SEQ_BLOCKS}")
    paths["seq_riccati_blocks"] = {K5: n_blocks}

    sc = timed("scaling mode with the sharded solve's check", lambda:
               bench.bench_scaling(
                   device, devices=(1,), al_iters=SCALING_BUDGET[0],
                   inner_iters=SCALING_BUDGET[1], reps=1, cuda_chol=True,
                   glide=glide, rank=this.scaling_check_rank))
    check(len(sc["rows"]) == 1, f"scaling mode: rows {sc['rows']}")
    row = sc["rows"][0]
    passes = SCALING_BUDGET[0] * SCALING_BUDGET[1]
    check(not cuda or row["kernel_launches"][K5] == N * passes,
          f"scaling mode: launches {row['kernel_launches']}")
    sh = row["check"]
    check(sh["backend"] == ("nccl" if cuda else "gloo") and sh["world"] == 1,
          f"sharded solve ran over {sh['backend']} at world {sh['world']}")
    check(all(sh["equal"].values()) and sh["finite"],
          f"sharded solve differs from the unsharded one: {sh['equal']}")
    check(not cuda or sh["launches"][K5] == N * passes,
          f"sharded solve: {sh['launches'][K5]} Cholesky launches, expected "
          f"{N * passes}")
    paths["scaling"] = row["kernel_launches"]
    paths["solve_batch_sharded"] = sh["launches"]

    reset_all_counts()
    t0 = time.perf_counter()
    mpc = batched_mpc.run_fleet(MPC_BATCH, MPC_WINDOWS, device)
    batched_mpc.report(mpc)
    print(f"fleet scale: batched_mpc in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(bool(torch.isfinite(torch.as_tensor(mpc["progress"])).all()),
          "batched_mpc: non-finite progress")
    if cuda:
        check_window_launches("batched_mpc", mpc["windows"], 20)
    paths["batched_mpc"] = bench.kernel_launches()
    return paths


SIDE = []     # the side process, while it runs


def side_paths(result_path) -> int:
    """``chip_smoke.py --side RESULT``: the planners, the fleet scale,
    the quadrotor's time-optimal solve, examples/train_ddpg.py, the last
    examples (``examples_path``) and the entry module's dry run, each
    path with every count reset just before it, in a process of its
    own that runs beside the main process's later paths once the kernels'
    device times are taken.  Writes what the report needs to RESULT."""
    from pathlib import Path

    from aircraft_tpu_torch.kernels import _build

    _build.build_all()      # built by the main process: loads them
    phase("path: planners")
    plan_launches, _, (a_sweep, rhs_sweep) = planners_paths()
    _, _, sweep_rel = hold_cholesky_indefinite(
        a_sweep, rhs_sweep, "candidate sweep's first Cholesky batch "
        f"B={a_sweep.shape[0]} m={a_sweep.shape[1]} k={rhs_sweep.shape[2]} "
        "(exact expansion)")
    check(tuple(a_sweep.shape) == (8, 9, 9)
          and tuple(rhs_sweep.shape) == (8, 9, 16),
          f"candidate sweep's Cholesky batch {tuple(a_sweep.shape)}, "
          f"{tuple(rhs_sweep.shape)}")

    phase("path: fleet scale")
    t0 = time.perf_counter()
    fleet = fleet_scale()
    print(f"fleet scale: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("path: quadrotor time-optimal on the Cholesky kernel")
    quad_launches, _ = quadrotor_path()

    phase("path: learning, examples/train_ddpg.py")
    train = learning_train_ddpg()

    phase("path: the last examples (openloop_sim, waypoint_racing)")
    t0 = time.perf_counter()
    examples, example_launches = examples_path()
    print(f"examples: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("path: entry module, dryrun_multichip(1) over NCCL")
    dry = entry_dryrun()
    Path(result_path).write_text(json.dumps({
        "plan_launches": plan_launches, "sweep_rel": sweep_rel,
        "fleet": fleet, "quad_launches": quad_launches,
        "train_ddpg": train, "examples": examples,
        "example_launches": example_launches, "dryrun": dry}))
    return 0


def entry_dryrun(device="cuda"):
    """aircraft_tpu_torch.entry.dryrun_multichip(1): the sharded solve,
    the tensor-parallel MLP step and the horizon-sharded sweep on a
    one-rank mesh (NCCL takes one rank per card); each step raises on
    failure.  Returns its rank's record."""
    from aircraft_tpu_torch import entry

    t0 = time.perf_counter()
    (r,) = entry.dryrun_multichip(1, device=device)
    rec = {k: r[k] for k in ("coords", "shape", "mean_cost", "loss",
                             "riccati_max_abs_dK")}
    rec["wall_s"] = time.perf_counter() - t0
    print("entry dry run: " + json.dumps(rec), flush=True)
    return rec


def start_side():
    """Start ``side_paths`` in a second process on the same card, its
    output to a log under the build directory."""
    from pathlib import Path

    from aircraft_tpu_torch.kernels._build import BUILD_DIR

    out = BUILD_DIR / "chip_smoke_side"
    out.mkdir(parents=True, exist_ok=True)
    result, log = out / "result.json", out / "side.log"
    result.unlink(missing_ok=True)
    with open(log, "w") as f:
        SIDE.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--side",
             str(result)], stdout=f, stderr=subprocess.STDOUT))
    return result, log


def finish_side(result, log) -> dict:
    """Wait for the side process, print its log, and return its result;
    a side process that failed fails the smoke."""
    rc = SIDE[0].wait()
    SIDE.clear()
    print(log.read_text(), end="", flush=True)
    check(rc == 0, f"the side process (planners, fleet scale, quadrotor, "
          f"train_ddpg, examples, entry dry run) exited {rc}")
    return json.loads(result.read_text())


def stop_side():
    for proc in SIDE:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    SIDE.clear()


def print_window(w, sols):
    """``run_headline``'s per-window hook: one line per chained window."""
    from aircraft_tpu_torch import bench

    print(f"chain window {w}: " + json.dumps(bench.window_summary(
        sols.violation.cpu().numpy(), sols.cost.cpu().numpy())), flush=True)


def reset_all_counts():
    from aircraft_tpu_torch.kernels import cholesky, rollout, window
    from aircraft_tpu_torch.solvers import riccati

    for mod in (window, cholesky, rollout):
        mod.reset_launch_counts()
    riccati.reset_counts()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from aircraft_tpu_torch import bench, roofline
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
                print(f"  {name}: {line.strip()}", flush=True)

    phase("window kernels at full width")
    ocp, spec, config, z0s, us, inp = fleet_problem()
    B, N = us.shape[:2]
    op = win.make_window_operands(spec, N, alphas=win.line_search_alphas(
        config.line_search_steps), device="cuda")
    occupancy(op, B)
    full = hold_kernels(op, inp, "B=256 N=50 nn", timing_reps=20)
    work = {"window_backward": roofline.backward_work(op, B),
            "window_forward": roofline.forward_work(op, B)}

    phase("window kernels on reversed-flow lanes, both coefficient models")
    for model in ("nn", "default"):
        op_s, inp_s = reversed_batch(model)
        hold_kernels(op_s, inp_s, f"B=16 N=10 {model} reversed")

    phase("batched cholesky")
    chol, chol_all, chol_cm = cholesky_phase(ocp, z0s, us, inp)
    work["batched_cholesky"] = roofline.cholesky_work(B, 7, 15)

    phase("batched cholesky at the quadrotor's shapes")
    quad_holds = quadrotor_holds()

    phase("fused rollout")
    roll = rollout_phase()
    work["fused_rollout"] = roofline.rollout_work(1024, N, 10,
                                                  roll["op"].mlp.numel())

    phase("window kernels at serving shapes")
    serving = serving_holds(op, config)
    # every device time of the kernels line is taken: from here the
    # planners and the fleet scale run beside the other paths
    side_result, side_log = start_side()

    phase("sync audit")
    sync_audit(ocp, us, inp)

    phase("path: fused serving chain at the bench's default depth")
    print(setup_holds(), flush=True)
    reset_all_counts()
    head = bench.run_headline("cuda", batch=256, glide=mlp_glide(),
                              on_window=print_window)
    counts = bench.kernel_launches()
    print(json.dumps(head), flush=True)
    per_window = head["al_iters"] * head["inner_iters"]
    for name in ("window_backward", "window_forward"):
        check(counts[name] == head["windows"] * per_window,
              f"fused chain launched {name} {counts[name]} times, expected "
              f"{per_window} per window of {head['windows']}")
    check(head["finite_fraction"] == 1.0,
          f"fused chain finite_fraction {head['finite_fraction']}")
    check(head["fused_kernels"], "fused chain did not run the kernels")
    # the gate is printed, not held: on the reference's set-up the chain
    # ends near it at the default seed, on both sides of it across seeds
    # (chain_crossing.py --arm headline)
    print(f"fused chain at {head['windows']} windows: gate "
          f"{head['feasibility_gate_95pct_1e2_passed']} "
          f"(converged_fraction_1e2 {head['converged_fraction_1e2']})",
          flush=True)
    launches = {name: counts[name] for name in ("window_backward",
                                                "window_forward")}

    phase("iLQR inner iteration, piece by piece")
    times, wall, busy, n_launch = ilqr_breakdown(ocp, z0s, us, config)
    print("one inner iteration at B=256 N=50 (host wall, s): "
          + json.dumps({k: round(v, 4) for k, v in times.items()})
          + f"; profiled iteration wall {wall:.3f} s, device busy share "
          + (f"{busy:.3f}" if busy is not None else "not measured (the "
             "profiler saw no device time)")
          + f", {n_launch} kernel launches", flush=True)

    phase("fused inner iteration, piece by piece")
    for label, b in (("B=256", B), ("B=1", 1)):
        times, inner, wall, busy, n_launch = fused_breakdown(
            ocp, spec, z0s[:b], us[:b].contiguous(), config)
        print(f"one fused inner iteration at {label} N={N} (host wall, s): "
              + json.dumps({k: round(v, 5) for k, v in times.items()})
              + f"; inner-iteration pieces {inner:.4f} s; profiled pieces "
              f"wall {wall:.4f} s, device busy share "
              + (f"{busy:.3f}" if busy is not None else "not measured (the "
                 "profiler saw no device time)")
              + f", {n_launch} kernel launches", flush=True)
    host = sweep_host_s(ocp, us, inp)
    print(f"one backward pass at B={B} N={N} (host wall, s, median of 5): "
          + json.dumps(host), flush=True)
    from aircraft_tpu_torch.solvers import ilqr
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    al = ocp_mod.init_al_state(ocp, inp["xs"][:, 0], us[:, 0], N)
    hold_sweep_graph((*ilqr.linearize(ocp, inp["xs"], us), *(
        ilqr._san(t, 1e8) for t in ilqr.quadraticize_gn(
            ocp, al, inp["xs"], us)), inp["reg"]),
        f"fleet Gauss-Newton expansion (B={B}, N={N})")

    phase("path: iLQR chain on the Cholesky kernel")
    reset_all_counts()
    t0 = time.perf_counter()
    ilqr_head = bench.run_headline("cuda", batch=256, warmup=0, reps=1,
                                   solver="ilqr", cuda_chol=True,
                                   glide=mlp_glide())
    ilqr_wall = time.perf_counter() - t0
    counts = bench.kernel_launches()
    print(json.dumps(ilqr_head), flush=True)
    passes = (ilqr_head["windows"] * ilqr_head["al_iters"]
              * ilqr_head["inner_iters"])
    n_chol = counts["batched_cholesky_solve"]
    print(f"iLQR chain: {ilqr_head['windows']} windows in {ilqr_wall:.1f} s "
          f"(cold window and set-up {ilqr_head['compile_s']} s, chained "
          f"window {ilqr_head['wall_s_per_batch']} s); {passes} backward "
          f"passes; cholesky launches {n_chol}; chol_fallbacks "
          f"{counts['chol_fallbacks']}; gate "
          f"{ilqr_head['feasibility_gate_95pct_1e2_passed']} "
          f"(converged_fraction_1e2 {ilqr_head['converged_fraction_1e2']})",
          flush=True)
    check(n_chol == N * passes,
          f"iLQR chain: {n_chol} Cholesky launches, expected {N * passes}")
    check(counts["chol_fallbacks"] <= n_chol / 10,
          f"iLQR chain: the fallback replaced the kernel on "
          f"{counts['chol_fallbacks']} of {n_chol} calls")
    check(counts["window_backward"] == counts["window_forward"] == 0,
          "iLQR chain launched a window kernel")
    check(ilqr_head["finite_fraction"] == 1.0,
          f"iLQR chain finite_fraction {ilqr_head['finite_fraction']}")
    launches["batched_cholesky"] = n_chol

    phase("path: exact Hessian window, both sweeps on the Cholesky kernel")
    exact, (a_first, rhs_first), gains = exact_window(ocp, z0s, us)
    indef_err, indef_bad, indef_rel = hold_cholesky_indefinite(
        a_first, rhs_first, f"associative sweep's first Cholesky batch "
        f"B={a_first.shape[0]} m=7 k=15 (exact expansion)")
    (Ks, ks_, *_), (Ka, ka, *_) = gains["sequential"], gains["associative"]
    finite = {m: int(g[0].isfinite().flatten(1).all(1).sum())
              for m, g in gains.items()}
    print("first inner iteration of the exact window: sequential against "
          "associative gains, max |dK| / (1 + max |K|) "
          f"{rel_err(Ka, Ks):.3e}, max |dk| / (1 + max |k|) "
          f"{rel_err(ka, ks_):.3e}; max |Qu| sequential "
          f"{float(gains['sequential'][4].max()):.4g}, associative "
          f"{float(gains['associative'][4].max()):.4g}; scenarios with "
          f"finite gains {json.dumps(finite)} of {B} (a finding, not held: "
          "on this non-convex expansion the two sweeps are different "
          "computations; they are held at 2e-3 on the LQ batch below)",
          flush=True)
    lq = lq_sweeps(B, N, us.device)
    launches["batched_cholesky_by_path"] = {
        "ilqr_chain": n_chol,
        "exact_window_sequential": exact["sequential"]["cholesky_launches"],
        "exact_window_associative": exact["associative"]["cholesky_launches"],
        **{f"lq_{k}": v for k, v in lq["launches"].items()}}

    phase("path: bench modes")
    reset_all_counts()
    kmode = bench.bench_kernel("cuda", reps=2)   # the plain rollout takes seconds
    counts = bench.kernel_launches()
    print(json.dumps(kmode), flush=True)
    check(counts["fused_rollout"] > 0, "kernel mode never launched fused_rollout")
    launches["fused_rollout"] = counts["fused_rollout"]
    reset_all_counts()
    cmode = bench.bench_chol("cuda")
    counts = bench.kernel_launches()
    print(json.dumps(cmode), flush=True)
    check(counts["batched_cholesky_solve"] > 0,
          "chol mode never launched batched_cholesky_solve")
    check(math.isfinite(kmode["max_diff"]) and cmode["max_diff"] < CHOL_TOL,
          "bench modes: a non-finite rollout or a Cholesky difference "
          f"{cmode['max_diff']}")
    rmode = bench.bench_riccati("cuda", reps=3)
    print(json.dumps(rmode), flush=True)
    check(all(r["max_K_diff"] < 2e-3 for r in rmode["horizons"].values()),
          f"riccati mode: the two sweeps differ: {rmode['horizons']}")

    phase("path: serving loop")
    serve_launches, _ = serving_loop_paths()

    phase("path: plant breadth")
    t0 = time.perf_counter()
    plant, plant_launches = plant_breadth()
    print(f"plant breadth: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("path: estimator, LQR and stability analysis, card against CPU")
    control_errs = control_pieces()

    phase("path: learning")
    t0 = time.perf_counter()
    learning, learn_launches = learning_path()
    print(f"learning: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("path: tooling, the entry module and examples/full_course.py")
    t0 = time.perf_counter()
    tooling, tool_launches = tooling_path()
    print(f"tooling: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("side process: planners, fleet scale, quadrotor, train_ddpg, the "
          "last examples and the entry module's dry run (its log, its own "
          "clock)")
    side = finish_side(side_result, side_log)
    print("train_ddpg record: " + json.dumps(side["train_ddpg"]), flush=True)
    print("examples record: " + json.dumps(side["examples"]), flush=True)
    print("entry dry run record: " + json.dumps(side["dryrun"]), flush=True)
    plan_launches, sweep_rel, fleet = (side["plan_launches"],
                                       side["sweep_rel"], side["fleet"])
    quad_launches = side["quad_launches"]

    phase("report")
    # (name, replaces, max abs err, device ms, wrapper ms, plain ms,
    #  library device ms, library wrapper ms)
    rows = (
        ("window_backward", "aircraft_tpu/kernels/window_kernel.py:482",
         full["backward_err"], full["backward_device_ms"], full["backward_ms"],
         full["backward_plain_ms"], None, None),
        ("window_forward", "aircraft_tpu/kernels/window_kernel.py:700",
         full["forward_err"], full["forward_device_ms"], full["forward_ms"],
         full["forward_plain_ms"], None, None),
        ("batched_cholesky", "aircraft_tpu/kernels/cholesky_kernel.py:68",
         max(chol["err"], chol_all["err"], chol_cm["err"]), chol["ms"],
         chol["wrapper_ms"], chol["plain_ms"], chol["library_ms"],
         chol["library_wrapper_ms"]),
        ("fused_rollout", "aircraft_tpu/kernels/rollout_kernel.py:256, "
         "aircraft_tpu/kernels/rollout_kernel.py:434",
         roll["err"], roll["ms"], roll["wrapper_ms"], roll["plain_ms"], None,
         None),
    )
    kernels = []
    for name, replaces, err, ms, wms, plain_ms, lib_ms, lib_wms in rows:
        bms, by = roofline.bound_ms(work[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aircraft_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "wrapper_ms": wms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "share": bms / ms, "library_ms": lib_ms,
            "library_wrapper_ms": lib_wms})
    # the window kernels at the serving shapes and their launches on the
    # serving loop's paths
    shapes = (("b1", "B=1 N=50 nn"), ("b6", "B=6 N=50 nn"),
              ("course_b6", "course B=6 N=30 ss=5 default"),
              ("whole_b1", "whole warm start B=1 N=50 default"))
    for row, half in ((kernels[0], "backward"), (kernels[1], "forward")):
        row["max_abs_err"] = max(row["max_abs_err"],
                                 learning["trained_window_hold"][f"{half}_err"])
        for key, label in shapes:
            hold = serving[label]
            row[f"ms_{key}"] = hold[f"{half}_ms"]
            row[f"bound_ms_{key}"], row[f"bound_by_{key}"] = hold[f"{half}_bound"]
            row["max_abs_err"] = max(row["max_abs_err"], hold[f"{half}_err"])
        row["launches_by_path"] = {"fused_chain": row["launches"], **{
            path: counts[row["name"]] for path, counts in serve_launches.items()},
            "whole_warm_start": plan_launches["whole_warm_start"][row["name"]],
            "plant_breadth_poly_window": plant_launches[row["name"]],
            "learning_trained_mlp_window": learn_launches[row["name"]],
            "tooling_full_course": tool_launches["full_course"][row["name"]],
            **{path: fleet[path][row["name"]] for path in (
                "roofline", "oppoints", "batched_mpc")}}
    kernels[2]["launches_by_path"] = {
        **launches["batched_cholesky_by_path"],
        "planners_candidate_sweep": plan_launches["planners_candidate_sweep"],
        **{path: fleet[path]["batched_cholesky_solve"] for path in (
            "phase", "warm", "solve_batch_sharded", "seq_riccati_blocks",
            "scaling")}}
    kernels[2]["launches_by_path"].update(quad_launches)
    kernels[2]["launches_by_path"]["examples_waypoint_racing"] = (
        side["example_launches"]["waypoint_racing"])
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    quad_holds[4]["err"])
    for m, h in quad_holds.items():
        # the quadrotor's shapes: one system per knot, B = N = 60, k = 14
        for key in ("ms", "wrapper_ms", "graph_ms", "plain_ms", "library_ms",
                    "library_wrapper_ms"):
            kernels[2][f"{key}_quad_m{m}"] = h[key]
        kernels[2][f"bound_ms_quad_m{m}"], kernels[2][
            f"bound_by_quad_m{m}"] = h["bound"]
    kernels[2]["max_err_indefinite"] = max(indef_rel, sweep_rel,
                                           quad_holds[5]["rel_err"])
    kernels[2]["nonfinite_share_indefinite"] = indef_bad
    print(f"profiler traces of timed calls: {json.dumps(TRACES)} (records "
          "lost by the pre-roll, the first launches of a trace; the timed "
          "calls kept every record)", flush=True)
    print("control pieces, card against CPU, max err over (1 + |ref|): "
          + json.dumps(control_errs), flush=True)
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--side"]:
            sys.exit(side_paths(sys.argv[2]))
        sys.exit(main())
    finally:
        stop_side()
