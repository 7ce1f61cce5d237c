"""The port's waypoint-racing solve and the time-optimal planner's legacy
branch against the JAX package on the short two-waypoint course:

* one ``solve_waypoint_racing(warm_start=False)`` at N=8 (10 RK4
  substeps per knot), 1 AL round x 2 inner iterations, against the
  reference's ``ilqr.solve``: cost within 5% and violation within
  0.3 (1 + v), the population tolerance the port's whole solves are held
  to (a chaotic plant and two summation orders), and the same layout;
* ``solve_time_optimal(per_candidate_warm_start=False)``: the reference
  reads a ``trim`` it never binds and raises NameError; the port raises
  NotImplementedError instead of running a branch the reference cannot;
* the open fault of the time probe (``slow``, ~5 min): on an H100 the
  probe's nominal racing solve missed a waypoint by 133 m where the
  reference's CPU record passes within 6.9 m.  That pass is decided by
  rounding inside the reference: one ulp of one control flips its own
  warm-start rollout, and its own racing solve, from pass to miss; the
  port's step agrees with the reference's knot by knot.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from aircraft_tpu.config import SolverConfig as JaxSolverConfig
from aircraft_tpu.control import waypoints as jwp

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.control import waypoints as wp

from torch_port_problem import short_course_pair

N, DT, SUBSTEPS = 8, 0.1, 10


@pytest.fixture(scope="module")
def course():
    return short_course_pair()


def test_racing_solve_matches_the_reference(course):
    jx, pt = course
    kw = dict(num_nodes=N, dt=DT, substeps=SUBSTEPS, warm_start=False)
    ref = jwp.solve_waypoint_racing(
        jx["params"], jx["config"],
        solver_config=JaxSolverConfig(max_al_iters=1, max_inner_iters=2),
        **kw)
    sol = wp.solve_waypoint_racing(
        pt["params"], pt["config"],
        solver_config=SolverConfig(max_al_iters=1, max_inner_iters=2),
        device="cpu", **kw)
    assert sol.xs.shape == np.shape(ref.xs) == (N + 1, 15)
    assert sol.us.shape == np.shape(ref.us) == (N, 9)
    assert sol.cost.ndim == 0 and bool(torch.isfinite(sol.cost))
    c, cr = float(sol.cost), float(ref.cost)
    v, vr = float(sol.violation), float(ref.violation)
    assert abs(c - cr) / (1.0 + abs(cr)) < 0.05, (c, cr)
    assert abs(v - vr) < 0.3 * (1.0 + vr), (v, vr)


def test_legacy_shared_warm_start_raises_in_both(course):
    jx, pt = course
    with pytest.raises(NameError, match="trim"):
        jwp.solve_time_optimal(jx["params"], jx["config"], num_nodes=N,
                               substeps=SUBSTEPS,
                               per_candidate_warm_start=False)
    with pytest.raises(NotImplementedError, match="NameError"):
        wp.solve_time_optimal(pt["params"], pt["config"], num_nodes=N,
                              substeps=SUBSTEPS,
                              per_candidate_warm_start=False, device="cpu")


@pytest.mark.slow
def test_probe_tracking_warm_start_is_chaotic_in_both_packages(course):
    """The probe's tracking warm start (N=70, dt 0.1, 10 substeps, 1 x 30
    from the reference's trim) gives controls far outside the surfaces'
    ±10 deg box, and their open-loop rollout over 70 knots is decided by
    rounding, inside each package on its own:

    * in the reference alone, one ulp of one control at the first knot
      turns its rollout of its own controls from one that leaves the
      finite states into one that stays finite to the end, and the same
      rollout in float64 leaves them at another knot than in float32;
    * in each package, that one-ulp change grows to more than 1e-3 of the
      state by knot 38;
    * the port's step agrees with the reference's, from the reference's
      own states, at every knot before they leave the finite states,
      within 2e-4 relative (the tolerance of the rk4 rows);
    * each package's controls, rolled out through the other package's
      step, leave the finite states within the horizon, while the port's
      stay finite through its own;
    * the reference's own racing solve (6 x 20) from the seed its
      ``solve_waypoint_racing`` builds out of its controls (the passage
      impulses at the rollout's closest approaches, or at its first
      non-finite knot) passes both waypoints within the 10 m tolerance,
      and from the same seed with one ulp of the first knot's elevator
      changed misses one by more than that.

    So the probe's nominal outcome is decided by rounding in the
    reference itself.  A run of the port on an H100 missed a waypoint by
    133 m where the reference's CPU record passes within 6.9 m
    (``data/runs/glider_time_probe.json``): no package that rounds
    otherwise can be held to that pass, and this does not show that the
    port's racing solve is right either."""
    import jax
    import jax.numpy as jnp

    from aircraft_tpu.solvers import integrators as jint
    from aircraft_tpu.solvers.rollout import rollout as jrollout
    from aircraft_tpu.solvers.trim import multistart_trim as jtrim

    from aircraft_tpu_torch.solvers import integrators
    from aircraft_tpu_torch.solvers.rollout import rollout

    jx, pt = course
    Np, dt, ss = 70, 0.1, 10
    trim = np.asarray(jtrim(jx["params"], jax.random.PRNGKey(0), n_starts=32,
                            target_airspeed=45.0).control)
    u_ref = np.asarray(jwp.tracking_warm_start(
        jx["params"], jx["config"], num_nodes=Np, dt=dt, substeps=ss,
        trim_control=jnp.asarray(trim)))
    u_port = wp.tracking_warm_start(
        pt["params"], pt["config"], num_nodes=Np, dt=dt, substeps=ss,
        trim_control=torch.as_tensor(trim), device="cpu").numpy()
    for us in (u_ref, u_port):
        assert np.abs(us[:, :3]).max() > 10.0      # beyond the ±10 deg box
    x0 = np.asarray(jx["config"].waypoints.initial_state, np.float32)
    jstep = jint.make_step_fn(jx["params"], substeps=ss, normalize="step")
    tstep = integrators.make_step_fn(pt["params"], substeps=ss,
                                     normalize="step")

    def ref_roll(us, step=jstep, dtype=jnp.float32):
        return np.asarray(jrollout(step, jnp.asarray(x0, dtype),
                                   jnp.asarray(us, dtype), dt))

    def port_roll(us):
        return rollout(tstep, torch.as_tensor(x0), torch.as_tensor(us),
                       dt).numpy()

    def first_bad(xs):
        fin = np.isfinite(xs).all(axis=1)
        return None if fin.all() else int(np.argmin(fin))

    def gap(a, b, k):
        return np.abs(a[k] - b[k]).max() / (1.0 + np.abs(a[k]).max())

    # one ulp of the first knot's elevator, inside each package
    u_ulp = u_ref.copy()
    u_ulp[0, 1] = np.nextafter(u_ulp[0, 1], np.float32(np.inf))
    ref_xs, ref_ulp = ref_roll(u_ref), ref_roll(u_ulp)
    port_xs, port_ulp = port_roll(u_ref), port_roll(u_ulp)
    assert first_bad(ref_xs) is not None and first_bad(ref_ulp) is None, (
        first_bad(ref_xs), first_bad(ref_ulp))
    assert gap(ref_xs, ref_ulp, 38) > 1e-3, gap(ref_xs, ref_ulp, 38)
    assert gap(port_xs, port_ulp, 38) > 1e-3, gap(port_xs, port_ulp, 38)

    # the reference in float64: the same controls leave at another knot
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if isinstance(a, (jax.Array, np.ndarray))
            and jnp.issubdtype(a.dtype, jnp.floating) else a, jx["params"])
        ref64 = ref_roll(u_ref, jint.make_step_fn(p64, substeps=ss,
                                                  normalize="step"),
                         jnp.float64)
    assert ref64.dtype == np.float64
    assert first_bad(ref64) != first_bad(ref_xs), first_bad(ref64)

    # the port's step from the reference's own states, knot by knot
    jstep_jit = jax.jit(jstep)
    for k in range(first_bad(ref_xs) - 1):
        a = np.asarray(jstep_jit(jnp.asarray(ref_xs[k]), jnp.asarray(u_ref[k]),
                                 jnp.float32(dt)))
        b = tstep(torch.as_tensor(ref_xs[k]), torch.as_tensor(u_ref[k]),
                  torch.tensor(dt, dtype=torch.float32)).numpy()
        assert np.abs(a - b).max() <= 2e-4 * (1.0 + np.abs(a).max()), k

    # the reference's racing solve from its own seed, and one ulp off it
    from aircraft_tpu.solvers import ilqr as jilqr

    wps = np.asarray(jx["config"].waypoints.array())
    jocp = jwp.build_waypoint_ocp(jx["params"], jx["config"], dt=dt,
                                  num_nodes=Np, substeps=ss)
    z0, vs = jwp.initial_guess(jx["config"], Np, time_mode="fixed", dt=dt)
    vs = np.array(vs)
    vs[:, :7] = u_ref
    vs[:, 7:] = 0.0      # the passage impulses, as the reference places them
    prev = 0
    for j, w in enumerate(wps):
        d = np.linalg.norm(ref_xs[:-1, :3] - w, axis=1)
        d[:prev] = np.inf
        prev = int(np.argmin(d))
        vs[prev, 7 + j] = 1.0
    misses = []
    for seed in (vs, vs.copy()):
        if misses:
            seed[0, 1] = np.nextafter(seed[0, 1], np.float32(np.inf))
        xs = np.asarray(jilqr.solve(
            jocp, jnp.asarray(z0), jnp.asarray(seed),
            JaxSolverConfig(max_al_iters=6, max_inner_iters=20)).xs)
        misses.append(max(np.linalg.norm(xs[:, :3] - w, axis=1).min()
                          for w in wps))
    assert misses[0] < 10.0 < misses[1], misses

    finite = {}
    for name, us in (("ref", u_ref), ("port", u_port)):
        finite[name, "ref step"] = bool(np.isfinite(ref_roll(us)).all())
        finite[name, "port step"] = bool(np.isfinite(port_roll(us)).all())
    assert not finite["ref", "port step"], finite
    assert not finite["port", "ref step"], finite
    assert finite["port", "port step"], finite


def _probe_controls(jx):
    """The reference's tracking warm start of the probe (N=70, dt 0.1, 10
    substeps, 1 x 30 from its trim, drawn with jax.random.PRNGKey(0)) and
    that trim's control."""
    import jax
    import jax.numpy as jnp

    from aircraft_tpu.solvers.trim import multistart_trim as jtrim

    trim = np.asarray(jtrim(jx["params"], jax.random.PRNGKey(0), n_starts=32,
                            target_airspeed=45.0).control)
    u_ref = np.asarray(jwp.tracking_warm_start(
        jx["params"], jx["config"], num_nodes=70, dt=0.1, substeps=10,
        trim_control=jnp.asarray(trim)))
    return u_ref, trim


@pytest.mark.slow
def test_probe_racing_solves_from_seeds_both_roll_out(course):
    """Part of the open fault of the time probe: the two packages' racing
    solves at the probe's shapes (N=70, dt 0.1, 10 substeps, fixed time,
    6 x 20, the budget of the probe, not cut) from three seeds whose
    float32 rollouts stay finite to the last knot in both packages:

    * ``two_ulp``: the tracking warm start with the first knot's elevator
      two ulps up (one ulp, the seed of the test above, leaves the port's
      finite states at knot 40);
    * ``boxed``: the tracking warm start with its surfaces clipped to the
      ±10 deg box;
    * ``trim``: the trim control held at every knot;

    each with the passage impulses at the reference's rollout's closest
    approaches, handed to both solves.  ~45 min on one CPU process.

    What holds:
    * the first inner iteration from the same trajectory and multipliers
      (the reference's rollout of ``two_ulp``): AL cost, A and B, the
      exact expansion, the gains and every line-search candidate of
      step 1/2^k (k <= 8) agree within rounding;
    * each package's own rollout of every seed parts from the other's by
      more than 1e-3 of the state within the horizon: the solves
      linearise about different trajectories from their first iteration;
    * both solves end finite, and every seed gets the same pass/miss
      verdict against the 10 m tolerance in both packages: all miss.

    What does not hold: the population tolerance (cost within 5%,
    violation within 0.3 (1 + v)).  The final costs and violations are
    printed; they part by more than that (the port's cost is the lower
    on three seeds of four tried, the higher on one)."""
    import jax
    import jax.numpy as jnp

    from aircraft_tpu.solvers import ilqr as jilqr
    from aircraft_tpu.solvers import integrators as jint
    from aircraft_tpu.solvers import ocp as jocp_mod
    from aircraft_tpu.solvers.rollout import rollout as jrollout

    from aircraft_tpu_torch.solvers import ilqr, integrators
    from aircraft_tpu_torch.solvers import ocp as tocp_mod
    from aircraft_tpu_torch.solvers.rollout import rollout

    jx, pt = course
    Np, dt, ss = 70, 0.1, 10
    u_ref, trim = _probe_controls(jx)
    seeds = {"two_ulp": u_ref.copy(), "boxed": u_ref.copy(),
             "trim": np.tile(trim[None, :7], (Np, 1)).astype(np.float32)}
    for _ in range(2):
        seeds["two_ulp"][0, 1] = np.nextafter(seeds["two_ulp"][0, 1],
                                              np.float32(np.inf))
    seeds["boxed"][:, :3] = np.clip(seeds["boxed"][:, :3], -10.0, 10.0)
    x0 = np.asarray(jx["config"].waypoints.initial_state, np.float32)
    jstep = jint.make_step_fn(jx["params"], substeps=ss, normalize="step")
    tstep = integrators.make_step_fn(pt["params"], substeps=ss,
                                     normalize="step")
    wps = np.asarray(jx["config"].waypoints.array())
    jocp = jwp.build_waypoint_ocp(jx["params"], jx["config"], dt=dt,
                                  num_nodes=Np, substeps=ss)
    tocp = wp.build_waypoint_ocp(pt["params"], pt["config"], dt=dt,
                                 num_nodes=Np, substeps=ss)
    z0, vs0 = jwp.initial_guess(jx["config"], Np, time_mode="fixed", dt=dt)
    z0 = np.asarray(z0)
    rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                             / (1.0 + np.abs(np.asarray(a)).max()))

    vss = {}
    for name, us in seeds.items():
        xr = np.asarray(jrollout(jstep, jnp.asarray(x0), jnp.asarray(us), dt))
        xp = rollout(tstep, torch.as_tensor(x0), torch.as_tensor(us),
                     dt).numpy()
        assert np.isfinite(xr).all() and np.isfinite(xp).all(), name
        gap = np.abs(xr - xp).max(1) / (1.0 + np.abs(xr).max(1))
        assert gap.max() > 1e-3, (name, gap.max())
        vs = np.array(vs0)
        vs[:, :7] = us
        vss[name] = wp._place_mu_numpy(vs, xr, wps)

    # the first inner iteration, piece by piece, from the same inputs
    vs = vss["two_ulp"]
    jxs = [jnp.asarray(z0)]
    step_jit = jax.jit(jocp.step)
    for k in range(Np):      # freeze-guarded, as the solvers' rollouts
        x_next = step_jit(jxs[-1], jnp.asarray(vs[k]), k)
        ok = bool(jnp.isfinite(x_next).all() & (jnp.abs(x_next).max() < 1e6))
        jxs.append(x_next if ok else jxs[-1])
    xs = np.asarray(jnp.stack(jxs))
    cfg = SolverConfig()
    jal = jocp_mod.init_al_state(jocp, jnp.asarray(z0), jnp.asarray(vs[0]),
                                 Np, mu0=cfg.penalty_init)
    tal = tocp_mod.init_al_state(tocp, torch.as_tensor(z0)[None],
                                 torch.as_tensor(vs[0])[None], Np,
                                 mu0=cfg.penalty_init)
    txs, tvs = torch.as_tensor(xs)[None], torch.as_tensor(vs)[None]
    c_ref = float(jocp_mod.al_total_cost(jocp, jal, xs, jnp.asarray(vs)))
    c_port = float(tocp_mod.al_total_cost(tocp, tal, txs, tvs)[0])
    assert abs(c_port - c_ref) <= 1e-4 * abs(c_ref), (c_port, c_ref)
    ks = jnp.arange(Np)
    clean = lambda t: jnp.clip(jnp.nan_to_num(t, nan=0.0, posinf=0.0,
                                              neginf=0.0), -1e6, 1e6)
    jA, jB = jax.jit(jax.vmap(lambda x, u, k: (
        clean(jax.jacfwd(lambda a: jocp.step(a, u, k))(x)),
        clean(jax.jacfwd(lambda b: jocp.step(x, b, k))(u)))))(
        xs[:-1], jnp.asarray(vs), ks)
    tA, tB = ilqr.linearize(tocp, txs, tvs)
    assert rel(jA, tA[0]) < 2e-4 and rel(jB, tB[0]) < 2e-4
    jq = jax.jit(lambda a, b: jilqr._quadraticize(jocp, jal, a, b))(
        xs, jnp.asarray(vs))
    tq = ilqr.quadraticize(tocp, tal, txs, tvs)
    for a, b in zip(jq, tq):
        assert rel(a, b[0]) < 2e-4
    san = lambda t: jnp.clip(jnp.nan_to_num(t, nan=0.0, posinf=0.0,
                                            neginf=0.0), -1e8, 1e8)
    jK, jk, _, _, _, jfail = jilqr._backward_pass(
        jA, jB, *(san(t) for t in jq), jnp.asarray(cfg.reg_init, jnp.float32))
    tK, tk, _, _, _, tfail = ilqr.backward_pass(
        tA, tB, *(ilqr._san(t, 1e8) for t in tq),
        torch.full((1,), cfg.reg_init))
    assert bool(jfail) == bool(tfail[0])
    assert rel(jK, tK[0]) < 1e-2                 # the Riccati gain tolerance
    jK = jnp.clip(jK, -cfg.gain_clip, cfg.gain_clip)
    jk = jnp.clip(jk, -cfg.gain_clip, cfg.gain_clip)
    for a in ilqr.line_search_alphas(cfg.line_search_steps)[:9]:
        _, _, jc, jn = jax.jit(lambda K, k: jilqr._forward_pass(
            jocp, jal, xs, jnp.asarray(vs), K, k,
            jnp.asarray([a], jnp.float32)))(jK, jk)
        _, _, tc, tn = ilqr.forward_pass(
            tocp, tal, txs, tvs, torch.as_tensor(np.asarray(jK))[None],
            torch.as_tensor(np.asarray(jk))[None],
            torch.tensor([a], dtype=torch.float32))
        assert int(jn) == int(tn[0]), a
        assert abs(float(tc[0]) - float(jc)) <= 1e-4 * abs(float(jc)), a

    # the solves, each from its own rollout of the shared seed
    verdicts, numbers = {}, {}
    for name, vs in vss.items():
        r = jilqr.solve(jocp, jnp.asarray(z0), jnp.asarray(vs),
                        JaxSolverConfig(max_al_iters=6, max_inner_iters=20))
        p = ilqr.solve(tocp, torch.as_tensor(z0), torch.as_tensor(vs),
                       SolverConfig(max_al_iters=6, max_inner_iters=20))
        assert bool(torch.isfinite(p.xs).all()) and np.isfinite(
            np.asarray(r.xs)).all()
        miss = {k: max(np.linalg.norm(np.asarray(xs_)[:, :3] - w, axis=1).min()
                       for w in wps)
                for k, xs_ in (("ref", r.xs), ("port", p.xs.numpy()))}
        verdicts[name] = {k: v < 10.0 for k, v in miss.items()}
        numbers[name] = {"cost": (float(r.cost), float(p.cost)),
                         "violation": (float(r.violation),
                                       float(p.violation)),
                         "max_miss_m": (miss["ref"], miss["port"])}
    print(numbers)
    for name, v in verdicts.items():
        assert v["ref"] == v["port"], (name, numbers[name])
