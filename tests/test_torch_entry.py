"""The port's entry module and tensor-parallel mesh against the reference.

* ``entry()``'s flagship step (RK4, 10 substeps, B=256, the reference's
  ``MLPCoeffParams.init(PRNGKey(0))`` handed in as numpy) within 2e-4
  (1 + |ref|) of ``__graft_entry__.entry()``'s jitted step.
* ``dryrun_multichip`` at gloo worlds 1 (1 x 1), 2 (1 x 2) and 4 (2 x 2)
  runs its three steps; every rank holds the mesh coordinates r // tp,
  r % tp, the same loss and the same gathered MLP; the tensor-parallel
  Adam step matches an unsharded JAX ``value_and_grad`` +
  ``optax.adam(1e-3)`` step on the same batch within 1e-5 (1 + |ref|), in
  the loss and in every leaf.  The three worlds start at once (their
  ranks wait on their processes, not on this interpreter).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from aircraft_tpu.dynamics.coefficients import MLPCoeffParams as JMLP
from aircraft_tpu.dynamics.coefficients import mlp_forward as jforward
from aircraft_tpu.surrogates.models import weighted_mse as jmse

from aircraft_tpu_torch import entry
from aircraft_tpu_torch.dynamics.coefficients import MLP_KEYS

TP_TOL = 1e-5


def _init():
    return JMLP.init(jax.random.PRNGKey(0))


def _arrays(p):
    return {k: np.asarray(getattr(p, k)) for k in MLP_KEYS}


def _err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return float(np.max(np.abs(a - ref) / (1.0 + np.abs(ref))))


def test_entry_step_matches_reference():
    fn_ref, (x0, us) = graft.entry()
    ref = np.asarray(jax.jit(fn_ref)(x0, us))
    mlp = _arrays(graft._flagship()[1].coeff)
    np.testing.assert_array_equal(mlp["w0"], _arrays(_init())["w0"])
    fn, (x0_t, us_t) = entry.entry(device="cpu", mlp=mlp)
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0))
    assert x0_t.shape == (256, 13) and us_t.shape == (256, 7)
    out = fn(x0_t, us_t).numpy()
    assert np.isfinite(out).all()
    assert _err(out, ref) <= 2e-4


def _jax_step(init, xb, yb):
    p = JMLP(**{k: jnp.asarray(v) for k, v in _arrays(init).items()})
    loss, grads = jax.value_and_grad(
        lambda pp: jmse(jforward(pp, xb), yb, jnp.ones(6)))(p)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(p))
    return float(loss), optax.apply_updates(p, updates)


WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def dryruns():
    arrays = _arrays(_init())
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(entry.dryrun_multichip, n, device="cpu",
                                  mlp=arrays) for n in WORLDS}
        return {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_and_tensor_parallel_step(world, dryruns):
    init = _init()
    recs = dryruns[world]
    tp = 2 if world % 2 == 0 else 1
    assert [r["coords"] for r in recs] == [(r // tp, r % tp)
                                          for r in range(world)]
    assert all(r["shape"] == (world // tp, tp) for r in recs)
    for r in recs[1:]:
        assert r["loss"] == recs[0]["loss"]
        for k in MLP_KEYS:
            np.testing.assert_array_equal(r["mlp"][k], recs[0]["mlp"][k])
    assert all(np.isfinite(r["mean_cost"]) and r["riccati_max_abs_dK"] <= 5e-3
               for r in recs)

    rec = recs[0]
    for k in MLP_KEYS:
        np.testing.assert_array_equal(rec["init"][k], np.asarray(getattr(init, k)))
    loss, after = _jax_step(init, jnp.asarray(rec["xb"]), jnp.asarray(rec["yb"]))
    assert rec["xb"].shape == (4 * world, 5)
    assert abs(rec["loss"] - loss) <= TP_TOL * (1 + abs(loss))
    for k in MLP_KEYS:
        assert _err(rec["mlp"][k], getattr(after, k)) <= TP_TOL, k
    moved = [k for k in MLP_KEYS
             if not np.array_equal(rec["mlp"][k], rec["init"][k])]
    assert set(moved) == set(MLP_KEYS)


def test_make_mesh_refuses_a_tp_that_does_not_divide(monkeypatch):
    from aircraft_tpu_torch.parallel import mesh as mesh_mod

    one = mesh_mod.Mesh(rank=0, size=3, device=torch.device("cpu"))
    monkeypatch.setattr(mesh_mod, "current_mesh", lambda device: one)
    with pytest.raises(ValueError, match="tp=2"):
        mesh_mod.make_mesh(3, tp=2, device="cpu")
    assert mesh_mod.make_mesh(3, tp=1, device="cpu") is one
