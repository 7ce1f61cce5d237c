"""The port's DDPG agent against the JAX package's, from the same
(JAX-drawn) initial nets, on batches drawn from identically filled replay
buffers by numpy generators of the same seed.

Tolerances: the forward passes 1e-6 (1 + |ref|); one update (critic TD
step, actor step through the updated critic, soft targets) 1e-5
(1 + |ref|) in every weight of the four nets and in the two losses, and
each weight's change within 1% of its net's learning rate of the
reference's change; five updates 1e-4 (1 + |ref|).  Adam moves a weight
by about the learning rate whatever the size of its gradient, so where a
gradient is near Adam's eps (1e-8) its rounding shows in the step: the
measured worst is 0.2% of the learning rate after one update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aircraft_tpu.rl import ddpg as jd

from aircraft_tpu_torch.rl import ddpg as td

OBS, ACT, HIDDEN = 13, 3, (256, 128)


def _jax_agent(seed=0):
    return jd.DDPGAgent(OBS, ACT, seed=seed, hidden=HIDDEN)


def _layers(mlp):
    return [(np.asarray(w), np.asarray(b)) for w, b in mlp.layers]


def _port_agent(jagent):
    p = jagent.params
    params = td.ddpg_params_from_numpy(_layers(p.actor), _layers(p.critic),
                                       _layers(p.target_actor),
                                       _layers(p.target_critic), device="cpu")
    return td.DDPGAgent(OBS, ACT, params=params, device="cpu")


def _nets(params):
    return [params.actor, params.critic, params.target_actor,
            params.target_critic]


def _arrays(mlp):
    return [t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for layer in mlp.layers for t in layer]


def _assert_close(port, ref, tol):
    for pn, rn in zip(_nets(port), _nets(ref)):
        for g, w in zip(_arrays(pn), _arrays(rn)):
            assert g.shape == w.shape
            assert np.all(np.abs(g - w) <= tol * (1 + np.abs(w))), np.max(
                np.abs(g - w))


def _buffers(n=512, seed=0):
    rng = np.random.default_rng(seed)
    bufs = (jd.ReplayBuffer(1000, OBS, ACT),
            td.ReplayBuffer(1000, OBS, ACT, device="cpu"))
    for _ in range(n):
        row = (rng.normal(0, 1, OBS).astype(np.float32),
               rng.uniform(-5, 5, ACT).astype(np.float32),
               float(rng.normal()), rng.normal(0, 1, OBS).astype(np.float32),
               bool(rng.random() < 0.05))
        for b in bufs:
            b.add(*row)
    return bufs


def test_converters_copy_and_never_alias():
    ja = _jax_agent()
    p = td.ddpg_params_from_numpy(_layers(ja.params.actor),
                                  _layers(ja.params.critic), device="cpu")
    for pn, rn in zip(_nets(p), _nets(ja.params)):
        for g, w in zip(_arrays(pn), _arrays(rn)):
            np.testing.assert_array_equal(g, w)
    ptrs = [t.data_ptr() for net in _nets(p) for t in net.tensors()]
    assert len(set(ptrs)) == len(ptrs)
    agent = td.DDPGAgent(OBS, ACT, params=td.DDPGParams(
        p.actor, p.critic, p.actor, p.critic), device="cpu")
    ptrs = [t.data_ptr() for net in _nets(agent.params) for t in net.tensors()]
    assert len(set(ptrs)) == len(ptrs)


def test_mlp_apply_and_act_match():
    ja = _jax_agent(1)
    pa = _port_agent(ja)
    x = np.random.default_rng(1).normal(0, 1, (64, OBS)).astype(np.float32)
    for tanh in (False, True):
        want = np.asarray(jd.mlp_apply(ja.params.actor, jnp.asarray(x),
                                       final_tanh=tanh))
        got = td.mlp_apply(pa.params.actor, torch.as_tensor(x),
                           final_tanh=tanh).detach().numpy()
        assert np.all(np.abs(got - want) <= 1e-6 * (1 + np.abs(want)))
    noise = np.array([0.3, -9.0, 0.1])
    np.testing.assert_allclose(pa.act(x[0], noise), ja.act(x[0], noise),
                               rtol=1e-6, atol=1e-6)


def test_buffer_samples_and_noises_are_identical():
    jb, tb = _buffers(300)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        want, got = jb.sample(r1, 64), tb.sample(r2, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a, b = (m.OUNoise(3, sigma=0.3, rng=np.random.default_rng(5))
            for m in (jd, td))
    for _ in range(5):
        np.testing.assert_array_equal(a.sample(), b.sample())
    a.reset(), b.reset()
    np.testing.assert_array_equal(a.sample(), b.sample())
    ja, ta = (m.EpsilonGreedy(rng=np.random.default_rng(6)) for m in (jd, td))
    for _ in range(20):
        np.testing.assert_array_equal(ja.select(np.zeros(3), -5, 5),
                                      ta.select(np.zeros(3), -5, 5))
    assert ja.eps == ta.eps
    agent = _jax_agent(2)
    jn = jd.ParameterSpaceNoise(rng=np.random.default_rng(7))
    tn = td.ParameterSpaceNoise(rng=np.random.default_rng(7))
    pert_j = jn.perturb(agent.params.actor)
    pert_t = tn.perturb(td.mlp_params_from_numpy(_layers(agent.params.actor),
                                                 device="cpu"))
    for g, w in zip(_arrays(pert_t), _arrays(pert_j)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    for d in (0.1, 0.5):
        jn.update(d), tn.update(d)
    assert jn.std == tn.std


@pytest.mark.parametrize("updates,tol", [(1, 1e-5), (5, 1e-4)])
def test_updates_match(updates, tol):
    ja = _jax_agent(3)
    pa = _port_agent(ja)
    before = [[a.copy() for a in _arrays(n)] for n in _nets(pa.params)]
    jb, tb = _buffers()
    r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
    for _ in range(updates):
        jl = ja.train_step(jb.sample(r1, 64))
        tl = pa.train_step(tb.sample(r2, 64))
        for g, w in zip(tl, jl):
            assert abs(g - w) <= tol * (1 + abs(w)), (tl, jl)
    _assert_close(pa.params, ja.params, tol)
    if updates == 1:
        lrs = (pa.actor_opt.defaults["lr"], pa.critic_opt.defaults["lr"])
        for net, (pn, rn, b0) in enumerate(zip(_nets(pa.params)[:2],
                                               _nets(ja.params)[:2], before)):
            for g, w, b in zip(_arrays(pn), _arrays(rn), b0):
                assert np.all(np.abs((g - b) - (w - b)) <= 0.01 * lrs[net])


def test_soft_targets_move_and_are_not_aliased():
    ja = _jax_agent(4)
    pa = _port_agent(ja)
    before = {n: [a.copy() for a in _arrays(getattr(pa.params, n))]
              for n in ("target_actor", "target_critic")}
    _, tb = _buffers(256)
    pa.train_step(tb.sample(np.random.default_rng(9), 64))
    tau = pa.tau
    for tgt, src in (("target_actor", "actor"), ("target_critic", "critic")):
        after = _arrays(getattr(pa.params, tgt))
        online = _arrays(getattr(pa.params, src))
        moved = False
        for a0, a1, s in zip(before[tgt], after, online):
            np.testing.assert_allclose(a1, (1 - tau) * a0 + tau * s,
                                       rtol=1e-6, atol=1e-9)
            assert not np.array_equal(a1, s) or np.array_equal(a0, s)
            moved |= not np.array_equal(a1, a0)
        assert moved, tgt


def test_the_actor_step_leaves_the_critic_alone():
    """The actor's loss runs through the critic just updated; its gradient
    reaches neither the critic's weights nor the critic's Adam state: after
    an update the critic's gradients are those of the critic loss alone,
    and Adam's first moment is (1 - 0.9) times them."""
    ja = _jax_agent(5)
    pa = _port_agent(ja)
    _, tb = _buffers(256)
    batch = tb.sample(np.random.default_rng(10), 64)
    p = pa.params
    with torch.no_grad():
        next_a = td.mlp_apply(p.target_actor, batch.next_obs,
                              final_tanh=True) * pa.action_scale
        q_next = td.mlp_apply(p.target_critic, torch.cat(
            [batch.next_obs, next_a], -1))[..., 0]
        target = batch.reward + pa.gamma * (1.0 - batch.done) * q_next
    critic0 = [t.detach().clone() for t in p.critic.tensors()]

    def critic_loss(ts):
        layers = tuple(zip(ts[0::2], ts[1::2]))
        q = td.mlp_apply(td.MLPParams(layers=layers), torch.cat(
            [batch.obs, batch.action], -1))[..., 0]
        return torch.mean((q - target) ** 2)

    want = torch.func.grad(critic_loss)(critic0)
    pa.train_step(batch)
    for t, g in zip(p.critic.tensors(), want):
        torch.testing.assert_close(t.grad, g, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(pa.critic_opt.state[t]["exp_avg"],
                                   0.1 * g, rtol=1e-5, atol=1e-10)


def test_curriculum_matches():
    results = [True] * 50 + [False] * 10 + [True] * 60 + [True] * 45
    a, b = jd.CurriculumLearning(), td.CurriculumLearning()
    for r in results:
        assert a.record(r) == b.record(r)
        assert a.stage == b.stage and a.stage_idx == b.stage_idx
    assert b.stage_idx > 0
    assert td.DEFAULT_CURRICULUM == tuple(jd.DEFAULT_CURRICULUM)
