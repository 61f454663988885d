"""The port's IMPALA pieces against the reference on the CPU: the conv
actor-critic (``repro_torch.agents.impala``), the losses
(``repro_torch.rl.losses``) and the optimizers (``repro_torch.optim``).

Params are made by the reference's ``ConvActorCritic.init`` and moved over
with ``bridge.params_from_jax``; frames, actions and trajectories come
from numpy.  Tolerances: 1e-5 abs for forward values; 1e-5 abs + 1e-4 rel
for gradients (a sum over the batch and the conv windows in another
order); 1e-6 for optimizer updates from identical gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.agents.impala import ConvActorCritic as JaxConvActorCritic
from repro.agents.impala import ImpalaAgent as JaxImpalaAgent
from repro.core.sebulba import SebulbaConfig as JaxSebulbaConfig
from repro.data.trajectory import Trajectory as JaxTrajectory
from repro.rl import losses as jlosses
from repro_torch import bridge, optim
from repro_torch.agents.impala import ConvActorCritic, ImpalaAgent
from repro_torch.core.sebulba import SebulbaConfig
from repro_torch.data.trajectory import Trajectory
from repro_torch.rl import losses
from repro_torch.tree import leaves, tree_map, unflatten

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = dict(channels=(8, 16), blocks=1, hidden=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _jax_params(obs_shape, channels=(16, 32), blocks=1, hidden=256):
    """The reference's init, jitted and made once per shape (eager, its
    threefry draws take seconds on the CPU)."""
    net = JaxConvActorCritic(3, channels, blocks, hidden)
    return jax.jit(net.init, static_argnums=1)(jax.random.key(0), obs_shape)


def _nets(obs_shape, **kw):
    jparams = _jax_params(obs_shape, **kw)
    params = bridge.params_from_jax(_np_tree(jparams), device=CPU)
    return JaxConvActorCritic(3, **kw), jparams, ConvActorCritic(3, **kw), params


def _close(want, got, atol=1e-5, rtol=0.0) -> bool:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    return bool(np.all(np.abs(want - got) <= atol + rtol * np.abs(want)))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    return {prefix: tree}


def test_param_tree_has_the_reference_paths_shapes_dtypes():
    obs_shape = (16, 16, 1)
    jparams = _jax_params(obs_shape)
    net = ConvActorCritic(3)
    params = net.init(torch.Generator().manual_seed(0), obs_shape)
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _paths(jparams).items()}
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in _paths(params).items()}
    assert got == want
    # fan-in over HWIO's first three axes: the first conv sees 3*3*1 inputs
    w = params["conv_0"]["w"]
    assert abs(w.std().item() - 1 / 3) < 0.1
    assert all(v.device == CPU for v in leaves(params))
    again = net.init(torch.Generator().manual_seed(0), obs_shape)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(again)))


@pytest.mark.parametrize("hw", [(16, 16), (15, 15), (16, 15)])
def test_conv_actor_critic_matches_reference(hw):
    """Even and odd frame sizes: "SAME" max-pooling pads (0, 1) at 16 and
    (1, 1) at 15."""
    obs_shape = hw + (1,)
    jnet, jparams, net, params = _nets(obs_shape, **SMALL)
    obs = np.random.default_rng(1).random((5,) + obs_shape, np.float32)
    jl, jv = jnet.apply(jparams, jnp.asarray(obs))
    tl, tv = net.apply(params, torch.from_numpy(obs))
    assert tl.shape == (5, 3) and tv.shape == (5,)
    assert _close(jl, tl) and _close(jv, tv)


def _trajectory(B=4, T=5, obs_shape=(16, 16, 1), seed=2):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.random((B, T) + obs_shape, np.float32),
        actions=rng.integers(0, 3, (B, T)).astype(np.int32),
        rewards=rng.choice([-1.0, 0.0, 1.0], (B, T)).astype(np.float32),
        discounts=((rng.random((B, T)) > 0.2) * 0.99).astype(np.float32),
        behaviour_logp=np.log(rng.uniform(0.2, 0.5, (B, T))).astype(np.float32),
        bootstrap_obs=rng.random((B,) + obs_shape, np.float32),
    )


def _pair_traj(d):
    return (JaxTrajectory(**{k: jnp.asarray(v) for k, v in d.items()}),
            Trajectory(**{k: torch.from_numpy(v) for k, v in d.items()}))


def test_log_prob_entropy_and_impala_loss_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 5, 3)).astype(np.float32) * 2
    actions = rng.integers(0, 3, (4, 5)).astype(np.int32)
    tl, ta = torch.from_numpy(logits), torch.from_numpy(actions)
    assert _close(jlosses.log_prob(logits, actions), losses.log_prob(tl, ta))
    assert _close(jlosses.entropy(logits), losses.entropy(tl))
    args = [rng.standard_normal((4, 5)).astype(np.float32),  # values
            actions,
            np.log(rng.uniform(0.2, 0.5, (4, 5))).astype(np.float32),
            rng.standard_normal((4, 5)).astype(np.float32),  # rewards
            ((rng.random((4, 5)) > 0.2) * 0.99).astype(np.float32),
            rng.standard_normal((4,)).astype(np.float32)]  # bootstrap
    kw = dict(entropy_cost=0.02, value_cost=0.4, clip_rho=0.9, clip_c=0.8)
    want = jlosses.impala_loss(logits, *args, **kw)
    got = losses.impala_loss(tl, *(torch.from_numpy(a) for a in args), **kw)
    for w, g in zip(want, got):
        assert _close(w, g)


def test_loss_values_and_gradients_match_jax_grad():
    obs_shape = (16, 16, 1)
    jnet, jparams, net, params = _nets(obs_shape, **SMALL)
    jtraj, traj = _pair_traj(_trajectory(obs_shape=obs_shape))
    jagent = JaxImpalaAgent(jnet, JaxSebulbaConfig())
    agent = ImpalaAgent(net, SebulbaConfig())
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jagent.loss(p, jtraj), has_aux=True))(jparams)
    live = tree_map(lambda p: p.clone().requires_grad_(), params)
    total, aux = agent.loss(live, traj)
    grads = torch.autograd.grad(total, leaves(live))
    assert _close(jtotal, total)
    assert sorted(aux.metrics) == sorted(jaux.metrics)
    for k, v in jaux.metrics.items():
        assert _close(v, aux.metrics[k])
    want, got = _paths(jgrads), _paths(unflatten(params, list(grads)))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert _close(w, got[path], atol=1e-5, rtol=1e-4), path


def test_act_samples_valid_actions_with_their_log_probs():
    obs_shape = (16, 16, 1)
    _, _, net, params = _nets(obs_shape, **SMALL)
    agent = ImpalaAgent(net, SebulbaConfig())
    obs = torch.from_numpy(np.random.default_rng(4).random((64,) + obs_shape,
                                                           np.float32))
    a1, aux1, carry = agent.act(params, obs, torch.Generator().manual_seed(7))
    a2, _, _ = agent.act(params, obs, torch.Generator().manual_seed(7))
    assert carry == () and torch.equal(a1, a2)  # seeded
    assert ((a1 >= 0) & (a1 < 3)).all()
    logits, _ = net.apply(params, obs)
    assert torch.equal(aux1.logp, losses.log_prob(logits, a1))


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
def test_optimizers_match_reference_over_three_updates(name):
    """rmsprop(3e-4, clip_norm=1.0) (the Sebulba example's) and adam from
    the same params and gradients: params and state within 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "c": (2, 2, 3)}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 2)
                          .astype(np.float32), p0) for _ in range(3)]
    make = {"rmsprop": lambda m: m.rmsprop(3e-4, clip_norm=1.0),
            "adam": lambda m: m.adam(1e-3, clip_norm=1.0)}[name]
    jopt, opt = make(joptim), make(optim)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = bridge.params_from_jax(p0, device=CPU)
    ts = opt.init(tp)
    for g in grads:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, u)
        with torch.no_grad():
            tu, ts = opt.update(bridge.params_from_jax(g, device=CPU), ts, tp)
            out = optim.apply_updates(tp, tu)
        assert all(a is b for a, b in zip(leaves(out), leaves(tp)))
    for w, t in zip(jax.tree.leaves(jp), leaves(tp)):
        assert _close(w, t, atol=1e-6)
    jstate = [x for x in jax.tree.leaves(js) if np.ndim(x) > 0]
    tstate = [x for x in leaves(ts) if x.ndim > 0]
    assert len(jstate) == len(tstate) > 0
    for w, t in zip(jstate, tstate):
        assert _close(w, t, atol=1e-6)
    norm = joptim.global_norm(grads[0])
    assert _close(norm, optim.global_norm(
        bridge.params_from_jax(grads[0], device=CPU)))
