"""The port's on-policy Sebulba (``repro_torch.core.sebulba``) and its host
environments against the reference on the CPU.

  * ``HostPong`` fed the reference's spawn draws steps bit-identically to
    the reference's ``HostPong``; its own spawn stream is seeded.
  * One learner update from the same params (made by the reference's init)
    and the same trajectory matches the reference's own update function
    (``Sebulba._get_update``'s core: ``ImpalaAgent.loss`` + rmsprop) within
    1e-5, for one and for two microbatches.
  * The slice as a whole, at a small size, returns the reference's result
    schema with consistent counters, and fails loudly where it must.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import optim as joptim
from repro.agents.impala import ConvActorCritic as JaxConvActorCritic
from repro.core.sebulba import Sebulba as JaxSebulba
from repro.core.sebulba import SebulbaConfig as JaxSebulbaConfig
from repro.data.trajectory import Trajectory as JaxTrajectory
from repro.envs.host_env import HostPong as JaxHostPong
from repro.envs.pong import spawn_ball as jax_spawn_ball
from repro_torch import api, bridge, optim
from repro_torch.agents.impala import ConvActorCritic, ImpalaAgent
from repro_torch.api import AgentSpec
from repro_torch.core.sebulba import Sebulba, SebulbaConfig
from repro_torch.data.trajectory import Trajectory
from repro_torch.envs import BatchedHostEnv, HostPong, spawn_ball
from repro_torch.launch import sebulba_impala
from repro_torch.tree import leaves, unflatten

torch.set_num_threads(2)

CPU = torch.device("cpu")
TINY = dict(channels=(8,), blocks=1, hidden=32)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    return {prefix: tree}


# ------------------------------------------------------------------- envs


def test_host_pong_with_injected_spawns_matches_reference():
    """200 steps of a fixed action sequence through several episodes:
    frames, rewards and dones bit-identical."""
    seed, h, w = 3, 8, 7
    key = jax.random.key(seed)
    draws = {}

    def spawn(n):
        if n not in draws:
            x, vx = jax_spawn_ball(key, n, w)
            draws[n] = (float(x), float(vx))
        return draws[n]

    ref = JaxHostPong(h, w, max_lives=2, seed=seed)
    port = HostPong(h, w, max_lives=2, spawn=spawn)
    assert np.array_equal(ref.reset(), port.reset())
    actions = np.random.default_rng(0).integers(0, 3, 200)
    episodes = 0
    for a in actions:
        ro, rr, rd, _ = ref.step(int(a))
        po, pr, pd, _ = port.step(int(a))
        assert np.array_equal(ro, po) and rr == pr and rd == pd
        assert ro.dtype == po.dtype == np.float32
        if rd:
            episodes += 1
            assert np.array_equal(ref.reset(), port.reset())
    assert episodes >= 3 and len(draws) > episodes


def test_port_spawn_stream_is_seeded_and_in_range():
    a = [spawn_ball(7, n, 16) for n in range(200)]
    assert a == [spawn_ball(7, n, 16) for n in range(200)]
    assert a != [spawn_ball(8, n, 16) for n in range(200)]
    xs = {x for x, _ in a}
    assert xs == {float(x) for x in range(1, 15)}  # every column in [1, 14]
    assert {v for _, v in a} == {-1.0, 1.0}
    env1, env2 = HostPong(seed=5), HostPong(seed=5)
    for act in np.random.default_rng(1).integers(0, 3, 100):
        o1, r1, d1, _ = env1.step(int(act))
        o2, r2, d2, _ = env2.step(int(act))
        assert np.array_equal(o1, o2) and r1 == r2 and d1 == d2
        if d1:
            env1.reset(), env2.reset()
    env = HostPong(6, 6, max_lives=1, seed=0)
    done = False
    for _ in range(200):
        if done:
            break
        _, _, done, _ = env.step(0)  # hug the left wall: misses come
    assert done
    with pytest.raises(RuntimeError, match="reset"):
        env.step(1)


def test_batched_host_env_batches_auto_resets_and_closes():
    env = BatchedHostEnv(lambda i: HostPong(6, 6, max_lives=1, seed=i), 5)
    obs = env.reset()
    assert obs.shape == (5, 6, 6, 1) and obs.dtype == np.float32
    dones_seen = 0
    for _ in range(12):
        obs, rewards, dones = env.step(np.ones(5, np.int64))
        assert obs.shape == (5, 6, 6, 1) and rewards.shape == dones.shape == (5,)
        dones_seen += int(dones.sum())
    assert dones_seen > 0  # episodes ended and were reset, never raised
    env.close()
    env.close()  # idempotent
    assert BatchedHostEnv._shared_pool is None


# ---------------------------------------------------------------- learner


def _trajectory(B, T, obs_shape, seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.random((B, T) + obs_shape, np.float32),
        actions=rng.integers(0, 3, (B, T)).astype(np.int32),
        rewards=rng.choice([-1.0, 0.0, 1.0], (B, T)).astype(np.float32),
        discounts=((rng.random((B, T)) > 0.2) * 0.99).astype(np.float32),
        behaviour_logp=np.log(rng.uniform(0.2, 0.5, (B, T))).astype(np.float32),
        bootstrap_obs=rng.random((B,) + obs_shape, np.float32),
    )


def _host_envs():
    return dict(env_factory=lambda seed: HostPong(8, 8, seed=seed),
                make_batched_env=lambda f, n: BatchedHostEnv(f, n))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_learner_update_matches_reference(microbatches):
    B, T, obs_shape = 4, 5, (8, 8, 1)
    jcfg = JaxSebulbaConfig(actor_batch_size=B, trajectory_length=T,
                            learner_microbatches=microbatches,
                            entropy_cost=0.02, clip_rho=0.9)
    jseb = JaxSebulba(
        env_factory=lambda seed: JaxHostPong(8, 8, seed=seed),
        make_batched_env=lambda f, n: None,
        network=JaxConvActorCritic(3, **TINY),
        optimizer=joptim.rmsprop(3e-4, clip_norm=1.0),
        config=jcfg, devices=jax.devices()[:1],
    )
    jparams = jax.jit(jseb.agent.init, static_argnums=1)(jax.random.key(1),
                                                        obs_shape)
    data = _trajectory(B, T, obs_shape, seed=9)
    jt = JaxTrajectory(**{k: jnp.asarray(v) for k, v in data.items()})
    _, core = jseb._get_update(jt)
    want_p, _, want_m = jax.jit(core)(jparams, jseb.opt.init(jparams), jt)

    cfg = SebulbaConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(SebulbaConfig)})
    seb = Sebulba(**_host_envs(), network=ConvActorCritic(3, **TINY),
                  optimizer=optim.rmsprop(3e-4, clip_norm=1.0), config=cfg,
                  device="cpu")
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device=CPU)
    traj = Trajectory(**{k: torch.from_numpy(v) for k, v in data.items()})
    with torch.no_grad():
        new, _, macc = seb._update(params, seb.opt.init(params), traj, None)
    assert all(a is b for a, b in zip(leaves(new), leaves(params)))  # in place
    got_p = _paths(new)
    for path, w in _paths(want_p).items():
        assert np.abs(np.asarray(w) - got_p[path].numpy()).max() <= 1e-5, path
    got_m = seb._drain_macc(macc)
    assert sorted(got_m) == sorted(want_m)
    for k, v in want_m.items():
        assert abs(float(v) - got_m[k]) <= 1e-5, k


# ------------------------------------------------------------ the slice


@pytest.mark.parametrize("threads", [1, 2])
def test_fit_on_cpu_returns_the_reference_result_schema(threads):
    cfg = SebulbaConfig(actor_batch_size=4, trajectory_length=5,
                        threads_per_actor_core=threads)
    seb = Sebulba(**_host_envs(), network=ConvActorCritic(3, **TINY),
                  optimizer=optim.rmsprop(3e-4, clip_norm=1.0), config=cfg,
                  device="cpu")
    out = seb.fit(0, total_frames=200)
    assert api.RESULT_KEYS == japi.RESULT_KEYS
    assert set(out) == set(japi.RESULT_KEYS)
    assert out["updates"] >= 2
    assert out["param_version"] == out["updates"] + 1
    assert out["publishes_sent"] + out["publishes_skipped"] == \
        out["param_version"]
    assert out["frames"] >= 200 and out["fps"] > 0
    assert sorted(out["metrics"]) == ["entropy", "loss", "pg", "rho", "value"]
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert all(torch.isfinite(x).all() for x in leaves(out["params"]))
    assert out["actor_restarts"] == out["replay_size"] == 0
    assert not any(a.thread.is_alive() for a in seb._actors)
    assert len(seb._actors) == threads


def test_fit_under_thread_stress_keeps_its_counters():
    """Ten actor threads (more than this machine's cores) and a short
    interpreter switch interval: the versioned publish and the per-thread
    counters still add up."""
    cfg = SebulbaConfig(actor_batch_size=2, trajectory_length=3,
                        threads_per_actor_core=10, queue_capacity=2)
    seb = Sebulba(**_host_envs(), network=ConvActorCritic(3, **TINY),
                  optimizer=optim.sgd(1e-3), config=cfg, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = seb.fit(0, total_frames=600)
    finally:
        sys.setswitchinterval(old)
    assert not any(a.thread.is_alive() for a in seb._actors)
    assert out["param_version"] == out["updates"] + 1
    assert out["publishes_sent"] + out["publishes_skipped"] == \
        out["param_version"]
    assert out["frames"] == sum(a.frames for a in seb._actors) >= 600
    assert out["updates"] * 2 * 3 <= out["frames"]


class _FailingPong(HostPong):
    def step(self, action):
        if self._spawn_n > 1 or getattr(self, "_steps", 0) > 6:
            raise ValueError("env exploded")
        self._steps = getattr(self, "_steps", 0) + 1
        return super().step(action)


def test_an_actor_that_raises_makes_fit_raise():
    seb = Sebulba(env_factory=lambda seed: _FailingPong(8, 8, seed=seed),
                  make_batched_env=lambda f, n: BatchedHostEnv(f, n),
                  network=ConvActorCritic(3, **TINY),
                  optimizer=optim.rmsprop(3e-4),
                  config=SebulbaConfig(actor_batch_size=2,
                                       trajectory_length=3),
                  device="cpu")
    with pytest.raises(RuntimeError, match="actor thread") as info:
        seb.fit(0, total_frames=10_000)
    assert isinstance(info.value.__cause__, ValueError)
    assert not any(a.thread.is_alive() for a in seb._actors)


class _RecurrentAgent(ImpalaAgent):
    spec = AgentSpec(recurrent=True)

    def initial_carry(self, batch):
        return torch.zeros(batch, 4)


class _ExtrasAgent(ImpalaAgent):
    spec = AgentSpec(extras_keys=("visits",))


def test_unported_options_raise_not_implemented():
    net = ConvActorCritic(3, **TINY)
    base = dict(**_host_envs(), network=net, optimizer=optim.sgd(0.1),
                device="cpu")
    for kw, item in (
        (dict(device_env=object()), "#4"),
        (dict(config=SebulbaConfig(replay=object())), "#5"),
        (dict(config=SebulbaConfig(burn_in=2)), "#6"),
        (dict(fault_plan=object()), "#8"),
        (dict(cluster=object()), "#8"),
        (dict(device=["cpu", "meta"]), "#12"),
        (dict(agent=_RecurrentAgent(net, SebulbaConfig())), "#6"),
        (dict(agent=_ExtrasAgent(net, SebulbaConfig())), "#7"),
    ):
        with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
            Sebulba(**{**base, **kw})
    seb = Sebulba(**base)
    for kw in (dict(checkpoint_dir="ckpt"), dict(checkpoint_every=5),
               dict(restore_from="ckpt"), dict(auto_resume=True)):
        with pytest.raises(NotImplementedError, match="checkpoints"):
            seb.fit(0, total_frames=10, **kw)
    assert seb._actors == []  # refused before any actor started


def test_agents_must_declare_a_spec():
    class NoSpec:
        def init(self, g, s): ...
        def initial_carry(self, b): return ()
        def act(self, params, obs, gen, carry=()): ...
        def loss(self, params, traj, weights=None): ...

    with pytest.raises(ValueError, match="AgentSpec"):
        api.resolve_agent(NoSpec())
    NoSpec.spec = AgentSpec()
    assert api.resolve_agent(NoSpec())[1] == AgentSpec()
    NoSpec.act = lambda self, params, obs, gen, temperature=1.0: None
    with pytest.raises(ValueError, match="carry"):
        api.resolve_agent(NoSpec())


def test_entry_points_default_to_the_card():
    kw = dict(**_host_envs(), network=ConvActorCritic(3, **TINY),
              optimizer=optim.sgd(0.1))
    if torch.cuda.is_available():
        assert Sebulba(**kw).split.learner_devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Sebulba(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        sebulba_impala.main(["--frames", "10"])


def test_cli_twin_runs_on_cpu(capsys):
    out = sebulba_impala.main(["--device", "cpu", "--frames", "300",
                               "--actor-batch", "4", "--trajectory", "5"])
    text = capsys.readouterr().out
    assert "device: cpu" in text and "FPS" in text
    assert out["frames"] >= 300 and out["updates"] >= 1
    assert out["param_version"] == out["updates"] + 1
    conv = out["params"]["conv_1"]["w"]
    assert conv.shape == (3, 3, 16, 32)  # the example's full width
    assert out["params"]["trunk"]["w"].shape == (4 * 4 * 32, 256)
    assert unflatten(out["params"], leaves(out["params"])).keys() == \
        out["params"].keys()
