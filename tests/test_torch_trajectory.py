"""The port's trajectory ring (``repro_torch.data.trajectory``) and device
split (``repro_torch.core.topology``) against the reference on the CPU.

The ring is driven as a Sebulba actor drives it (drain when full, then
add) over two and a half trajectories of numpy-made steps, through the
wraparound and the one-step reward lag; every drained trajectory and the
ring left at the end must equal the reference's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import trajectory as jtraj
from repro_torch.core.topology import CoreSplit, split_devices
from repro_torch.data import trajectory as ttraj

B, T, OBS = 3, 4, (5, 5, 1)


def _steps(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.random((B,) + OBS, np.float32),
               rng.integers(0, 3, (B,)).astype(np.int32),
               np.log(rng.uniform(0.1, 1.0, (B,))).astype(np.float32),
               np.stack([rng.choice([-1.0, 0.0, 1.0], B),
                         (rng.random(B) > 0.3) * 0.99]).astype(np.float32))


def _eq(j, t) -> bool:
    return np.array_equal(np.asarray(j), t.numpy())


def test_ring_add_and_drain_match_reference_bit_for_bit():
    spec = lambda shape, dt: jax.ShapeDtypeStruct(shape, dt)
    jbuf = jtraj.device_buffer_init(T, spec((B,) + OBS, jnp.float32),
                                    spec((B,), jnp.int32),
                                    spec((B,), jnp.float32))
    tbuf = None
    jdone, tdone = [], []
    t = 0
    for obs, act, logp, rew_disc in _steps(T * 2 + T // 2):
        to = [torch.from_numpy(x) for x in (obs, act, logp, rew_disc)]
        if t == T:
            j, jbuf = jtraj.buffer_drain(jbuf, jnp.asarray(rew_disc),
                                         jnp.asarray(obs))
            g, tbuf = ttraj.buffer_drain(tbuf, to[3], to[0])
            jdone.append(j)
            tdone.append(g)
            assert tbuf.t == 0 and not tbuf.has_prev
            t = 0
        jbuf = jtraj.buffer_add(jbuf, jnp.asarray(obs), jnp.asarray(act),
                                jnp.asarray(logp), (), jnp.asarray(rew_disc))
        if tbuf is None:
            tbuf = ttraj.device_buffer_init(T, to[0], to[1], to[2])
        assert ttraj.buffer_add(tbuf, to[0], to[1], to[2], to[3]) is tbuf
        t += 1
    assert len(tdone) == 2
    for j, g in zip(jdone, tdone):
        for field in ("obs", "actions", "rewards", "discounts",
                      "behaviour_logp", "bootstrap_obs"):
            assert _eq(getattr(j, field), getattr(g, field)), field
        assert g.extras == () and g.init_carry == ()
    # and the half-filled ring left at the end
    for field in ("obs", "actions", "rewards", "discounts", "behaviour_logp"):
        assert _eq(getattr(jbuf, field), getattr(tbuf, field)), field
    assert int(jbuf.t) == tbuf.t and bool(jbuf.has_prev) == tbuf.has_prev


def test_first_add_after_init_writes_no_reward():
    obs, act, logp, rew_disc = next(_steps(1, seed=3))
    to = [torch.from_numpy(x) for x in (obs, act, logp, rew_disc)]
    buf = ttraj.device_buffer_init(T, to[0], to[1], to[2])
    ttraj.buffer_add(buf, *to)
    assert (buf.rewards == 0).all() and (buf.discounts == 0).all()
    ttraj.buffer_add(buf, *to)
    assert torch.equal(buf.rewards[:, 0], to[3][0])
    assert torch.equal(buf.discounts[:, 0], to[3][1])
    assert (buf.rewards[:, 1:] == 0).all()


def test_drain_hands_over_the_ring_tensors_and_starts_a_fresh_ring():
    steps = [[torch.from_numpy(x) for x in s] for s in _steps(T, seed=4)]
    buf = ttraj.device_buffer_init(T, *steps[0][:3])
    for s in steps:
        ttraj.buffer_add(buf, *s)
    ring = buf.tensors()
    traj, fresh = ttraj.buffer_drain(buf, steps[-1][3], steps[-1][0])
    assert traj.obs is ring[0] and traj.actions is ring[1]  # no copy
    assert all(not x.any() for x in fresh.tensors())
    assert all(f.data_ptr() != r.data_ptr()
               for f, r in zip(fresh.tensors(), ring))
    assert fresh.t == 0 and not fresh.has_prev


@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_for_learners_matches_reference(n):
    rng = np.random.default_rng(n)
    fields = dict(
        obs=rng.random((6, T) + OBS, np.float32),
        actions=rng.integers(0, 3, (6, T)).astype(np.int32),
        rewards=rng.random((6, T), np.float32),
        discounts=rng.random((6, T), np.float32),
        behaviour_logp=rng.random((6, T), np.float32),
        bootstrap_obs=rng.random((6,) + OBS, np.float32),
    )
    want = jtraj.split_for_learners(
        jtraj.Trajectory(**{k: jnp.asarray(v) for k, v in fields.items()}), n)
    got = ttraj.split_for_learners(
        ttraj.Trajectory(**{k: torch.from_numpy(v)
                            for k, v in fields.items()}), n)
    assert len(got) == len(want) == n
    for j, g in zip(want, got):
        for field in fields:
            assert _eq(getattr(j, field), getattr(g, field))
        assert g.extras == ()
    with pytest.raises(ValueError):
        ttraj.split_for_learners(got[0], 4)


def test_split_devices_and_the_single_device_fallback():
    cpu = torch.device("cpu")
    one = split_devices(2, ["cpu"])
    assert one == CoreSplit(actor_devices=(cpu,), learner_devices=(cpu,))
    assert one.num_actors == one.num_learners == 1
    devs = [torch.device("cuda", i) for i in range(4)]  # names only
    split = split_devices(1, devs)
    assert split.actor_devices == tuple(devs[:1])
    assert split.learner_devices == tuple(devs[1:]) and split.num_learners == 3
    for bad in (0, 4):
        with pytest.raises(ValueError, match="cannot split"):
            split_devices(bad, devs)
