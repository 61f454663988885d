"""IMPALA for Sebulba: the conv actor-critic network and the V-trace
agent, ported from ``repro/agents/impala.py``.

The parameter tree is the reference's, path for path and shape for shape:
conv weights are HWIO and frames NHWC at every public function, so a tree
moved over from JAX (``bridge.params_from_jax``) applies as it is.  The
convolutions permute to PyTorch's OIHW / NCHW when they run, and the
features return to NHWC order before the trunk's flatten, so the
``(h*w*c, hidden)`` trunk weight meets the vector it was made for.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.api import ActAux, AgentSpec, LossAux
from repro_torch.param import ParamBuilder, fan_in_init, zeros_init
from repro_torch.rl import losses


def _conv(params, x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 1, "SAME" (one row and column of zeros each side) on
    NCHW ``x`` with the HWIO weight."""
    w = params["w"].permute(3, 2, 0, 1)
    return F.conv2d(x, w, params["b"], padding=1)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool, stride 2, "SAME", as ``lax.reduce_window`` with -inf
    padding does it: the total pad of an axis of n is
    max((ceil(n/2) - 1) * 2 + 3 - n, 0), low = total // 2 and high the rest
    (for n = 16: (0, 1)), which ``max_pool2d(padding=1)`` would not give."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, kernel_size=3, stride=2)


def init_conv_torso(b: ParamBuilder, obs_shape: tuple[int, ...],
                    channels: Sequence[int], blocks: int, hidden: int) -> None:
    """Residual conv stack + trunk params (the IMPALA "shallow" torso)."""
    h, w, c = obs_shape
    for i, ch in enumerate(channels):
        with b.scope(f"conv_{i}"):
            b.param("w", (3, 3, c, ch), fan_in_init())
            b.param("b", (ch,), zeros_init())
        for j in range(blocks):
            for k in (0, 1):
                with b.scope(f"res_{i}_{j}_{k}"):
                    b.param("w", (3, 3, ch, ch), fan_in_init())
                    b.param("b", (ch,), zeros_init())
        c = ch
        h, w = -(-h // 2), -(-w // 2)
    with b.scope("trunk"):
        b.param("w", (h * w * c, hidden), fan_in_init())
        b.param("b", (hidden,), zeros_init())


def apply_conv_torso(params, obs: torch.Tensor, channels: Sequence[int],
                     blocks: int) -> torch.Tensor:
    """obs (B, H, W, C) -> trunk features (B, hidden)."""
    x = obs.permute(0, 3, 1, 2)
    for i in range(len(channels)):
        x = _max_pool_same(_conv(params[f"conv_{i}"], x))
        for j in range(blocks):
            y = _conv(params[f"res_{i}_{j}_0"], F.relu(x))
            x = x + _conv(params[f"res_{i}_{j}_1"], F.relu(y))
    x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.relu(x @ params["trunk"]["w"] + params["trunk"]["b"])


class ConvActorCritic:
    def __init__(self, num_actions: int, channels: Sequence[int] = (16, 32),
                 blocks: int = 1, hidden: int = 256):
        self.num_actions = num_actions
        self.channels = tuple(channels)
        self.blocks = blocks
        self.hidden = hidden

    def init(self, generator: torch.Generator,
             obs_shape: tuple[int, ...]) -> dict:
        """float32 params drawn from ``generator``, on its device."""
        b = ParamBuilder(generator, torch.float32, generator.device)
        init_conv_torso(b, obs_shape, self.channels, self.blocks, self.hidden)
        with b.scope("policy"):
            b.param("w", (self.hidden, self.num_actions), fan_in_init(0.01))
            b.param("b", (self.num_actions,), zeros_init())
        with b.scope("value"):
            b.param("w", (self.hidden, 1), fan_in_init())
            b.param("b", (1,), zeros_init())
        return b.build()

    def apply(self, params, obs: torch.Tensor):
        """obs (B, H, W, C) -> (logits (B, A), values (B,))."""
        x = apply_conv_torso(params, obs, self.channels, self.blocks)
        logits = x @ params["policy"]["w"] + params["policy"]["b"]
        values = (x @ params["value"]["w"] + params["value"]["b"])[:, 0]
        return logits, values


class ImpalaAgent:
    """The default Sebulba agent: batched-inference actor + V-trace
    learner; feed-forward, on-policy, no extras."""

    spec = AgentSpec()

    def __init__(self, network, config):
        self.net = network
        self.cfg = config  # a SebulbaConfig (loss coefficients + clips)

    def init(self, generator: torch.Generator, obs_shape):
        return self.net.init(generator, obs_shape)

    def initial_carry(self, batch: int):
        return ()

    def act(self, params, obs, generator: torch.Generator, carry=()):
        """(params, obs (B, ...), generator, () carry) -> (actions (B,)
        int64, ActAux(logp (B,)), () carry).  The draw is Gumbel-max on
        exponential noise from ``generator`` (the reference draws with
        ``jax.random.categorical``, which torch cannot reproduce)."""
        logits, _ = self.net.apply(params, obs)
        noise = torch.empty_like(logits, dtype=torch.float32)
        noise.exponential_(generator=generator)
        actions = torch.argmax(logits.float() - torch.log(noise), dim=-1)
        return actions, ActAux(losses.log_prob(logits, actions)), ()

    def _forward(self, params, traj):
        """The net over a trajectory batch -> (logits (B, T, A), values
        (B, T), bootstrap values (B,))."""
        B, T = traj.actions.shape
        obs = traj.obs.reshape((B * T,) + tuple(traj.obs.shape[2:]))
        logits, values = self.net.apply(params, obs)
        _, bootstrap = self.net.apply(params, traj.bootstrap_obs)
        return logits.reshape(B, T, -1), values.reshape(B, T), bootstrap

    @staticmethod
    def _metrics(out) -> dict:
        return {"loss": out.total, "pg": out.pg, "value": out.value,
                "entropy": out.entropy, "rho": out.mean_rho}

    def loss(self, params, traj, weights=None):
        if weights is not None:
            raise ValueError(
                "ImpalaAgent is on-policy (AgentSpec.replay=False) and does "
                "not apply importance weights"
            )
        cfg = self.cfg
        logits, values, bootstrap = self._forward(params, traj)
        out = losses.impala_loss(
            logits, values, traj.actions, traj.behaviour_logp,
            traj.rewards, traj.discounts, bootstrap,
            entropy_cost=cfg.entropy_cost, value_cost=cfg.value_cost,
            clip_rho=cfg.clip_rho, clip_c=cfg.clip_c,
        )
        return out.total, LossAux(self._metrics(out))
