"""Host-side (CPU, numpy) environment for Sebulba: the port of
``repro/envs/host_env.py``, the "arbitrary environment that cannot be
compiled" of the paper (their Atari).

``HostPong`` is a minimal Pong-like arcade game: a ball bounces around an
(H x W) board, the agent moves a paddle on the bottom row; an episode is a
rally of ``max_lives`` balls.  Observations are (H, W, 1) float32 frames.
The terminal miss keeps the board as the agent saw it die (the ``done``
frame shows the missed ball on the bottom row) and the respawn draw
happens in ``reset()``.

Ball spawns come from a counter-based stream: draw ``n`` is a function of
``(seed, n)`` alone (``spawn_ball``).  The reference draws from threefry
``fold_in``, which the port cannot reproduce, so the two games give other
spawns from the same seed; the ``spawn=`` seam takes any ``n -> (ball_x,
vx)`` callable, and fed the reference's draws the two games step
identically.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_M32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    """A 32-bit integer hash (the same finaliser as the serving sampler's
    counter hash, ``launch/steps.py``)."""
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & _M32
    x ^= x >> 15
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def spawn_ball(seed: int, n: int, width: int) -> tuple[float, float]:
    """Ball spawn draw ``n`` of the env seeded ``seed``: (ball_x, an
    integer in [1, width - 2], and vx in {-1, +1})."""
    key = _mix32(_mix32((seed ^ 0x5BD1E995) & _M32) ^ (n & _M32))
    ball_x = 1 + _mix32(key ^ 0x3C6EF372) % (width - 2)
    vx = 1.0 if _mix32(key ^ 0x1B873593) & 1 else -1.0
    return float(ball_x), vx


class HostPong:
    num_actions = 3  # left / stay / right

    def __init__(self, height: int = 16, width: int = 16, max_lives: int = 3,
                 seed: int = 0,
                 spawn: Callable[[int], tuple[float, float]] | None = None):
        self.h = height
        self.w = width
        self.max_lives = max_lives
        self.obs_shape = (height, width, 1)
        self._spawn = spawn or (lambda n: spawn_ball(seed, n, width))
        self._spawn_n = 0
        self._reset_ball()
        self.paddle = self.w // 2
        self.lives = self.max_lives
        self.needs_reset = False

    def _reset_ball(self) -> None:
        ball_x, vx = self._spawn(self._spawn_n)
        self._spawn_n += 1
        self.ball_y = 0.0
        self.ball_x = float(ball_x)
        self.vy = 1.0
        self.vx = float(vx)

    def reset(self) -> np.ndarray:
        self._reset_ball()
        self.paddle = self.w // 2
        self.lives = self.max_lives
        self.needs_reset = False
        return self._observe()

    def _observe(self) -> np.ndarray:
        obs = np.zeros(self.obs_shape, np.float32)
        y = int(np.clip(round(self.ball_y), 0, self.h - 1))
        x = int(np.clip(round(self.ball_x), 0, self.w - 1))
        obs[y, x, 0] = 1.0
        obs[self.h - 1, self.paddle, 0] = 1.0
        return obs

    def step(self, action: int):
        """-> (obs, reward, done, info).  After ``done``, call reset()."""
        if self.needs_reset:
            raise RuntimeError("episode ended; call reset()")
        self.paddle = int(np.clip(self.paddle + (action - 1), 0, self.w - 1))
        self.ball_y += self.vy
        self.ball_x += self.vx
        if self.ball_x <= 0 or self.ball_x >= self.w - 1:
            self.vx = -self.vx
            self.ball_x = float(np.clip(self.ball_x, 0, self.w - 1))
        reward = 0.0
        if self.ball_y >= self.h - 1:
            if abs(self.ball_x - self.paddle) <= 1:
                reward = 1.0
                self.vy = -1.0
                self.ball_y = float(self.h - 2)
            else:
                reward = -1.0
                self.lives -= 1
                if self.lives > 0:
                    self._reset_ball()  # the terminal miss keeps the board
        elif self.ball_y <= 0:
            self.vy = 1.0
        done = self.lives <= 0
        if done:
            self.needs_reset = True
        return self._observe(), reward, done, {}
