"""The paper's "special batched environment": a copy of
``repro/envs/batched_env.py`` (the port imports nothing of the reference).

    "each Python actor-thread interacts with a special batched environment;
     this is exposed to Python as a single environment that takes a batch of
     actions and returns a batch of observations; behind the scenes it steps
     each environment in the batch in parallel using a shared pool of C++
     threads."

Here the shared pool is a ``ThreadPoolExecutor`` (numpy releases the GIL for
array work, and one pool is shared by all actor threads, as in the paper).
Episodes auto-reset so actors never block on episode boundaries; ``done``
flags mark boundaries for the learner's discount mask.

The shared pool is reference-counted: every ``BatchedHostEnv`` riding on it
holds a reference, and ``close()`` releases it, shutting the pool down when
the last env lets go — so env-pool threads no longer outlive ``fit()``.
``shared_pool(workers=N)`` grows the pool when a later caller asks for more
workers than the first caller pinned (the executor spawns threads lazily up
to its ceiling, so raising the ceiling on a live pool is safe).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np


class BatchedHostEnv:
    _shared_pool: ThreadPoolExecutor | None = None
    _shared_refs: int = 0
    _shared_lock = threading.Lock()

    @classmethod
    def shared_pool(cls, workers: int = 8) -> ThreadPoolExecutor:
        """The process-wide env-stepping pool, grown to ``workers`` if a
        later caller needs more than the first caller asked for."""
        with cls._shared_lock:
            if cls._shared_pool is None:
                cls._shared_pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="env-pool"
                )
            elif workers > cls._shared_pool._max_workers:
                # ThreadPoolExecutor spawns threads lazily up to
                # _max_workers; raising the ceiling in place honors the
                # larger request without invalidating live references.
                cls._shared_pool._max_workers = workers
            return cls._shared_pool

    @classmethod
    def _release_shared(cls) -> None:
        with cls._shared_lock:
            cls._shared_refs -= 1
            if cls._shared_refs <= 0 and cls._shared_pool is not None:
                cls._shared_pool.shutdown(wait=True)
                cls._shared_pool = None
                cls._shared_refs = 0

    def __init__(
        self,
        env_factory: Callable[[int], object],
        num_envs: int,
        pool: ThreadPoolExecutor | None = None,
    ):
        self.envs = [env_factory(i) for i in range(num_envs)]
        self.num_envs = num_envs
        self.num_actions = self.envs[0].num_actions
        self.obs_shape = self.envs[0].obs_shape
        self._owns_shared = pool is None
        if self._owns_shared:
            # a batch of N envs wants N-wide stepping; grow the shared
            # pool instead of letting the first caller pin its size
            self.pool = self.shared_pool(workers=max(8, num_envs))
            with type(self)._shared_lock:
                type(self)._shared_refs += 1
        else:
            self.pool = pool
        self._closed = False

    def close(self) -> None:
        """Release this env's pool reference (shutting the shared pool down
        with the last reference) and close closable member envs."""
        if self._closed:
            return
        self._closed = True
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()
        if self._owns_shared:
            self._release_shared()

    def reset(self) -> np.ndarray:
        return np.stack(
            list(self.pool.map(lambda env: env.reset(), self.envs))
        )

    def _step_one(self, i: int, action: int):
        env = self.envs[i]
        obs, reward, done, _ = env.step(int(action))
        if done:
            obs = env.reset()
        return obs, reward, done

    def step(self, actions: np.ndarray):
        """actions (N,) -> obs (N, ...), rewards (N,), dones (N,)."""
        results = list(
            self.pool.map(self._step_one, range(self.num_envs), actions)
        )
        obs = np.stack([r[0] for r in results])
        rewards = np.array([r[1] for r in results], np.float32)
        dones = np.array([r[2] for r in results], bool)
        return obs, rewards, dones
