"""Sebulba, on-policy, over host environments: the port of the on-policy
host-env path of ``repro/core/sebulba.py`` (paper Fig. 3).

  * Actor threads each own a batched host environment
    (``envs/batched_env.py``) and act with batched inference on their
    actor device.  Each step writes the observation, the action and its
    behaviour log-prob into a preallocated device trajectory ring
    (``data/trajectory.py``); the previous step's rewards and discounts
    travel with it as one (2, B) upload.  The one host sync per step is
    reading the actions the env needs.
  * A full ring is drained: its tensors ARE the trajectory handed to the
    learner (no copy), and the actor goes on with a fresh ring.
  * The learner takes trajectories off a bounded queue and runs the
    V-trace update (``learner_microbatches`` sequential SGD steps over
    slices of the batch), folding the metrics into one device accumulator
    ``[count, *sums]`` that the host reads only on ``log_every``
    boundaries and at the end: the steady-state learner never syncs.
  * After each update the learner publishes params to every actor device
    through a versioned slot, skipping a device whose previous publish
    nobody has picked up yet (``publish_throttle``).

On one card, the card plays actor and learner (``core/topology.py``), and
each actor thread and the learner run on their own CUDA stream.  The
learner updates its params in place, so a publish is a copy into fresh
tensors made on the learner's stream, with an event the actor's stream
waits on before it first reads them.  A trajectory crosses the other way
with an event recorded after the actor's last write, and every tensor a
stream reads but did not allocate is ``record_stream``-ed to it, so that
the caching allocator cannot hand its memory to the other stream while a
read is pending.  On the CPU there are no streams, and the same code runs
in program order.

An actor thread that raises stops the run: the learner re-raises its
exception.  The port has no supervisor yet.  Not ported with this slice,
each raising ``NotImplementedError`` that names its ROADMAP item: replay,
device envs, recurrent agents and burn-in, agent extras, fault plans and
supervision, multi-host clusters, checkpoints, and more than one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import optim
from repro_torch.agents.impala import ImpalaAgent
from repro_torch.api import make_result, resolve_agent
from repro_torch.core.topology import CoreSplit, split_devices
from repro_torch.data.trajectory import (
    Trajectory,
    buffer_add,
    buffer_drain,
    device_buffer_init,
    split_for_learners,
)
from repro_torch.device import resolve_device
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class SebulbaConfig:
    num_actor_cores: int = 2  # actor devices when there are several
    threads_per_actor_core: int = 2  # hide env latency (paper)
    actor_batch_size: int = 32  # envs per actor thread (paper: 32..128)
    trajectory_length: int = 20  # paper: 20 (IMPALA) .. 60
    queue_capacity: int = 4
    discount: float = 0.99
    entropy_cost: float = 0.01
    value_cost: float = 0.5
    clip_rho: float = 1.0
    clip_c: float = 1.0
    learner_microbatches: int = 1  # MuZero batch-splitting trick
    # skip a publish to an actor device whose previous publish is still
    # unread: fewer copies, at the cost of up to one pickup interval of
    # extra policy lag, which V-trace absorbs
    publish_throttle: bool = True
    burn_in: int = 0  # recurrent agents: not ported yet (raises)
    replay: Any = None  # off-policy mode: not ported yet (raises)


def _not_ported(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})"
    )


# ------------------------------------------------------------ streams


def _new_stream(device: torch.device) -> torch.cuda.Stream | None:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on(stream: torch.cuda.Stream | None):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _record(device: torch.device) -> torch.cuda.Event | None:
    """An event after the work queued so far on ``device``'s current
    stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _take(tensors: list[torch.Tensor], ready: torch.cuda.Event | None,
          device: torch.device) -> None:
    """Make ``tensors``, written on another stream up to ``ready``, safe
    to read on ``device``'s current stream."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


@dataclasses.dataclass
class _Actor:
    """One actor thread and its counters, written by that thread only."""

    core_id: int
    seed: int
    thread: threading.Thread | None = None
    frames: int = 0
    put_blocked: int = 0
    traj_dropped: int = 0
    error: Exception | None = None


class Sebulba:
    def __init__(
        self,
        env_factory: Callable[[int], object] = None,  # seed -> host env
        make_batched_env: Callable[[Callable, int], object] = None,
        network=None,
        optimizer: optim.GradientTransformation = None,
        config: SebulbaConfig = SebulbaConfig(),
        device=None,  # a device, or a one-device list; default the card
        agent=None,
        *,
        device_env=None,
        fault_plan=None,
        cluster=None,
    ):
        self.cfg = config
        if device_env is not None:
            _not_ported("device_env= (the device env fleet)", "Queue 1 #4")
        if config.replay is not None:
            _not_ported("SebulbaConfig.replay (off-policy Sebulba)",
                        "Queue 1 #5")
        if config.burn_in:
            _not_ported("SebulbaConfig.burn_in (recurrent agents)",
                        "Queue 1 #6")
        if fault_plan is not None:
            _not_ported("fault_plan= (actor supervision)", "Queue 1 #8")
        if cluster is not None:
            _not_ported("cluster= (multi-host elasticity)", "Queue 1 #8")
        if env_factory is None or make_batched_env is None:
            raise ValueError("Sebulba needs host environments: env_factory "
                             "and make_batched_env")
        if agent is None:
            agent = ImpalaAgent(network, config)
        self.agent, self.spec = resolve_agent(agent)
        if self.spec.recurrent:
            _not_ported("recurrent agents", "Queue 1 #6")
        if self.spec.replay:
            _not_ported("replay agents", "Queue 1 #5")
        if self.spec.extras_keys:
            _not_ported("agent extras in the trajectory ring", "Queue 1 #7")
        devices = device if isinstance(device, (list, tuple)) else [device]
        devices = list(dict.fromkeys(_full(resolve_device(d))
                                     for d in devices))
        if len(devices) > 1:
            _not_ported("Sebulba over more than one device", "Queue 1 #12")
        self.split: CoreSplit = split_devices(config.num_actor_cores, devices)
        if config.actor_batch_size % config.learner_microbatches:
            raise ValueError(
                f"learner_microbatches ({config.learner_microbatches}) must "
                f"divide actor_batch_size ({config.actor_batch_size})"
            )
        self.opt = optimizer
        self.env_factory = env_factory
        self.make_batched_env = make_batched_env

        # shared between threads without locks: a slot is a (version,
        # params, ready event) tuple swapped in one list assignment, and
        # every other mutable field belongs to one thread
        self._params_version = 0
        self._param_slots: list[tuple] = [(0, None, None)] * \
            self.split.num_actors
        # last params version each actor device picked up (stamped by its
        # threads); drives the publish throttle
        self._slot_consumed = [0] * self.split.num_actors
        self.publishes_sent = 0
        self.publishes_skipped = 0
        self._queue: queue.Queue = queue.Queue(maxsize=config.queue_capacity)
        self._stop = threading.Event()
        self.episode_returns: deque = deque(maxlen=256)
        self._actors: list[_Actor] = []
        self._metric_keys: list[str] | None = None

    @property
    def frames(self) -> int:
        """Host env frames generated, summed over the actor threads."""
        return sum(a.frames for a in self._actors)

    # -------------------------------------------------------------- setup

    def init(self, seed: int, obs_shape):
        """Params from ``seed`` on the learner device, a fresh optimizer
        state, and the first publish (version 1)."""
        device = self.split.learner_devices[0]
        params = self.agent.init(
            torch.Generator(device=device).manual_seed(seed), obs_shape)
        opt_state = self.opt.init(params)
        self._publish_params(params, force=True)
        return params, opt_state

    def _publish_params(self, params, force: bool = False) -> None:
        """Copy ``params`` into each actor device's slot, on the current
        (learner) stream, with the event the actors wait on.  A device
        whose consumed stamp trails its slot version has not acted with
        the previous publish yet: with the throttle on, its slot stands
        and the next publish lands instead."""
        self._params_version += 1
        version = self._params_version
        throttle = self.cfg.publish_throttle and not force
        for i, dev in enumerate(self.split.actor_devices):
            if throttle and self._slot_consumed[i] < self._param_slots[i][0]:
                self.publishes_skipped += 1
                continue
            fresh = [p.to(dev, copy=True) for p in leaves(params)]
            self._param_slots[i] = (version, unflatten(params, fresh),
                                    _record(dev))
            self.publishes_sent += 1

    # -------------------------------------------------------------- actor

    def _start_actors(self) -> None:
        cfg = self.cfg
        for core in range(self.split.num_actors):
            for k in range(cfg.threads_per_actor_core):
                actor = _Actor(core_id=core,
                               seed=1 + core * cfg.threads_per_actor_core + k)
                actor.thread = threading.Thread(
                    target=self._actor_main, args=(actor,),
                    name=f"sebulba-actor-{core}-{k}", daemon=True,
                )
                self._actors.append(actor)
                actor.thread.start()

    def _actor_main(self, actor: _Actor) -> None:
        """The thread's body: runs the actor loop and keeps its exception
        for the learner, which re-raises it."""
        try:
            self._actor_loop(actor)
        except Exception as e:  # noqa: BLE001 - handed to the learner
            actor.error = e

    def _actor_loop(self, actor: _Actor) -> None:
        cfg = self.cfg
        device = self.split.actor_devices[actor.core_id]
        seed = actor.seed
        env = self.make_batched_env(
            lambda i: self.env_factory(seed * 10_000 + i), cfg.actor_batch_size
        )
        try:
            with _on(_new_stream(device)), torch.no_grad():
                self._host_actor_loop(actor, env, device)
        finally:
            close = getattr(env, "close", None)
            if callable(close):
                close()

    def _host_actor_loop(self, actor: _Actor, env, device) -> None:
        cfg = self.cfg
        B, T = cfg.actor_batch_size, cfg.trajectory_length
        gen = torch.Generator(device=device).manual_seed(actor.seed)
        obs = env.reset()
        # host staging for the per-step uploads: pinned on the card, so the
        # copies run on the stream without a sync; reused once the action
        # read of the step before has drained the stream
        pin = device.type == "cuda"
        obs_host = torch.empty(obs.shape, dtype=torch.from_numpy(obs).dtype,
                               pin_memory=pin)
        hd_host = torch.zeros((2, B), dtype=torch.float32, pin_memory=pin)

        def upload(host: torch.Tensor, array: np.ndarray) -> torch.Tensor:
            host.copy_(torch.from_numpy(array))
            return torch.empty_like(host, device=device).copy_(
                host, non_blocking=True)

        running_return = np.zeros(B)
        host_data = np.zeros((2, B), np.float32)  # previous [rewards; discounts]
        buf = None
        t = 0
        last_version = 0
        params = None
        while not self._stop.is_set():
            version, slot, ready = self._param_slots[actor.core_id]
            if version != last_version:
                last_version = version
                params = slot
                _take(leaves(params), ready, device)
                # a stale-low stamp from the racy read-modify-write across
                # this device's threads lasts one step and only delays a
                # publish, never loses one
                if self._slot_consumed[actor.core_id] < version:
                    self._slot_consumed[actor.core_id] = version
            obs_dev = upload(obs_host, obs)
            hd_dev = upload(hd_host, host_data)
            if t == T:
                traj, buf = buffer_drain(buf, hd_dev, obs_dev)
                t = 0
                if not self._queue_put((traj, _record(device)), actor):
                    return  # stopping: the in-flight trajectory is dropped
            actions, aux, _ = self.agent.act(params, obs_dev, gen, ())
            if buf is None:
                buf = device_buffer_init(T, obs_dev, actions, aux.logp)
            buffer_add(buf, obs_dev, actions, aux.logp, hd_dev)
            # the one host sync per step: the env needs the actions
            next_obs, rewards, dones = env.step(actions.cpu().numpy())

            running_return += rewards
            for r in running_return[dones]:
                self.episode_returns.append(float(r))
            running_return[dones] = 0.0
            host_data = np.stack(
                [rewards, (~dones).astype(np.float32) * cfg.discount]
            )
            actor.frames += B
            obs = next_obs
            t += 1

    def _queue_put(self, item, actor: _Actor) -> bool:
        """Blocking put that retries on a full queue (counting the blocked
        intervals) until it lands or the run stops; only the stop drops
        the trajectory, and that is counted too.  False when stopping."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                actor.put_blocked += 1
        actor.traj_dropped += 1
        return False

    def _raise_actor_error(self) -> None:
        for actor in self._actors:
            if actor.error is not None:
                raise RuntimeError(
                    f"actor thread {actor.thread.name} failed"
                ) from actor.error

    # ------------------------------------------------------------ learner

    def _sgd_step(self, params, opt_state, traj: Trajectory):
        """Gradient of the agent's loss with respect to every param leaf,
        the optimizer update, params updated in place -> (params,
        opt_state, metrics as one (M,) tensor in ``_metric_keys`` order)."""
        flat = leaves(params)
        live = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, aux = self.agent.loss(unflatten(params, live), traj)
            grads = torch.autograd.grad(loss, live)
        updates, opt_state = self.opt.update(unflatten(params, list(grads)),
                                             opt_state, params)
        params = optim.apply_updates(params, updates)
        if self._metric_keys is None:
            self._metric_keys = sorted(aux.metrics)
        metrics = torch.stack([aux.metrics[k].detach().float()
                               for k in self._metric_keys])
        return params, opt_state, metrics

    def _update(self, params, opt_state, traj: Trajectory, macc):
        """One learner update: ``learner_microbatches`` sequential SGD
        steps over equal slices of the batch, the mean of their metrics
        added to the device accumulator ``macc`` = [count, *sums] (None
        starts one).  Call under ``torch.no_grad()``."""
        n = self.cfg.learner_microbatches
        total = None
        for mb in split_for_learners(traj, n):
            params, opt_state, metrics = self._sgd_step(params, opt_state, mb)
            total = metrics if total is None else total + metrics
        row = torch.cat([torch.ones(1, device=total.device), total / n])
        return params, opt_state, row if macc is None else macc + row

    def _drain_macc(self, macc) -> dict | None:
        """The metric means accumulated in ``macc``: the one device->host
        read of the learner, paid on log boundaries and at the end."""
        vals = macc.cpu().tolist()
        if vals[0] == 0.0:
            return None
        return {k: v / vals[0] for k, v in zip(self._metric_keys, vals[1:])}

    # ---------------------------------------------------------------- run

    def run(self, seed: int, obs_shape, total_frames: int,
            log_every: int = 0) -> dict:
        """Train until ``total_frames`` host env frames have been generated
        -> the ``api.RESULT_KEYS`` result."""
        device = self.split.learner_devices[0]
        with _on(_new_stream(device)), torch.no_grad():
            params, opt_state = self.init(seed, obs_shape)
            self._start_actors()
            updates = 0
            last_metrics: dict = {}
            macc = None
            t0 = time.time()
            try:
                while self.frames < total_frames:
                    self._raise_actor_error()
                    try:
                        traj, ready = self._queue.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    _take(leaves(traj), ready, device)
                    params, opt_state, macc = self._update(
                        params, opt_state, traj, macc)
                    del traj
                    self._publish_params(params)
                    updates += 1
                    if log_every and updates % log_every == 0:
                        last_metrics = self._drain_macc(macc) or last_metrics
                        macc = None
                        print(f"update {updates} frames {self.frames} "
                              f"return {self._mean_return():.2f} "
                              + " ".join(f"{k}={v:.3f}"
                                         for k, v in last_metrics.items()))
                self._raise_actor_error()
            finally:
                self._stop.set()
                leaked = []
                for actor in self._actors:
                    actor.thread.join(timeout=10.0)
                    if actor.thread.is_alive():
                        leaked.append(actor.thread.name)
                if leaked:
                    warnings.warn(
                        "Sebulba shutdown leaked actor threads (still "
                        f"running after stop and join): {', '.join(leaked)}",
                        RuntimeWarning, stacklevel=2,
                    )
            if macc is not None:
                last_metrics = self._drain_macc(macc) or last_metrics
            dt = time.time() - t0
        return make_result(
            params=params, updates=updates, frames=self.frames, seconds=dt,
            metrics=last_metrics, mean_return=self._mean_return(),
            # init's publish + one per update (throttled devices skip
            # copies, not versions)
            param_version=self._params_version,
            publishes_sent=self.publishes_sent,
            publishes_skipped=self.publishes_skipped,
            put_blocked=sum(a.put_blocked for a in self._actors),
            traj_dropped=sum(a.traj_dropped for a in self._actors),
        )

    def _mean_return(self) -> float:
        returns = list(self.episode_returns)
        return float(np.mean(returns)) if returns else float("nan")

    def fit(self, seed: int, total_frames: int, *, obs_shape=None,
            log_every: int = 0, checkpoint_dir: str | None = None,
            checkpoint_every: int = 0, restore_from: str | None = None,
            auto_resume: bool = False) -> dict:
        """The runner entry point (the reference's ``Runner.fit``, with a
        seed in place of a JAX key).  ``obs_shape`` defaults to what a
        probe env reports."""
        if (checkpoint_dir is not None or checkpoint_every
                or restore_from is not None or auto_resume):
            _not_ported("checkpoints (checkpoint_dir, restore_from, "
                        "auto_resume)", "Queue 1 #8")
        if obs_shape is None:
            probe = self.env_factory(0)
            obs_shape = probe.obs_shape
            close = getattr(probe, "close", None)
            if callable(close):
                close()
        return self.run(seed, obs_shape, total_frames, log_every=log_every)


def _full(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current index>``, so devices compare equal to
    the ``.device`` of the tensors made on them."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
