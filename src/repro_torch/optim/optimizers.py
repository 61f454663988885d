"""Gradient transformations on trees of tensors: the port of
``repro/optim/optimizers.py`` (an optax-style subset with the same
``(init, update)`` contract), used in place of ``torch.optim`` so that the
update math is the reference's, step for step.

``update(grads, state, params)`` returns new updates and a new state and
does not touch its inputs; ``apply_updates`` adds the updates into the
params IN PLACE (in float32, cast back to each param's dtype) and returns
them: the learner keeps one copy of its params instead of two.  Callers
run both under ``torch.no_grad()``.  Moments take the params' dtype, as in
the reference.  Nothing reads a value back to the host, so an update
never waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

Tree = Any


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree | None], tuple[Tree, Tree]]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        norm = global_norm(grads)
        scale_ = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale_.to(g.dtype), grads), state

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(init, update)


def scale_by_schedule(
        schedule: Callable[[torch.Tensor], torch.Tensor]
) -> GradientTransformation:
    """g * schedule(count), count starting at 0 and kept as a () int32
    tensor on the params' device, so the schedule never reads back to the
    host."""

    def init(params):
        return torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)

    def update(grads, count, params=None):
        s = schedule(count)
        return tree_map(lambda g: g * s.to(g.dtype), grads), count + 1

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, on the params' device
    mu: Tree
    nu: Tree


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        device = leaves(params)[0].device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(
            lambda m, g: (b1 * m.float() + (1 - b1) * g.float()).to(m.dtype),
            state.mu, grads,
        )
        nu = tree_map(
            lambda v, g: (b2 * v.float()
                          + (1 - b2) * torch.square(g.float())).to(v.dtype),
            state.nu, grads,
        )
        bc1 = 1 - torch.pow(b1, count.float())
        bc2 = 1 - torch.pow(b2, count.float())
        updates = tree_map(
            lambda m, v: (m.float() / bc1)
            / (torch.sqrt(v.float() / bc2) + eps),
            mu, nu,
        )
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


class RMSPropState(NamedTuple):
    nu: Tree


def scale_by_rms(decay=0.99, eps=1e-8) -> GradientTransformation:
    """g / (sqrt(nu) + eps): eps outside the square root, as in the
    reference."""

    def init(params):
        return RMSPropState(nu=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        nu = tree_map(
            lambda v, g: decay * v + (1 - decay) * torch.square(g.to(v.dtype)),
            state.nu, grads,
        )
        updates = tree_map(
            lambda g, v: g.float() / (torch.sqrt(v.float()) + eps),
            grads, nu,
        )
        return updates, RMSPropState(nu=nu)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


# -- canned optimizers ------------------------------------------------------


def sgd(lr: float, momentum: float = 0.0) -> GradientTransformation:
    if momentum == 0.0:
        return chain(scale(-lr))

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        state = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                         state, grads)
        return tree_map(lambda m: -lr * m, state), state

    return GradientTransformation(init, update)


Schedule = Callable[[torch.Tensor], torch.Tensor]


def _scale_by_lr(lr: float | Schedule) -> GradientTransformation:
    """-lr, a float or a schedule of the update count."""
    if callable(lr):
        return scale_by_schedule(lambda c: -lr(c))
    return scale(-lr)


def adam(lr: float | Schedule, b1=0.9, b2=0.999, eps=1e-8,
         clip_norm: float = 0.0) -> GradientTransformation:
    parts = [clip_by_global_norm(clip_norm)] if clip_norm else []
    return chain(*parts, scale_by_adam(b1, b2, eps), _scale_by_lr(lr))


def rmsprop(lr: float | Schedule, decay=0.99, eps=1e-8,
            clip_norm: float = 0.0) -> GradientTransformation:
    parts = [clip_by_global_norm(clip_norm)] if clip_norm else []
    return chain(*parts, scale_by_rms(decay, eps), _scale_by_lr(lr))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params += updates, in place: summed in float32 and cast back to each
    param's dtype.  Returns ``params``."""

    def add(p, u):
        if p.dtype == torch.float32:
            return p.add_(u.float())
        return p.copy_(p.float() + u.float())

    return tree_map(add, params, updates)


# -- schedules ---------------------------------------------------------------


def warmup_cosine(base: float, warmup: int, total_steps: int) -> Schedule:
    """Linear warm-up from 0 over ``warmup`` counts, then a cosine from
    ``base`` to 0 at ``total_steps``; a function of a () count tensor."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(torch.pi * frac))
        return base * torch.where(c < warmup, warm, cos)

    return schedule
