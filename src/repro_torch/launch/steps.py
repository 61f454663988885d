"""Train, prefill and serve steps: the port of ``repro/launch/steps.py``.

``make_train_step`` is the Sebulba-learner update at LLM scale: the
backbone takes token trajectories and optimizes

    L = LM cross-entropy + rl_weight * V-trace actor-critic terms
        + aux_weight * aux (0 for the dense family)

through the same V-trace op the small-scale Sebulba learner uses, with
gradient accumulation over ``cfg.microbatches`` and per-layer remat from
the config.  Gradients are taken with ``torch.autograd.grad`` over the
param leaves; the update is applied to the params IN PLACE (see
``optim.apply_updates``).

Sampling (``sample_tokens``, ``request_keys``, ``make_serve_step``):

Sampling keys are counter-based: ``request_keys`` hashes
``(seed, request id, token index)`` into one 32-bit key per row, and
``sample_tokens`` hashes ``(key, vocab index)`` into uniform noise for a
Gumbel-max draw.  Everything runs as tensor arithmetic on the logits'
device, with no host round trip and no generator state, so a request's
tokens depend on ``(logits, seed, rid, token index)`` only: not on its
row, the batch around it, or the cache layout.  The reference keys on
threefry ``fold_in``, which torch cannot reproduce, so the two packages
agree on sampled tokens only at temperature 0 (greedy).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import optim
from repro_torch.rl import losses
from repro_torch.tree import leaves, tree_map, unflatten

_M32 = 0xFFFFFFFF
METRIC_KEYS = ("loss", "ce", "rl", "aux", "entropy")


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    learning_rate: float = 3e-4
    rl_weight: float = 0.1
    aux_weight: float = 0.01
    entropy_cost: float = 0.001
    value_cost: float = 0.5
    clip_norm: float = 1.0


def make_optimizer(hp: TrainHParams) -> optim.GradientTransformation:
    return optim.adam(hp.learning_rate, clip_norm=hp.clip_norm)


def make_loss_fn(model, hp: TrainHParams) -> Callable:
    """loss_fn(params, batch) -> (total, metrics of 0-d tensors)."""

    def loss_fn(params, batch):
        logits, values, aux = model.forward(params, batch)
        tokens = batch["tokens"]
        # next-token prediction: position t predicts token t+1
        logits_t = logits[:, :-1]
        targets = tokens[:, 1:].long()
        # CE as logsumexp - target logit: no second (B, T, V) log-softmax
        lse = torch.logsumexp(logits_t, dim=-1)
        tgt = torch.gather(logits_t, -1, targets[..., None])[..., 0]
        ce = torch.mean(lse - tgt)
        # V-trace actor-critic on the same trajectory (actions = next tokens)
        out = losses.impala_loss(
            logits_t, values[:, :-1], targets,
            batch["behaviour_logp"][:, 1:], batch["rewards"][:, 1:],
            batch["discounts"][:, 1:], values[:, -1],
            entropy_cost=hp.entropy_cost, value_cost=hp.value_cost,
        )
        total = ce + hp.rl_weight * out.total + hp.aux_weight * aux
        metrics = {"loss": total, "ce": ce, "rl": out.total, "aux": aux,
                   "entropy": out.entropy}
        return total, metrics

    return loss_fn


def make_grad_fn(model, hp: TrainHParams = TrainHParams()) -> Callable:
    """grad_fn(params, batch) -> (grads: a tree like params, in the
    params' dtypes; metrics: detached 0-d tensors)."""
    loss_fn = make_loss_fn(model, hp)

    def grad_fn(params, batch):
        live = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            total, metrics = loss_fn(unflatten(params, live), batch)
            grads = torch.autograd.grad(total, live)
        return (unflatten(params, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    return grad_fn


def make_train_step(model, optimizer: optim.GradientTransformation,
                    hp: TrainHParams = TrainHParams()) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).
    With ``cfg.microbatches`` = n > 1 the batch is cut into n equal
    slices of rows, their gradients and metrics summed in float32 and
    divided by n, as the reference's scan does."""
    grad_fn = make_grad_fn(model, hp)
    micro = model.cfg.microbatches

    def train_step(params, opt_state, batch):
        if micro > 1:
            rows = batch["tokens"].shape[0]
            if rows % micro:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{micro} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            metrics = dict.fromkeys(METRIC_KEYS, 0.0)
            for mb in zip(*(x.chunk(micro) for x in batch.values())):
                g, m = grad_fn(params, dict(zip(batch, mb)))
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / micro, grads)
            metrics = {k: v / micro for k, v in metrics.items()}
        else:
            grads, metrics = grad_fn(params, batch)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model, hp: TrainHParams = TrainHParams()) -> Callable:
    """Inference prefill: the full forward, the last position's logits and
    value."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, values, _ = model.forward(params, batch)
        return logits[:, -1], values[:, -1]

    return prefill_step


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in
    [0, 2^32).  Both multipliers are below 2^31, so no product overflows
    int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def request_keys(seed: int, rids: torch.Tensor,
                 tok_idx: torch.Tensor) -> torch.Tensor:
    """Per-row sampling keys (B,) int64 from request ids and per-request
    token indices."""
    base = _mix32(torch.full_like(rids, (seed ^ 0x5BD1E995) & _M32,
                                  dtype=torch.int64))
    keys = _mix32(base ^ (rids.long() & _M32))
    return _mix32(keys ^ (tok_idx.long() & _M32))


def _gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) keys -> (B, V) float32 Gumbel noise, a function of
    (key, vocab index) only."""
    v = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    bits = _mix32(keys[:, None] ^ _mix32(v + 0x3C6EF372)[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Seeded sampling from (B, V) logits with one key per row -> (B,)
    int32.  ``temperature <= 0`` is greedy argmax (the first maximum on a
    tie, as in the reference).  ``top_k > 0`` keeps the logits >= the
    k-th largest before the draw."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).int()
    scaled = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    noisy = scaled + _gumbel(keys, logits.shape[-1])
    return torch.argmax(noisy, dim=-1).int()


def make_serve_step(model, temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> Callable:
    """Serve-loop decode step.  Greedy by default, with the 4-argument
    signature; with ``temperature > 0`` the step also takes per-row
    ``(rids, tok_idx)`` and draws from the per-request streams."""

    if temperature <= 0.0:
        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            """One decode step: (B, 1) token -> next (B, 1) token (greedy)."""
            logits, _values, cache = model.decode_step(params, cache, tokens,
                                                       pos)
            return torch.argmax(logits, dim=-1).int(), cache

        return serve_step

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos, rids, tok_idx):
        """One sampled decode step: (B, 1) token -> next (B, 1) token."""
        logits, _values, cache = model.decode_step(params, cache, tokens, pos)
        nxt = sample_tokens(logits[:, 0], request_keys(seed, rids, tok_idx),
                            temperature=temperature, top_k=top_k)
        return nxt[:, None], cache

    return serve_step
