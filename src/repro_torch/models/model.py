"""The model API for the dense, ssm and hybrid families: the port of
``repro/models/model.py`` (``init``, ``forward``, ``init_cache``,
``init_paged_cache``, ``decode_step``, ``prefill_step``).

    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, values, aux = model.forward(params, {"tokens": tokens})
    cache = model.init_paged_cache(num_blocks, block_size)
    logits, values, cache = model.decode_step(params, cache, tokens, pos,
                                              block_tables)

The parameter tree has the reference's paths, shapes and dtypes, in
either of its two layer layouts: stacked (``"blocks"`` with a leading
layer axis, the default for uniform global attention) or one
``"layer_{i}"`` subtree per layer (``unroll=True``).  Layers run as a
Python loop over per-layer views in both.  ``forward`` wraps each layer in
``torch.utils.checkpoint`` when ``cfg.remat != "none"`` (the reference's
``jax.checkpoint``).  ``decode_step`` and ``prefill_step`` write the cache
in place and return it.

The ssm family (Mamba-2) runs ``init`` and ``forward`` (the train and
prefill forward, each layer ``h + mamba2_block(p["mixer"], h)``, params
under ``blocks/mixer/*`` or ``layer_{i}/mixer/*``).  The hybrid family
(Griffin) runs ``init`` and ``forward`` over its R/A pattern, always in
the ``layer_{i}`` layout as the reference lays it out: an R layer is
``h + recurrent_block(p["recurrent"], h)`` then the FFN, an A layer
windowed attention then the FFN; a gemma model's embedding is scaled by
sqrt(d) rounded to the param dtype.  Their decode state is not ported
yet: ``init_cache`` and ``decode_step`` raise ``NotImplementedError``
(ROADMAP Queue 1 #10c), and ``prefill_step`` and ``init_paged_cache``
raise ``ValueError`` as the reference's do.

What the port does not run yet raises ``ValueError`` at construction:
the moe, vlm and audio families, dense layer patterns other than global
attention, logit softcap, qk-norm, learned positions and the fp8 cache.
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import griffin, layers, mamba2
from repro_torch.models import transformer as tf
from repro_torch.param import ParamBuilder, fan_in_init

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's decode state of the recurrent families, not ported yet
_DECODE_STATE = {
    "ssm": "init_mamba2_cache, mamba2_decode_step",
    "hybrid": "init_recurrent_cache, recurrent_decode_step, the ring-buffer "
              "KV cache",
}


def _unsupported(cfg: ArchConfig, kinds: list[str]) -> list[str]:
    out = []
    if cfg.family not in ("dense", "ssm", "hybrid"):
        out.append(f"family {cfg.family!r}")
    if not set(kinds) <= ({"R", "A"} if cfg.family == "hybrid" else {"G"}):
        out.append(f"layer pattern {cfg.layer_pattern!r}")
    if cfg.attn_logit_softcap:
        out.append("logit softcap")
    if cfg.qk_norm:
        out.append("qk-norm")
    if cfg.pos_embed != "rope":
        out.append(f"{cfg.pos_embed} positions")
    for name in ("param_dtype", "cache_dtype"):
        if getattr(cfg, name) not in _DTYPES:
            out.append(f"{name} {getattr(cfg, name)!r}")
    return out


def _unstack(tree: Params, n: int) -> list:
    """The n per-layer views of a tree whose leaves have a leading layer
    axis: each leaf is unbound once, so writes to a view land in the tree
    and a leaf's gradient is one stack of the layers' gradients."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


class Model:
    def __init__(self, cfg: ArchConfig, unroll: bool = False):
        self.kinds = tf.layer_kinds(cfg)
        missing = _unsupported(cfg, self.kinds)
        if missing:
            raise ValueError(f"{cfg.name}: the port does not run "
                             f"{', '.join(missing)} yet")
        self.cfg = cfg
        # the reference never stacks the hybrid family (model.py:77-80)
        self.stacked = (not unroll and cfg.family != "hybrid"
                        and tf.is_uniform(cfg))

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator | int,
             device: str | torch.device | None = None) -> Params:
        """Random parameters drawn from ``generator`` (or a seed) directly
        on ``device`` (default: the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(int(generator))
        b = ParamBuilder(generator, _DTYPES[cfg.param_dtype], dev)
        layers.init_embedding(b, "embedding", cfg.vocab_size, cfg.d_model,
                              cfg.tie_embeddings)

        def one_layer(kind):
            if cfg.family == "ssm":
                mamba2.init_mamba2_block(b, "mixer", cfg)
                return
            if kind == "R":
                griffin.init_recurrent_block(b, "recurrent", cfg)
            else:
                tf.init_attn_layer(b, cfg)
            tf.init_ffn_layer(b, cfg)

        if self.stacked:
            with b.scope("blocks"), b.stack(cfg.num_layers):
                one_layer(self.kinds[0])
        else:
            for i, kind in enumerate(self.kinds):
                with b.scope(f"layer_{i}"):
                    one_layer(kind)
        layers.init_rms_norm(b, "final_norm", cfg.d_model)
        with b.scope("value_head"):
            b.param("w", (cfg.d_model, 1), fan_in_init())
        return b.build()

    # ----------------------------------------------------------------- cache

    def _kv(self, shape: tuple, dtype, device) -> Params:
        """Zeroed {"k", "v"} per layer in the params' layer layout.  Zeros,
        never ``empty``: a partly filled page or row is read whole, and
        0 * NaN would be NaN."""
        cfg = self.cfg
        dt = dtype or _DTYPES[cfg.cache_dtype]
        dev = resolve_device(device)
        if self.stacked:
            shape = (cfg.num_layers,) + shape
            return {"blocks": {n: torch.zeros(shape, dtype=dt, device=dev)
                               for n in ("k", "v")}}
        return {f"layer_{i}": {n: torch.zeros(shape, dtype=dt, device=dev)
                               for n in ("k", "v")}
                for i in range(cfg.num_layers)}

    def _no_decode_state(self, what: str) -> None:
        family = self.cfg.family
        if family in _DECODE_STATE:
            raise NotImplementedError(
                f"{what}: the {family} decode state ({_DECODE_STATE[family]})"
                " is not ported yet: ROADMAP Queue 1 #10c")

    def init_cache(self, batch: int, seq_len: int, dtype=None,
                   device: str | torch.device | None = None) -> Params:
        """Dense (B, S, K, h) K/V per layer."""
        self._no_decode_state("init_cache")
        cfg = self.cfg
        return self._kv((batch, seq_len, cfg.num_kv_heads, cfg.head_dim),
                        dtype, device)

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype=None,
                         device: str | torch.device | None = None) -> Params:
        """Page pools (P, bs, K, h) per layer, shared by all rows through
        a per-request block table (serve/blocks.py).  Page 0 is reserved
        scratch, never mapped to a live request, so out-of-range writes
        land there harmlessly."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise ValueError(
                f"paged cache supports dense/moe only, not {cfg.family}")
        return self._kv((num_blocks, block_size, cfg.num_kv_heads,
                         cfg.head_dim), dtype, device)

    # ---------------------------------------------------------------- steps

    def _per_layer(self, tree: Params) -> list:
        """Per-layer subtrees of a params or cache tree, in either layer
        layout (views of the stacked tensors)."""
        if self.stacked:
            return _unstack(tree["blocks"], self.cfg.num_layers)
        return [tree[f"layer_{i}"] for i in range(self.cfg.num_layers)]

    def _layers(self, params: Params, cache: Params) -> Iterator:
        """(layer params, layer cache) per layer; cache writes land in
        ``cache``."""
        return zip(self._per_layer(params), self._per_layer(cache))

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.embed(params["embedding"], tokens.long(),
                         _DTYPES[cfg.param_dtype])
        if "gemma" in cfg.name:  # sqrt(d) rounded to x's dtype first
            # (a 0-d CPU tensor multiplies a CUDA one with no copy to it)
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x

    def _heads(self, params: Params, x: torch.Tensor):
        """-> (logits (B,T,V) f32, values (B,T) f32)."""
        x = layers.rms_norm(params["final_norm"], x, self.cfg.rms_norm_eps)
        logits = layers.unembed(params["embedding"], x)
        values = (x @ params["value_head"]["w"].to(x.dtype))[..., 0].float()
        return logits, values

    def forward(self, params: Params, batch: dict):
        """batch["tokens"] (B, T) -> (logits (B,T,V) f32, values (B,T) f32,
        aux 0-d f32: the dense, ssm and hybrid families have no auxiliary
        loss)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)

        def layer(p, h, kind):
            if cfg.family == "ssm":
                return h + mamba2.mamba2_block(p["mixer"], h, cfg)
            if kind == "R":
                h = h + griffin.recurrent_block(p["recurrent"], h, cfg)
            else:
                window, theta = tf.local_params(cfg, kind)
                h = tf.attn_sublayer(p, h, positions, cfg, window=window,
                                     theta=theta)
            return tf.ffn_sublayer(p, h, cfg)

        for p, kind in zip(self._per_layer(params), self.kinds):
            if cfg.remat != "none":
                x = checkpoint(layer, p, x, kind, use_reentrant=False)
            else:
                x = layer(p, x, kind)
        logits, values = self._heads(params, x)
        return logits, values, torch.zeros((), dtype=torch.float32,
                                           device=x.device)

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor, pos,
                    block_tables: torch.Tensor | None = None):
        """tokens: (B, 1) -> (logits (B,1,V) f32, values (B,1) f32, cache).

        ``pos`` is an int (lockstep batch) or a (B,) int32 tensor of
        per-row positions.  ``block_tables`` (B, nb) int32 switches to the
        page pools from ``init_paged_cache``."""
        self._no_decode_state("decode_step")
        x = self._embed(params, tokens)
        for p, c in self._layers(params, cache):
            x, _ = tf.attn_sublayer_decode(p, c, x, pos, self.cfg,
                                           block_tables=block_tables)
            x = tf.ffn_sublayer(p, x, self.cfg)
        return (*self._heads(params, x), cache)

    def prefill_step(self, params: Params, cache: Params,
                     tokens: torch.Tensor, pos: torch.Tensor,
                     block_tables: torch.Tensor | None = None):
        """Chunked prefill of a (B, C) token chunk whose row-b tokens sit
        at positions pos[b]..pos[b]+C-1 -> (logits (B,C,V) f32,
        values (B,C) f32, cache): the fused equivalent of C sequential
        ``decode_step`` calls."""
        if self.cfg.family != "dense":
            raise ValueError(
                f"prefill_step supports dense/moe only, not "
                f"{self.cfg.family}; other families decode token-by-token")
        x = self._embed(params, tokens)
        for p, c in self._layers(params, cache):
            x, _ = tf.attn_sublayer_prefill(p, c, x, pos, self.cfg,
                                            block_tables=block_tables)
            x = tf.ffn_sublayer(p, x, self.cfg)
        return (*self._heads(params, x), cache)


def make_model(cfg: ArchConfig, unroll: bool = False) -> Model:
    return Model(cfg, unroll=unroll)
