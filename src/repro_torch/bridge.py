"""Move the reference's parameter and cache pytrees into the port.

The reference's trees are nested dicts of arrays; handed over as numpy
(``jax.tree.map(np.asarray, tree)``), a bf16 leaf arrives as an
``ml_dtypes.bfloat16`` array.  Its bits are reinterpreted as
``torch.bfloat16``, so the move is exact.  The port keeps the reference's
layouts (``wq (d,H,h)``, ``wo (H,h,d)``, ...), so a leaf moves as it is;
only the layer layout may change: the stacked ``"blocks"`` tree with a
leading layer axis, or one ``"layer_{i}"`` subtree per layer.

The tests use this module; the port's own path never imports numpy arrays
from elsewhere.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import leaves, tree_map

Tree = Any


def tensor_from_numpy(a: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """One numpy leaf -> a tensor of the same dtype, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype.kind in "fiub":
        t = torch.from_numpy(a.copy())
    else:
        raise TypeError(f"no bit-exact torch dtype for numpy {a.dtype}")
    return t.to(device)


def relayout(tree: Tree, num_layers: int, stacked: bool) -> Tree:
    """Stack ``layer_0..layer_{L-1}`` into ``"blocks"`` or split
    ``"blocks"`` into per-layer subtrees; a tree already in the asked
    layout is returned as it is."""
    tree = dict(tree)
    if stacked and "layer_0" in tree:
        per_layer = [tree.pop(f"layer_{i}") for i in range(num_layers)]
        tree["blocks"] = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    elif not stacked and "blocks" in tree:
        blocks = tree.pop("blocks")
        n = leaves(blocks)[0].shape[0]
        if n != num_layers:
            raise ValueError(f"'blocks' holds {n} layers; the config has "
                             f"{num_layers}")
        for i in range(n):
            tree[f"layer_{i}"] = tree_map(lambda x, i=i: x[i].clone(), blocks)
    return tree


def params_from_jax(tree: Tree, cfg: ArchConfig | None = None, *,
                    device: str | torch.device,
                    stacked: bool | None = None) -> Tree:
    """The reference's parameter tree (numpy leaves) -> the port's, leaf
    for leaf on the same paths and shapes: a transformer's tree, or a
    network's such as ``ConvActorCritic``'s (HWIO conv weights, which the
    port keeps).

    ``stacked`` picks the layer layout of a transformer's tree
    (``Model.stacked``, with its ``cfg``); None keeps the layout the tree
    came in."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), tree)
    if stacked is not None:
        out = relayout(out, cfg.num_layers, stacked)
    return out


def cache_from_jax(tree: Tree, cfg: ArchConfig, *,
                   device: str | torch.device,
                   stacked: bool | None = None) -> Tree:
    """A dense or paged KV cache tree (numpy leaves) -> the port's."""
    return params_from_jax(tree, cfg, device=device, stacked=stacked)
