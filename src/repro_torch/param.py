"""Parameter initialisation on a ``torch.Generator``: the port of
``repro/param.py``.

``ParamBuilder`` builds the same nested-dict tree as the reference's
(same paths, shapes and dtypes), so a tree moved over by
:mod:`repro_torch.bridge` and a tree built here are interchangeable.  The
values differ: the generator is torch's, not JAX's threefry.  The
reference's logical-axis twin tree feeds its sharding rules, which the
port does not have, so it is not built.

``ParamBuilder.stack(n)`` gives every parameter created inside it a
leading ``n`` layer axis, drawn in one call: the reference's
``init_stacked`` layout ("blocks", ``transformer.py:37-59``).  Fan-in
counts the per-layer shape only, as it does there.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch

Init = Callable[[torch.Generator, tuple, tuple, torch.dtype, torch.device], torch.Tensor]


def normal_init(stddev: float = 0.02) -> Init:
    def init(gen, stack, shape, dtype, device):
        x = torch.randn(stack + shape, generator=gen, device=device)
        return (stddev * x).to(dtype)

    return init


def fan_in_init(scale: float = 1.0) -> Init:
    """LeCun-normal: stddev = scale / sqrt(fan_in), fan_in the product of
    all but the last dimension of the per-layer shape."""

    def init(gen, stack, shape, dtype, device):
        stddev = scale / math.sqrt(max(1, math.prod(shape[:-1])))
        x = torch.randn(stack + shape, generator=gen, device=device)
        return (stddev * x).to(dtype)

    return init


def zeros_init() -> Init:
    def init(gen, stack, shape, dtype, device):
        return torch.zeros(stack + shape, dtype=dtype, device=device)

    return init


def ones_init() -> Init:
    def init(gen, stack, shape, dtype, device):
        return torch.ones(stack + shape, dtype=dtype, device=device)

    return init


def constant_init(value: float) -> Init:
    def init(gen, stack, shape, dtype, device):
        return torch.full(stack + shape, value, dtype=dtype, device=device)

    return init


class ParamBuilder:
    """Collects parameters into a nested dict.

        b = ParamBuilder(gen, dtype=torch.bfloat16, device=dev)
        with b.scope("attn"):
            b.param("wq", (d, H, h))
        params = b.build()
    """

    def __init__(self, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self._gen = gen
        self._dtype = dtype
        self._device = device
        self._params: dict = {}
        self._path: list[str] = []
        self._stack: tuple[int, ...] = ()

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator["ParamBuilder"]:
        self._path.append(name)
        try:
            yield self
        finally:
            self._path.pop()

    @contextlib.contextmanager
    def stack(self, n: int) -> Iterator["ParamBuilder"]:
        """Give every parameter made inside a leading ``n`` layer axis."""
        outer = self._stack
        self._stack = outer + (n,)
        try:
            yield self
        finally:
            self._stack = outer

    def param(self, name: str, shape: tuple[int, ...],
              init: Init | None = None,
              dtype: torch.dtype | None = None) -> torch.Tensor:
        init = init or fan_in_init()
        value = init(self._gen, self._stack, tuple(shape),
                     dtype or self._dtype, self._device)
        d = self._params
        for p in self._path:
            d = d.setdefault(p, {})
        d[name] = value
        return value

    def build(self) -> dict:
        return self._params
