"""Training launcher, ported from ``repro/launch/train.py``: the
Sebulba-learner train step (``launch/steps.py``) for an architecture the
port has, reduced config by default, the published one with ``--full``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --full \
        --steps 5 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --device cpu --steps 3 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --full \
        --steps 5 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --device cpu --steps 2 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --full --steps 5 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --device cpu --steps 2 --batch 2 --seq 128

The dense family's forward runs the flash-attention kernel, the ssm
family's (Mamba-2) the SSD chunk-scan kernel and the hybrid family's
(Griffin) the RG-LRU scan kernel, its windowed attention layers the plain
blocked attention; every loss runs V-trace.  An ssm sequence must divide
into chunks of min(ssm_chunk, seq) steps (32 in the reduced config, 256
in the published one); a hybrid sequence on the card must divide into
blocks of min(256, seq) steps (the RG-LRU kernel's contract).

It runs on the card unless ``--device cpu`` is given, and raises where no
card is present.  Params are random from seed 0 and batch i is drawn from
a generator seeded with i, as the reference keys them.  Adam with
warm-up-cosine (10 warm-up steps) and the global norm clipped at 1, as the
reference.  Each step ends with its metrics read to the host, so the step
times it records are the device's too.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim
from repro_torch.configs.base import ALIASES, get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.specs import make_batch
from repro_torch.launch.steps import TrainHParams, make_train_step
from repro_torch.models import make_model
from repro_torch.tree import leaves


def batch_for_step(cfg, i: int, batch: int, seq: int,
                   device: torch.device) -> dict:
    gen = torch.Generator(device=device).manual_seed(i)
    return make_batch(cfg, batch, seq, generator=gen, device=device)


def train(arch: str, *, full: bool = False, steps: int = 50, batch: int = 4,
          seq: int = 128, lr: float = 3e-4, device=None,
          moe_impl: str = "sort", ckpt: str = "") -> dict:
    """Train ``steps`` steps -> {"cfg", "params", "opt_state", "step" (the
    train step), "n_params", "metrics" (one dict of floats a step),
    "step_seconds", "tokens_per_s" (over all steps)}."""
    if moe_impl != "sort":
        raise NotImplementedError(
            f"--moe-impl {moe_impl}: the MoE family is not ported yet "
            "(ROADMAP Queue 1 #1 MoE)")
    if ckpt:
        raise NotImplementedError(
            "--ckpt: checkpoints are not ported yet (ROADMAP Queue 1 #8)")
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_reduced_config(arch)
    model = make_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params on {dev}")

    opt = optim.adam(optim.warmup_cosine(lr, warmup=10, total_steps=steps),
                     clip_norm=1.0)
    step = make_train_step(model, opt, TrainHParams())
    opt_state = opt.init(params)
    history, seconds = [], []
    t0 = time.time()
    for i in range(steps):
        b = batch_for_step(cfg, i, batch, seq, dev)
        t = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        history.append({k: float(v) for k, v in metrics.items()})  # syncs
        seconds.append(time.perf_counter() - t)
        if i % 10 == 0 or i == steps - 1:
            tps = batch * seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}  loss {history[-1]['loss']:.4f}  "
                  f"ce {history[-1]['ce']:.4f}  tok/s {tps:,.0f}")
    return dict(cfg=cfg, params=params, opt_state=opt_state, step=step,
                n_params=n_params, metrics=history, step_seconds=seconds,
                tokens_per_s=batch * seq * steps / sum(seconds))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {sorted(ALIASES)}")
    ap.add_argument("--full", action="store_true",
                    help="the published config (needs the card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--moe-impl", default="sort")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args(argv)
    return train(args.arch, full=args.full, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 device=args.device, moe_impl=args.moe_impl,
                 ckpt=args.ckpt)


if __name__ == "__main__":
    main()
