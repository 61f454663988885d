"""Serving launcher, ported from ``repro/launch/serve.py``: the
continuous-batching ServeEngine over the paged KV cache, then the static
lockstep decode loop over a dense cache on the same model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --gen 32

Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
The model is the architecture's reduced config with random weights from a
fixed seed, as in the reference launcher.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ALIASES, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import make_model
from repro_torch.serve import Request, ServeConfig, ServeEngine


def _serve_static(model, params, args, device) -> None:
    """The pre-engine path: one fixed batch, lockstep greedy decode."""
    cache = model.init_cache(args.batch, args.cache_len, device=device)
    serve = make_serve_step(model)
    tok = torch.ones((args.batch, 1), dtype=torch.int32, device=device)
    tok, cache = serve(params, cache, tok, 0)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    toks = [tok]
    for t in range(1, args.gen):
        tok, cache = serve(params, cache, tok, t)
        toks.append(tok)
    out = torch.cat(toks, dim=1).cpu()  # waits for the device
    dt = time.time() - t0
    print(f"{model.cfg.name}: {args.batch} streams x {args.gen} tokens "
          f"(static batch), "
          f"{args.batch * (args.gen - 1) / dt:,.0f} tok/s steady-state")
    print("stream 0:", out[0, :16].tolist())


def _serve_engine(model, params, args, device) -> None:
    cfg = model.cfg
    scfg = ServeConfig(
        batch_rows=args.batch,
        prefill_chunk=16,
        token_budget=args.batch + 16,
        block_size=16,
        num_blocks=1 + args.batch * (args.cache_len // 16),
        max_seq=args.cache_len,
        temperature=args.temperature,
        top_k=args.top_k,
        seed=0,
    )
    engine = ServeEngine(model, params, scfg, paged=True, device=device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2 * args.batch, 8),
                            generator=gen)
    reqs = [
        Request(rid=i + 1, prompt=tuple(prompts[i].tolist()),
                max_new_tokens=args.gen)
        for i in range(2 * args.batch)
    ]
    res = engine.run(reqs)
    print(f"{cfg.name}: {res['completed']} requests x {args.gen} tokens "
          f"(continuous batching, paged KV), "
          f"{res['tokens_per_s']:,.0f} tok/s processed, "
          f"TTFT p50 {res['ttft_p50'] * 1e3:.1f} ms, "
          f"cache occupancy peak {res['cache_occupancy_peak']:.0%}")
    print("request 1:", res["outputs"][1][:16])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {sorted(ALIASES)}")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = make_model(get_reduced_config(args.arch))
    params = model.init(0, device=device)
    _serve_engine(model, params, args, device)
    _serve_static(model, params, args, device)


if __name__ == "__main__":
    main()
