#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. build    compile every CUDA source of the port (flash_decode.cu,
              vtrace.cu, flash_attention.cu, ssd_scan.cu, rglru_scan.cu)
              from this checkout, one nvcc each, all at once (sm_90a), and
              print the seconds and the ptxas report;
  2. kernels  hold the dense and the paged flash-decode kernel (split-K,
              then the combine kernel) against their plain PyTorch versions
              at the serving path's head shapes (B=8, H=12, K=2, h=128,
              ragged per-row positions) at S 256 and S 4096, and at the
              split's edge shapes (a row at pos 0, S not a multiple of the
              split, G 1 and 16, h 64 and 256, bs 16 and 32), in float32
              and bfloat16, with and without a window; check paged == dense
              bit for bit on the gathered cache and that a call repeated
              gives the same bits; at S 256 and S 4096 in bf16 time the
              kernel and scaled_dot_product_attention (a yardstick only:
              the port never calls it) in turns, five rounds, with an empty
              launch beside the S 256 rows, and the plain version once.
              Hold the V-trace kernel (v3, a two-level scan over time)
              against its plain version at the reference's sweep shapes,
              the Sebulba learner's (32, 20), the LLM learner's (2, 2047)
              (also on the learner's own inputs: discounts 0.99, rewards
              N(0, 0.1^2)), a large (4096, 100) and rows past one chunk of
              shared memory (T 14,081 and 20,000), with default and other
              clips; check that a repeated call gives the same bits, that
              the launcher's split is vtrace.plan's and whether the kernel
              equals the staged version (ref.vtrace_segmented_ref) bit for
              bit; time the kernel in turns with an empty launch, five
              rounds, and the plain version once, at (32, 20), (2, 2047)
              and (4096, 100).
              Hold the flash-attention kernel against its plain version at
              the reference's sweep shapes (window included), ragged
              shapes, v2's edge shapes (T not a multiple of 128, S past
              the last full tile, G 6) and the training shape (B 2,
              T 2048, H 12, K 2, h 128, causal, bf16), printing which of
              its two variants ran (v2, TMA and wgmma, for bf16 at h 64
              and 128; v1 for the rest); time v2 (beside v1's recorded
              time), the plain version and scaled_dot_product_attention
              (a yardstick only) there.
              Hold the SSD chunk scan (four kernels a call: the scores,
              the chunk states, the state pass, y; y, S_final, S_prevs)
              against its plain version and the plain version's staged
              form at the reference's sweep shapes, mamba2-1.3b's training
              shape (B 2, T 2048, H 64, P 64, N 128, Q 256) and the edge
              shapes (one chunk, Q 48, N 1 and N 128 at P 16) in float32
              and bfloat16, with strided views as the model hands them
              over: the reference's flat bounds, bounds that scale with
              the output, S_prevs[0] exactly 0; print the worst scaled
              errors, and time the kernel (beside v1's recorded time) and
              the plain version at the training shape in bf16.  Hold the RG-LRU scan kernel (y, h_T and the
              float32 states) against its plain version at the reference's
              sweep shapes in float32 and bfloat16, a ragged shape, and
              recurrentgemma-2b's training shape (B 2, T 2048, W 2560; x
              bf16, a and i float32 drawn as _rglru_gates makes them), and
              time both there;
  3. model    a reduced float32 qwen2 on the card (through the kernels)
              against the same weights on the CPU (plain versions);
  4. serve    qwen2-1.5b at full published width, random weights from a seed,
              bf16: 16 requests through the paged ServeEngine, then the dense
              one, with each kernel's launch count read over its run (the
              decode kernel and the combine kernel each 28 layers x decode
              steps); one
              dense engine prefill and decode call under
              torch.cuda.set_sync_debug_mode("error");
  5. learner  one Sebulba learner update of the full-width ConvActorCritic
              on the card (V-trace kernel) against the same update on the
              CPU (plain version), TF32 off;
  6. sebulba  the examples/sebulba_impala.py configuration trained on the
              card through Sebulba.fit for 200 trajectories, the V-trace
              launch count read over the run, then a profiled window;
  7. train    one LLM learner step of the reduced float32 qwen2 on the
              card against the same step on the CPU, TF32 off; then
              qwen2-1.5b at full width (bf16, remat per layer) for 5 steps
              of batch 2 x seq 2048 through launch/train.py, the
              flash-attention and V-trace launch counts read over the run
              (all 280 flash-attention launches v2's), then one profiled
              step;
  8. mamba2   the same for mamba2-1.3b: one reduced float32 step card vs
              CPU, then full width (bf16, remat per layer) for 5 steps of
              batch 2 x seq 2048 (ssd_scan 2 x 48 x 5 = 480 launches,
              V-trace 5), one full-width make_prefill_step call (48
              launches; its time beside v1's recorded one) with the kernel
              held against its plain version on the first layer's own
              inputs (flat and scaled bounds), then one profiled step whose
              ssd_scan line sums the four SSD kernels, each of which must
              appear in it;
  9. griffin  the same for recurrentgemma-2b: one reduced float32 step
              card vs CPU (T 128 over a window of 64), then full width
              (bf16, remat per layer) for 5 steps of batch 2 x seq 2048
              (rglru_scan 2 x 18 recurrent layers x 5 = 180 launches,
              V-trace 5, flash attention 0: the windowed layers take the
              plain route), one profiled step, and the windowed attention
              of one layer timed alone, forward and backward.

Then it prints a JSON line of kernel records, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and matmuls without TF32 (cuDNN's default is
    TF32), for the phases that hold the card against the CPU."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


# --------------------------------------------------------------- timing


def time_ms(fn, flush, iters: int = 30) -> float:
    """Median device time of one call, with L2 flushed before each (the
    decode step finds its layer's K/V cold: a layer's weights pass through
    L2 between two reads of its cache)."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def live_rows(pos: list[int], S: int, window: int) -> list[int]:
    out = []
    for p in pos:
        hi = min(p, S - 1)
        lo = max(p - window + 1, 0) if window else 0
        out.append(max(hi - lo + 1, 0))
    return out


def bound(q, K, pos, S, window, extra_bytes=0) -> tuple[float, str]:
    """Least time for the decode: each input byte read once (q, the live
    K/V rows, pos, the table) and the output written once, against 4*G*h
    flops per live row and kv head."""
    B, _, H, h = q.shape
    item = q.element_size()
    live = sum(live_rows(pos, S, window))
    nbytes = 2 * q.numel() * item + live * K * h * 2 * item + 4 * B
    nbytes += extra_bytes
    ops = live * K * 4 * (H // K) * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ phase 1


def build_phase() -> None:
    """Every CUDA source of the port, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.vtrace import vtrace as vt

    sources = [fd.SOURCE, vt.SOURCE, fa.SOURCE, ssd.SOURCE, rg.SOURCE]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    print(f"build  {len(sources)} sources in {time.monotonic() - t0:.2f} s")
    for path, secs, log in built:
        print(f"build  {path.name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build  {line.strip()}")


# ------------------------------------------------------------ phase 2


# flash-decode: the serving shape (B 8, H 12, K 2, h 128, bs 16) at S 256
# and at S 4096, timed; and the split's edge shapes (the CPU tests'): a row
# at pos 0 (later splits wholly masked), S not a multiple of the split, G 1
# and 16, h 64 and 256, bs 16 and 32, and pages of 24 (not a power of two,
# straddling the splits).  (B, S, H, K, h, pos, bs)
FD_SHAPES = [
    (8, 256, 12, 2, 128, [0, 31, 32, 100, 127, 200, 254, 255], 16),
    (8, 4096, 12, 2, 128, [0, 255, 256, 1000, 2047, 3000, 4000, 4095], 16),
    (3, 96, 4, 2, 64, [0, 40, 95], 32),
    (2, 256, 2, 2, 128, [255, 130], 32),
    (2, 128, 16, 1, 64, [0, 127], 16),
    (1, 192, 8, 2, 256, [150], 16),
    (2, 120, 12, 2, 128, [119, 50], 24),
]
# bf16 outputs are also held against the plain version computed in float32
# on the same inputs, within half a bf16 ulp (2**-8 of the magnitude) plus
# the float32 tolerance: a bound that scales with the output, where the
# flat 2e-2 is as large as a long row's outputs (|out| ~ 0.03 at S 4096)
FD_BF16_REL = 2.0**-8
FD_TIMED = 2  # the first shapes, timed in bf16
FD_ROUNDS = 5  # kernel and SDPA timed in turns, this many rounds each


def spread(ts: list[float]) -> str:
    return f"{statistics.median(ts):.4f} [{min(ts):.4f}, {max(ts):.4f}]"


def kernel_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.flash_decode import ref

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    tiny = torch.empty(1, dtype=torch.int32, device=dev)
    records = {"flash_decode": {}, "flash_decode_paged": {}}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def paged_layout(kc, vc, pos_list, bs):
        """Scatter a dense cache into a permuted page pool; each row's
        unmapped tail entries point at page 0."""
        B, S, K, h = kc.shape
        nb = S // bs
        P = 1 + B * nb
        perm = 1 + torch.randperm(P - 1, generator=gen, device=dev)
        table = perm.reshape(B, nb).to(torch.int32)
        kp = randn(P, bs, K, h, dtype=kc.dtype)
        vp = randn(P, bs, K, h, dtype=kc.dtype)
        kp[table.long()] = kc.reshape(B, nb, bs, K, h)
        vp[table.long()] = vc.reshape(B, nb, bs, K, h)
        for b, p in enumerate(pos_list):
            table[b, p // bs + 1:] = 0
        return kp, vp, table.contiguous()

    def sdpa(q, kc, vc, pos):
        """The same decode as one PyTorch call: a yardstick, timed only."""
        k_pos = torch.arange(kc.shape[1], device=dev)
        mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask,
                                                      enable_gqa=True)

    def max_err(a, b) -> float:
        return (a.float() - b.float()).abs().max().item()

    def bf16_excess(out, exact) -> float:
        """How far a bf16 output lies past half an ulp of the float32
        result: <= the float32 tolerance when only the rounding differs."""
        return ((out.float() - exact).abs()
                - FD_BF16_REL * exact.abs()).max().item()

    def scaled(dtype, out, fn, *args, **kw) -> str:
        """The scaled bf16 check of ``out`` against ``fn`` in float32."""
        if dtype != torch.bfloat16:
            return ""
        args = [a.float() if a.is_floating_point() else a for a in args]
        exact = fn(*args, **kw)
        excess = bf16_excess(out, exact)
        scaled_errs.append(excess)
        check(excess <= TOL["torch.float32"], f"bf16 output {excess} past "
              f"half an ulp of the float32 result")
        return (f" past_half_ulp={excess:.3e} (tol {TOL['torch.float32']}; "
                f"max|out| {exact.abs().max().item():.3e})")

    scaled_errs = []

    for i_shape, (B, S, H, K, h, pos_list, bs) in enumerate(FD_SHAPES):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        print(f"plan   S={S} B={B} H={H} K={K}: {fd.plan(S, B, H, K)}")
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype)]
            q = randn(B, 1, H, h, dtype=dtype)
            kc, vc = randn(B, S, K, h, dtype=dtype), randn(B, S, K, h, dtype=dtype)
            errs = {}
            for window in (0, 100):
                out = fd.flash_decode_cuda(q, kc, vc, pos, window=window)
                again = fd.flash_decode_cuda(q, kc, vc, pos, window=window)
                want = ref.decode_attention_ref(q, kc, vc, pos, window=window)
                torch.cuda.synchronize()
                err = errs[window] = max_err(out, want)
                past = scaled(dtype, out, ref.decode_attention_ref, q, kc, vc,
                              pos, window=window)
                print(f"dense  S={S:5d} G={H // K:2d} h={h:3d} {str(dtype):15s} "
                      f"window={window:3d} max_abs_err={err:.3e} (tol {tol})"
                      f"{past} repeat_equal {torch.equal(out, again)}")
                check(bool(torch.isfinite(out).all()), "dense output not finite")
                check(err <= tol, f"dense kernel off by {err} at S={S} {dtype}")
                check(torch.equal(out, again), f"dense kernel not repeatable "
                      f"at S={S} {dtype}")
            kp, vp, table = paged_layout(kc, vc, pos_list, bs)
            out_p = fd.flash_decode_paged_cuda(q, kp, vp, table, pos)
            again_p = fd.flash_decode_paged_cuda(q, kp, vp, table, pos)
            want_p = ref.paged_decode_attention_ref(q, kp, vp, table, pos)
            kg, vg = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
            dense_g = fd.flash_decode_cuda(q, kg, vg, pos)
            torch.cuda.synchronize()
            err_p = max_err(out_p, want_p)
            past = scaled(dtype, out_p, ref.paged_decode_attention_ref, q, kp,
                          vp, table, pos)
            same = torch.equal(out_p, dense_g)
            print(f"paged  S={S:5d} G={H // K:2d} h={h:3d} {str(dtype):15s} "
                  f"bs={bs} max_abs_err={err_p:.3e} (tol {tol}){past} "
                  f"paged==dense {same} repeat_equal "
                  f"{torch.equal(out_p, again_p)}")
            check(err_p <= tol, f"paged kernel off by {err_p} at S={S} {dtype}")
            check(same, f"paged != dense on the gathered cache at S={S} {dtype}")
            check(torch.equal(out_p, again_p), f"paged kernel not repeatable "
                  f"at S={S} {dtype}")

            if dtype != torch.bfloat16 or i_shape >= FD_TIMED:
                continue
            # times at the serving shape (max_seq 256) and a long cache:
            # kernel and SDPA in turns, L2 flushed before each call; SDPA
            # for the paged kernel runs on the already-gathered cache
            P = kp.shape[0]
            for name, kernel, plain, lib, err, extra in (
                ("flash_decode",
                 lambda: fd.flash_decode_cuda(q, kc, vc, pos),
                 lambda: ref.decode_attention_ref(q, kc, vc, pos),
                 sdpa(q, kc, vc, pos), errs[0], 0),
                ("flash_decode_paged",
                 lambda: fd.flash_decode_paged_cuda(q, kp, vp, table, pos),
                 lambda: ref.paged_decode_attention_ref(q, kp, vp, table, pos),
                 sdpa(q, kg, vg, pos), err_p, table.numel() * 4),
            ):
                turns = {"kernel": [], "sdpa": [], "empty": []}
                for _ in range(FD_ROUNDS):
                    turns["kernel"].append(time_ms(kernel, flush))
                    turns["sdpa"].append(time_ms(lib, flush))
                    if S == 256:
                        turns["empty"].append(time_ms(tiny.zero_, flush))
                plain_ms = time_ms(plain, flush)
                bound_ms, bound_by = bound(q, K, pos_list, S, 0, extra)
                ms = statistics.median(turns["kernel"])
                library_ms = statistics.median(turns["sdpa"])
                empty = (f" empty_launch_ms {spread(turns['empty'])}"
                         if S == 256 else "")
                print(f"time   S={S:5d} {name:19s} ms {spread(turns['kernel'])} "
                      f"sdpa_ms {spread(turns['sdpa'])}"
                      f"{' (on the gathered cache)' if extra else ''} "
                      f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
                      f"({bound_by}, {bound_ms / ms:.3f} of it){empty} P={P} "
                      f"rounds={FD_ROUNDS}")
                rec = dict(max_abs_err=err, ms=ms,
                           ms_range=[min(turns["kernel"]), max(turns["kernel"])],
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms,
                           library_ms_range=[min(turns["sdpa"]),
                                             max(turns["sdpa"])])
                if extra:
                    rec["library_on"] = "the gathered cache"
                if S == 256:
                    rec["empty_launch_ms"] = statistics.median(turns["empty"])
                    records[name].update(rec)
                else:
                    records[name]["at_S4096"] = rec
    print(f"kernel flash-decode bf16: worst output past half an ulp of the "
          f"float32 plain version {max(scaled_errs):.3e} over "
          f"{len(scaled_errs)} checks (tol {TOL['torch.float32']})")
    return records


# ---------------------------------------------------- phase 2, V-trace

# the reference's sweep (tests/test_kernels.py), the Sebulba learner's
# (32, 20), the LLM learner's (2, 2047) (batch 2 x seq 2048, one step
# fewer), a large batch, ragged edges (T = 1, one row, T past the 9-step
# segments' 2,304), and rows past one chunk of shared memory
VTRACE_SHAPES = [(8, 32), (16, 100), (4, 7), (10, 12), (5, 9), (3, 6),
                 (32, 20), (2, 2047), (4096, 100), (33, 33), (64, 1), (1, 200),
                 (2, 2305), (3, 14081), (1, 20000)]
VTRACE_CLIPS = [{}, dict(clip_rho=0.9, clip_c=0.8, lambda_=0.95)]
VTRACE_OPS_PER_ELEMENT = 16  # exp, 2 min, 13 multiply/add (vtrace.cu)
VTRACE_TIMED = ((32, 20), (2, 2047), (4096, 100))
VTRACE_ROUNDS = 5  # kernel and an empty launch timed in turns


def vtrace_bound(B: int, T: int) -> tuple[float, str]:
    """Least time for V-trace: four (B, T) f32 inputs and the (B,)
    bootstrap read once, two (B, T) outputs written once, against
    VTRACE_OPS_PER_ELEMENT f32 operations per element."""
    t_bytes = 4 * (6 * B * T + B) / HBM_BYTES_PER_S
    t_ops = VTRACE_OPS_PER_ELEMENT * B * T / PEAK_OPS_PER_S["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def vtrace_phase(dev) -> dict:
    import torch

    from repro_torch.kernels.vtrace import ref
    from repro_torch.kernels.vtrace import vtrace as vt

    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    tiny = torch.empty(1, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T):
        disc = (torch.rand(B, T, generator=gen, device=dev) > 0.1).float()
        return [0.3 * randn(B, T), disc * 0.99, randn(B, T), randn(B, T),
                randn(B)]

    def learner_inputs(B, T):
        """make_batch's fields (launch/specs.py): discounts 0.99, rewards
        N(0, 0.1^2), behaviour log-probs -|N(0, 1)|; target log-probs drawn
        the same way, values N(0, 0.1^2)."""
        log_rhos = randn(B, T).abs() - randn(B, T).abs()
        return [log_rhos, torch.full((B, T), 0.99, device=dev),
                0.1 * randn(B, T), 0.1 * randn(B, T), 0.1 * randn(B)]

    errs = {}
    cases = [(B, T, "", inputs(B, T)) for B, T in VTRACE_SHAPES]
    cases.append((2, 2047, " learner", learner_inputs(2, 2047)))
    staged_equal = []
    for B, T, label, xs in cases:
        plan = vt.plan(B, T)
        check(vt.library_plan(B, T) == plan, f"vtrace launcher's split "
              f"{vt.library_plan(B, T)} != plan {plan} at ({B}, {T})")
        for i, clips in enumerate(VTRACE_CLIPS):
            got = vt.vtrace_cuda(*xs, **clips)
            again = vt.vtrace_cuda(*xs, **clips)
            want = ref.vtrace_ref(*xs, **clips)
            staged = ref.vtrace_segmented_ref(*xs, plan=plan, **clips)
            torch.cuda.synchronize()
            err = excess = 0.0
            for g, w in zip(got, want):
                check(bool(torch.isfinite(g).all()), "vtrace output not finite")
                d = (g - w).abs()
                err = max(err, d.max().item())
                excess = max(excess, (d - 1e-5 * w.abs()).max().item())
            repeat = all(torch.equal(g, a) for g, a in zip(got, again))
            same = all(torch.equal(g, w) for g, w in zip(got, staged))
            staged_equal.append(same)
            errs[B, T, label, i] = err
            print(f"vtrace B={B:5d} T={T:5d}{label} clips={clips or 'default'} "
                  f"max_abs_err={err:.3e} (tol 1e-5 + 1e-5*|ref|) "
                  f"repeat_equal {repeat} staged_equal {same} "
                  f"plan P={plan.row_threads} L={plan.seg} "
                  f"chunks={plan.chunks} blocks={plan.blocks}")
            check(excess <= 1e-5, f"vtrace kernel off by {err} at "
                  f"({B}, {T}){label} {clips}")
            check(repeat, f"vtrace kernel not repeatable at ({B}, {T}){label}")
    print(f"vtrace kernel equal to the staged version bit for bit in "
          f"{sum(staged_equal)} of {len(staged_equal)} checks")

    record = {}
    for B, T in VTRACE_TIMED:
        xs = inputs(B, T)
        turns = {"kernel": [], "empty": []}
        for _ in range(VTRACE_ROUNDS):
            turns["kernel"].append(time_ms(lambda: vt.vtrace_cuda(*xs), flush))
            turns["empty"].append(time_ms(tiny.zero_, flush))
        ms = statistics.median(turns["kernel"])
        empty_ms = statistics.median(turns["empty"])
        plain_ms = time_ms(lambda: ref.vtrace_ref(*xs), flush)
        bound_ms, bound_by = vtrace_bound(B, T)
        print(f"time   vtrace B={B:5d} T={T:4d} ms {spread(turns['kernel'])} "
              f"empty_launch_ms {spread(turns['empty'])} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}, "
              f"{bound_ms / ms:.4f} of it) rounds={VTRACE_ROUNDS} "
              "library_ms=- (no single PyTorch call computes V-trace)")
        nums = dict(max_abs_err=max(v for k, v in errs.items()
                                    if k[:2] == (B, T)),
                    ms=ms, ms_range=[min(turns["kernel"]),
                                     max(turns["kernel"])],
                    empty_launch_ms=empty_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
        if (B, T) == (32, 20):  # the Sebulba learner's shape
            record.update(nums, library_ms=None)
        elif (B, T) == (2, 2047):  # the LLM learner's shape
            record["train_shape"] = dict(nums, B=B, T=T)
        else:
            record["large_batch"] = dict(nums, B=B, T=T)
    return {"vtrace": record}


# ------------------------------------------------ phase 2, flash attention

# (B, T, S, H, K, h, causal, window, softcap): the reference's sweep
# (tests/test_kernels.py:27-36), ragged shapes, then the training shape
FA_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 4, 32, True, 0, 0.0),
    (2, 128, 128, 4, 1, 64, False, 0, 0.0),
    (1, 256, 256, 2, 2, 64, True, 64, 0.0),
    (1, 128, 128, 8, 2, 128, True, 0, 0.0),
    (1, 100, 100, 4, 2, 64, True, 0, 30.0),
    (1, 100, 100, 4, 2, 64, False, 0, 0.0),
    (2, 77, 300, 4, 2, 256, False, 0, 0.0),
    (2, 2047, 2047, 12, 2, 128, True, 0, 0.0),
    # v2's edges: T not a multiple of its 128-row tiles (G 6), S past the
    # last full tile, G 6 at h 64, a window across tiles, softcap at the
    # training shape
    (1, 300, 300, 12, 2, 128, True, 0, 0.0),
    (2, 128, 200, 4, 2, 128, False, 0, 0.0),
    (1, 1000, 1000, 6, 1, 64, True, 0, 0.0),
    (1, 1000, 1000, 12, 2, 128, True, 300, 0.0),
    (2, 2048, 2048, 12, 2, 128, True, 0, 30.0),
]
FA_V1_MS = 0.2618  # v1 at FA_TRAIN on an H100 at 700 W (PERF.md §6)
FA_TRAIN = (2, 2048, 2048, 12, 2, 128, True, 0, 0.0)  # qwen2-1.5b, 2 x 2048
FA_LSE_TOL = 1e-4  # float32 sums over up to 2048 keys in another order


def flash_attention_bound(B, T, S, H, K, h, causal, item) -> tuple[float, str]:
    """Least time for the forward: q, k, v read once, out and lse written
    once, against 4 * h flops (QK^T and PV) per (query, key) pair the mask
    keeps, over the bf16 (or f32) peak."""
    pairs = sum(min(t + 1, S) for t in range(T)) if causal else T * S
    t_ops = 4 * h * B * H * pairs / PEAK_OPS_PER_S[
        "torch.bfloat16" if item == 2 else "torch.float32"]
    nbytes = item * (2 * B * T * H * h + 2 * B * S * K * h) + 4 * B * H * T
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_attention_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def inputs(B, T, S, H, K, h, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, T, H, h), (B, S, K, h), (B, S, K, h))]

    train_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype)]
        for B, T, S, H, K, h, causal, window, cap in FA_SHAPES + [FA_TRAIN]:
            q, k, v = inputs(B, T, S, H, K, h, dtype)
            which = fa.variant(dtype, h)
            before = dict(fa.VARIANT_LAUNCHES)
            out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, softcap=cap)
            want, want_lse = ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=cap)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            print(f"flash  {which} {str(dtype):15s} B={B} T={T:4d} S={S:4d} "
                  f"H={H:2d} K={K} h={h:3d} causal={causal:d} "
                  f"window={window:3d} softcap={cap:4.1f} max_abs_err="
                  f"{err:.3e} (tol {tol}) lse_err={lse_err:.3e} (tol "
                  f"{FA_LSE_TOL})")
            check(fa.VARIANT_LAUNCHES[which] == before[which] + 1,
                  f"flash attention {which} not launched")
            check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
                  "flash attention output not finite")
            check(err <= tol, f"flash kernel off by {err} at {B, T, S, H, K, h}"
                  f" {dtype}")
            check(lse_err <= FA_LSE_TOL, f"flash kernel lse off by {lse_err}")
            if (B, T, S, H, K, h) == FA_TRAIN[:6] and dtype == torch.bfloat16:
                train_err = err

    B, T, S, H, K, h, causal, _, _ = FA_TRAIN
    q, k, v = inputs(B, T, S, H, K, h, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():  # a yardstick, timed only: the port never calls it
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = (sdpa().transpose(1, 2).float()
               - fa.flash_attention_cuda(q, k, v)[0].float()).abs().max().item()
    variant = fa.variant(q.dtype, h)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v), flush)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), flush)
    library_ms = time_ms(sdpa, flush)
    bound_ms, bound_by = flash_attention_bound(B, T, S, H, K, h, causal, 2)
    print(f"time   flash_attention B={B} T={T} H={H} K={K} h={h} causal bf16 "
          f"{variant} ms={ms:.4f} (v1 {FA_V1_MS} recorded) "
          f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.5f} ({bound_by}); sdpa vs kernel "
          f"max_abs_diff={lib_err:.3e}; worst bf16 error at the training "
          f"shape {train_err:.4e}")
    return {"flash_attention": dict(max_abs_err=train_err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms,
                                    variant=variant)}


# ------------------------------------------------- phase 2, SSD chunk scan

# (B, T, H, P, N, Q): the reference's sweep (tests/test_kernels.py:55-74),
# then mamba2-1.3b's training shape (batch 2 x seq 2048, H 64, P 64,
# N 128, chunk 256), then the kernel's edge shapes: one chunk (T = Q =
# 256), a chunk of 48 rows (not a multiple of the kernel's 16-row tiles or
# its 128-row query tiles), N 1 (B and C rows too short for a 16-byte
# copy: the element-by-element path) and N 128 at P 16
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64),
              (2, 64, 8, 16, 8, 16)]
SSD_FULL = (2, 2048, 64, 64, 128, 256)
SSD_EDGE = [(1, 256, 4, 64, 128, 256), (1, 96, 2, 32, 16, 48),
            (2, 64, 4, 16, 1, 32), (2, 128, 4, 16, 128, 64)]
SSD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 0.05}  # the reference's
# and beside them bounds that scale with the output: y within half a bf16
# ulp (2**-8 of |want|) plus SSD_SCALED * max|want| of the plain version in
# float32 on the same inputs, S_final and S_prevs within SSD_SCALED *
# max|want|.  At the training shape |y| reaches ~45: the flat 0.05 is less
# than one bf16 ulp of the largest outputs and more than most others
SSD_SCALED = 1e-4
# v1, the kernel this source replaced (one block per (head, row) walking
# its chunks), timed in turns with this one at the training shape
# (PERF.md section 6)
SSD_V1_MS = 2.6099
SSD_V1_PREFILL_MS = 204.274  # mamba2-1.3b make_prefill_step, batch 2 x 2048
# the kernels of one ssd_scan_cuda call, in launch order
SSD_KERNELS = ("ssd_gram_kernel", "ssd_state_kernel", "ssd_pass_kernel",
               "ssd_out_kernel")


def ssd_bound(B, T, H, P, N, Q, item) -> tuple[float, str]:
    """Least time for the scan: the Pallas contract's inputs (x, dt, A, B,
    C) read once and outputs (y, S_final) written once, against the flops
    the function needs: the scores C B^T of the causal pairs, Q (Q + 1) N
    once per (b, chunk) since B and C are shared by the heads; per
    (b, h, chunk) their decayed product with dt x, Q (Q + 1) P, and the
    read-out and the state update, 4 Q P N.  Over the float32 rate: the
    function computes in float32 (the Pallas kernel upcasts every input),
    which the card does at 67 TFLOP/s outside the tensor cores.  The count
    is the function's, whatever computes it: the kernel runs every product
    on the CUDA cores in float32, so this is a bound on its time."""
    nc = T // Q
    flops = (nc * B * Q * (Q + 1) * N
             + nc * B * H * (Q * (Q + 1) * P + 4 * Q * P * N))
    nbytes = (item * (2 * B * T * H * P + 2 * B * T * N) + 4 * B * T * H
              + 4 * H + 4 * B * H * P * N)
    t_ops = flops / PEAK_OPS_PER_S["torch.float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ssd_check(got, xs, Q, label: str) -> list[float]:
    """The kernel's (y, S_final, S_prevs) against the plain chunk scan on
    the same inputs: finite, S_prevs[0] exactly 0, the flat bound of the
    dtype, and the scaled bounds (SSD_SCALED) against the plain version
    and against its staged form, both computed in float32 (the staged form
    rounds a bf16 y elsewhere, so its bf16 y may sit one ulp from the
    kernel's).  Prints and returns [flat error, scaled y, scaled S_final,
    scaled S_prevs], the worse of the two references for each."""
    import torch

    from repro_torch.kernels.ssd_scan import ref

    dtype = str(xs[0].dtype)
    want = ref.ssd_chunk_scan_ref(*xs, Q)
    xs32 = [t.float() for t in xs]
    want32 = ref.ssd_chunk_scan_ref(*xs32, Q)
    staged32 = ref.ssd_staged_ref(*xs32, Q)
    torch.cuda.synchronize()

    def rel(err, w):
        scale = w.abs().max().item()
        return err / scale if scale else (0.0 if err == 0 else float("inf"))

    def scaled(w, y32):
        """y's excess over half a bf16 ulp of y32, the states' errors."""
        out = [rel(((got[0].float() - y32).abs()
                    - 2.0**-8 * y32.abs()).max().item(), y32)]
        return out + [rel((g - v).abs().max().item(), v)
                      for g, v in zip(got[1:], w[1:])]

    flat = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    errs = [max(a, b) for a, b in zip(scaled(want, want32[0]),
                                      scaled(staged32, staged32[0]))]
    print(f"ssd    {label}: max_abs_err y={flat[0]:.3e} "
          f"S_final={flat[1]:.3e} S_prevs={flat[2]:.3e} (tol "
          f"{SSD_TOL[dtype]}) scaled y={errs[0]:.3e} S_final={errs[1]:.3e} "
          f"S_prevs={errs[2]:.3e} (tol {SSD_SCALED}; plain and staged) "
          f"max|y|={want32[0].abs().max().item():.3f}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"ssd_scan output not finite at {label}")
    check(float(got[2][0].abs().max()) == 0.0,
          f"ssd_scan S_prevs[0] not exactly 0 at {label}")
    check(max(flat) <= SSD_TOL[dtype],
          f"ssd_scan kernel off by {max(flat)} at {label}")
    check(max(errs) <= SSD_SCALED,
          f"ssd_scan kernel past the scaled bounds ({errs}) at {label}")
    return [max(flat)] + errs


def ssd_scan_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T, H, P, N, dtype, strided=False):
        """As the model makes them: dt = softplus(N(0,1) + 0.5),
        A = -exp(0.5 N(0,1)); x, B and C as the reference's test draws
        them.  ``strided``: x, B and C are views of one (B, T, H P + 2 N)
        tensor, as mamba2_block hands them over."""
        dt = F.softplus(randn(B, T, H) + 0.5)
        A = -torch.exp(0.5 * randn(H))
        if strided:
            wide = torch.cat([randn(B, T, H * P), 0.3 * randn(B, T, 2 * N)],
                             dim=-1).to(dtype)
            return (wide[..., :H * P].reshape(B, T, H, P), dt, A,
                    wide[..., H * P:H * P + N], wide[..., H * P + N:])
        return (randn(B, T, H, P).to(dtype), dt, A,
                (0.3 * randn(B, T, N)).to(dtype),
                (0.3 * randn(B, T, N)).to(dtype))

    full_err = 0.0
    worst = [0.0, 0.0, 0.0]  # scaled y, S_final, S_prevs over every case
    cases = [(s, d, False) for d in (torch.float32, torch.bfloat16)
             for s in SSD_SHAPES + [SSD_FULL] + SSD_EDGE]
    cases += [((2, 128, 16, 32, 16, 32), torch.float32, True),
              ((2, 64, 4, 16, 1, 32), torch.bfloat16, True),
              (SSD_FULL, torch.bfloat16, True)]
    for (B, T, H, P, N, Q), dtype, strided in cases:
        xs = inputs(B, T, H, P, N, dtype, strided)
        got = ssd.ssd_scan_cuda(*xs, chunk=Q)
        errs = ssd_check(got, xs, Q, f"{str(dtype):14s} B={B} T={T:4d} "
                         f"H={H:2d} P={P:2d} N={N:3d} Q={Q:3d} "
                         f"strided={strided:d}")
        worst = [max(a, b) for a, b in zip(worst, errs[1:])]
        if (B, T, H, P, N, Q) == SSD_FULL and dtype == torch.bfloat16:
            full_err = max(full_err, errs[0])
    print(f"ssd    worst scaled errors over {len(cases)} cases: y "
          f"{worst[0]:.3e}, S_final {worst[1]:.3e}, S_prevs {worst[2]:.3e} "
          f"(tol {SSD_SCALED})")

    B, T, H, P, N, Q = SSD_FULL
    xs = inputs(B, T, H, P, N, torch.bfloat16, strided=True)
    ms = time_ms(lambda: ssd.ssd_scan_cuda(*xs, chunk=Q), flush)
    plain_ms = time_ms(lambda: ref.ssd_chunk_scan_ref(*xs, Q), flush)
    bound_ms, bound_by = ssd_bound(B, T, H, P, N, Q, 2)
    print(f"time   ssd_scan B={B} T={T} H={H} P={P} N={N} Q={Q} bf16 "
          f"ms={ms:.4f} (v1 {SSD_V1_MS} recorded) plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.5f} ({bound_by}; {bound_ms / ms:.3f} of it) "
          "library_ms=- (no single PyTorch call computes the SSD scan)")
    return {"ssd_scan": dict(max_abs_err=full_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None, scaled_err=max(worst))}


# ------------------------------------------------- phase 2, RG-LRU scan

# (B, T, W): the reference's sweep (tests/test_kernels.py:80-83), a ragged
# shape (T and W below their blocks), then recurrentgemma-2b's training
# shape (batch 2 x seq 2048, RG-LRU width 2560)
RGLRU_SHAPES = [(2, 64, 128), (1, 128, 256), (3, 100, 100)]
RGLRU_FULL = (2, 2048, 2560)
RGLRU_OPS_PER_ELEMENT = 8  # a*a, 1-, max, sqrt, i*x, beta*, FMA (2)


def rglru_bound(B, T, W, items) -> tuple[float, str]:
    """Least time for the scan: x, a and i read once, y (x's dtype) and the
    float32 states written once, against RGLRU_OPS_PER_ELEMENT float32
    operations an element.  ``items``: the bytes of an x, a and i."""
    n = B * T * W
    nbytes = n * (2 * items[0] + items[1] + items[2] + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = RGLRU_OPS_PER_ELEMENT * n / PEAK_OPS_PER_S["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rglru_scan_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rglru_scan import ref
    from repro_torch.kernels.rglru_scan import rglru_scan as rg

    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T, W, dtypes, griffin=False):
        """As the reference's test draws them (a, i the sigmoid of
        N(0, 1)), or as _rglru_gates makes them: i the sigmoid of N(0, 1),
        a = exp(-8 softplus(0.7) r) with r the sigmoid of N(0, 1)."""
        x = randn(B, T, W)
        r, gi = torch.sigmoid(randn(B, T, W)), torch.sigmoid(randn(B, T, W))
        a = torch.exp(-8.0 * F.softplus(torch.tensor(0.7)) * r) if griffin \
            else r
        return [t.to(d) for t, d in zip((x, a, gi), dtypes)]

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(s, (d, d, d), False) for d in (f32, bf16)
             for s in RGLRU_SHAPES]
    cases += [(RGLRU_FULL, (bf16, f32, f32), True)]
    full_err = 0.0
    for (B, T, W), dtypes, griffin in cases:
        tol = TOL[str(dtypes[0])]
        xs = inputs(B, T, W, dtypes, griffin)
        y, h = rg.rglru_scan_cuda(*xs)
        want_y, want_h = ref.rglru_scan_ref(*xs)
        torch.cuda.synchronize()
        err_y = (y.float() - want_y.float()).abs().max().item()
        err_hT = (y[:, -1].float() - want_y[:, -1].float()).abs().max().item()
        err_h = (h - want_h).abs().max().item()
        print(f"rglru  x {str(dtypes[0]):14s} a {str(dtypes[1]):14s} "
              f"i {str(dtypes[2]):14s} B={B} T={T:4d} W={W:4d} max_abs_err "
              f"y={err_y:.3e} h_T={err_hT:.3e} (tol {tol}) states="
              f"{err_h:.3e} (tol 2e-05) max|h|={want_h.abs().max().item():.3f}")
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              "rglru_scan output not finite")
        check(err_y <= tol and err_hT <= tol and err_h <= 2e-5,
              f"rglru_scan kernel off by {err_y} / {err_h} at {B, T, W} "
              f"{dtypes}")
        if griffin:
            full_err = max(err_y, err_hT)

    B, T, W = RGLRU_FULL
    xs = inputs(B, T, W, (bf16, f32, f32), griffin=True)
    ms = time_ms(lambda: rg.rglru_scan_cuda(*xs), flush)
    plain_ms = time_ms(lambda: ref.rglru_scan_ref(*xs), flush)
    bound_ms, bound_by = rglru_bound(B, T, W, (2, 4, 4))
    print(f"time   rglru_scan B={B} T={T} W={W} x bf16, a and i f32 "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by}) library_ms=- (no single PyTorch call computes the "
          "RG-LRU scan)")
    return {"rglru_scan": dict(max_abs_err=full_err, ms=ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None)}


# ------------------------------------------------------------ phase 3


def model_phase(dev) -> None:
    """Reduced qwen2 in float32: the card (kernels) against the CPU (plain
    versions) on the same weights, dense and paged, prefill then decode."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_reduced_config("qwen2-1.5b"),
                              param_dtype="float32", cache_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    cpu = torch.device("cpu")

    B, C, bs, nb = 2, 8, 16, 4
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (B, C), generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=gen)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]], dtype=torch.int32)
    def run(d, paged):
        p = params if d == dev else _tree_to(params, cpu)
        zeros = torch.zeros(B, dtype=torch.int32, device=d)
        if paged:  # one (1, C) prefill per row, as the paged engine does
            cache = model.init_paged_cache(1 + B * nb, bs, device=d)
            tables = table.to(d)
            logs = [model.prefill_step(p, cache, prompt[r:r + 1].to(d),
                                       zeros[r:r + 1], tables[r:r + 1])[0]
                    for r in range(B)]
        else:
            cache = model.init_cache(B, nb * bs, device=d)
            tables = None
            logs = [model.prefill_step(p, cache, prompt.to(d), zeros)[0]]
        for i in range(len(steps)):
            pos = torch.tensor([C + i, C + 2 * i], dtype=torch.int32, device=d)
            logs.append(model.decode_step(p, cache, steps[i].to(d), pos,
                                          tables)[0])
        return [x.cpu() for x in logs]

    worst = 0.0
    for paged in (False, True):
        for a, b in zip(run(dev, paged), run(cpu, paged)):
            check(bool(torch.isfinite(a).all()), "model logits not finite")
            worst = max(worst, (a - b).abs().max().item())
    print(f"model  reduced qwen2 f32 card vs cpu: max_abs_err={worst:.3e} "
          "(tol 1e-4)")
    check(worst <= 1e-4, f"card and cpu logits differ by {worst}")


# ------------------------------------------------------------ phase 4


def serve_phase(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"serve  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
          f"H={cfg.num_heads}/K={cfg.num_kv_heads} h={cfg.head_dim} "
          f"V={cfg.vocab_size} {cfg.param_dtype}: {n_params:,} params, "
          f"init {time.monotonic() - t0:.2f} s")

    scfg = ServeConfig(batch_rows=8, prefill_chunk=16, token_budget=24,
                       block_size=16, max_seq=256, num_blocks=129)
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 65, size=16)
    reqs = [Request(rid=i + 1,
                    prompt=tuple(int(t) for t in
                                 rng.integers(0, cfg.vocab_size, size=n)),
                    max_new_tokens=32)
            for i, n in enumerate(lengths)]
    warm = [Request(rid=100, prompt=(1, 2, 3), max_new_tokens=3)]

    results, launches = {}, {}
    for paged in (True, False):
        name = "paged" if paged else "dense"
        engine = ServeEngine(model, params, scfg, paged=paged)
        engine.run(warm)  # first-call library set-up stays out of the run
        engine.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fd.reset_launches()
        res = engine.run(reqs)
        launches[name] = dict(fd.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        results[name] = res
        print(f"serve  {name}: completed={res['completed']} "
              f"steps={res['steps']} decode_steps={engine.decode_steps} "
              f"prefill_chunks={res['prefill_chunks']} "
              f"tokens_per_s={res['tokens_per_s']:.2f} "
              f"ttft_p50={res['ttft_p50']:.6f} s tpot_p50={res['tpot_p50']:.6f} s "
              f"seconds={res['seconds']:.4f} peak_mem={peak / 2**30:.3f} GiB "
              f"launches={launches[name]}")
        check(res["completed"] == len(reqs), f"{name}: not all requests done")
        for r in reqs:
            toks = res["outputs"][r.rid]
            check(len(toks) == r.max_new_tokens, f"{name}: short output")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"{name}: token out of range")
        kernel = "flash_decode_paged" if paged else "flash_decode"
        other = "flash_decode" if paged else "flash_decode_paged"
        n = launches[name][kernel]
        check(n > 0, f"{kernel} never launched in the {name} run")
        check(n == cfg.num_layers * engine.decode_steps,
              f"{kernel}: {n} launches != {cfg.num_layers} x "
              f"{engine.decode_steps} decode steps")
        check(launches[name][other] == 0, f"{other} launched in the {name} run")
        check(launches[name]["flash_decode_combine"] == n,
              f"flash_decode_combine: {launches[name]['flash_decode_combine']} "
              f"launches != {n} {kernel} launches")

    agree = total = 0
    for r in reqs:
        a, b = results["paged"]["outputs"][r.rid], results["dense"]["outputs"][r.rid]
        agree += sum(x == y for x, y in zip(a, b))
        total += len(a)
    print(f"serve  greedy tokens where paged == dense: {agree}/{total} "
          f"= {agree / total:.4f}")

    dense_sync_check(model, params, scfg)
    trace_phase(model, params, scfg, reqs[:8])

    # the logits themselves: finite, of the expected shape
    cache = model.init_cache(8, 64)
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, values, _ = model.decode_step(params, cache, tok, 0)
    check(tuple(logits.shape) == (8, 1, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(values).all()),
          "full-width logits not finite")
    return {"paged": launches["paged"]["flash_decode_paged"],
            "dense": launches["dense"]["flash_decode"],
            "combine": {name: launches[name]["flash_decode_combine"]
                        for name in ("paged", "dense")}}


def dense_sync_check(model, params, scfg) -> None:
    """One dense engine prefill call and one decode call, rows in range,
    straddling the cache end and parked past it, under
    set_sync_debug_mode("error"): any device->host sync raises."""
    import torch

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, params, scfg, paged=False)
    dev = engine.device
    B, C, S = scfg.batch_rows, scfg.prefill_chunk, scfg.max_seq
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, C), generator=gen,
                           **i32)
    pos = torch.tensor([0, 5, 16, 40, S - 6, S, S, 100], **i32)[:B]
    lens = torch.full((B,), C, **i32)
    rids = torch.arange(1, B + 1, **i32)
    tok_idx = torch.zeros(B, **i32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = engine._prefill(tokens, pos, lens, None, rids, tok_idx)
        second = engine._decode(tokens[:, :1], pos, None, rids, tok_idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for out in (first, second):
        check(bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
              "dense step sampled a token out of range")
    print(f"sync   dense engine prefill ({B}, {C}) + decode ({B}, 1) calls, "
          f"rows at {pos.tolist()} of S={S}: no device sync "
          "(set_sync_debug_mode error)")


def trace_phase(model, params, scfg, reqs) -> None:
    """Where the time of the paged engine goes: host time of its prefill
    and decode calls (each ends in a device sync), then one run under
    torch.profiler for the device's busy share and its top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, params, scfg, paged=True)
    spent = {"_prefill": [], "_decode": []}
    for name in spent:
        fn = getattr(engine, name)

        def timed(*args, fn=fn, name=name):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t)
            return out

        setattr(engine, name, timed)
    res = engine.run(reqs)
    calls = {k: sum(v) for k, v in spent.items()}
    print(f"trace  paged engine, {len(reqs)} requests: {res['seconds']:.4f} s; "
          f"prefill {len(spent['_prefill'])} calls {calls['_prefill']:.4f} s "
          f"(mean {1e3 * calls['_prefill'] / len(spent['_prefill']):.3f} ms); "
          f"decode {len(spent['_decode'])} calls {calls['_decode']:.4f} s "
          f"(mean {1e3 * calls['_decode'] / len(spent['_decode']):.3f} ms); "
          f"rest {res['seconds'] - sum(calls.values()):.4f} s")

    engine = ServeEngine(model, params, scfg, paged=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # the combine kernel is launched as a programmatic dependent of the
    # split kernel, so its device time includes its wait for the split
    # kernel, whose time is counted already: busy leaves it out
    combine = sum(e.self_device_time_total for e in kernels
                  if "combine_kernel<" in e.key) / 1e6
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 - combine
    print(f"trace  profiled paged run: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s = {busy / wall:.4f} of wall (profiler on; without "
          f"the combine kernel's {combine:.4f} s, which overlaps the split "
          f"kernel)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"trace    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    for e in kernels:  # the decode kernels
        if any(n in e.key for n in ("paged_kernel<", "dense_kernel<",
                                    "combine_kernel<")):
            print(f"trace    decode {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]} "
                  f"({e.self_device_time_total / 1e6 / busy:.4f} of busy)")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"trace    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


# ------------------------------------------------------------ phase 5


def _sebulba(device):
    """The examples/sebulba_impala.py configuration on ``device``."""
    from repro_torch.launch.sebulba_impala import build

    return build(device=device)


def learner_phase(dev) -> None:
    """One learner update of the full-width net on the card (V-trace
    kernel) against the same update on the CPU (plain version), from the
    same params and trajectory, TF32 off.

    The gradients must agree leaf by leaf (1e-5 + 1e-4 * |g|: cuDNN sums
    the convolutions in another order than the CPU).  The update is
    RMSProp's first step, g / (sqrt(0.01 g^2) + 1e-8) * lr: ~10 * lr *
    sign(g) wherever |g| >> 1e-7, and where |g| is near 1e-8 it turns the
    gradient's last-bit differences into differences up to ~20 * lr.  So
    the updated params must agree within 1e-4 wherever |g| >= 1e-6 (the
    step is well conditioned there); the largest difference elsewhere is
    printed beside it."""
    import numpy as np
    import torch

    from repro_torch.data.trajectory import Trajectory
    from repro_torch.kernels.vtrace import vtrace as vt
    from repro_torch.tree import unflatten

    cpu = torch.device("cpu")
    on_card, on_cpu = _sebulba(dev), _sebulba("cpu")
    B, T = on_card.cfg.actor_batch_size, on_card.cfg.trajectory_length
    params = on_cpu.agent.init(torch.Generator().manual_seed(5), (16, 16, 1))
    rng = np.random.default_rng(6)
    obs = (rng.random((B, T + 1, 16, 16, 1)) > 0.95).astype(np.float32)
    traj = Trajectory(
        obs=torch.from_numpy(obs[:, :T]),
        actions=torch.from_numpy(rng.integers(0, 3, (B, T))),
        rewards=torch.from_numpy(
            rng.choice([-1.0, 0.0, 1.0], (B, T)).astype(np.float32)),
        discounts=torch.from_numpy(
            ((rng.random((B, T)) > 0.05) * 0.99).astype(np.float32)),
        behaviour_logp=torch.from_numpy(
            np.log(rng.uniform(0.2, 0.5, (B, T))).astype(np.float32)),
        bootstrap_obs=torch.from_numpy(obs[:, T]),
    )
    card_traj = Trajectory(*(x.to(dev) for x in traj[:6]))

    def grads(seb, p, t):
        live = [x.detach().requires_grad_() for x in _leaves(p)]
        loss, _ = seb.agent.loss(unflatten(p, live), t)
        return [g.to(cpu) for g in torch.autograd.grad(loss, live)]

    with full_f32():
        g_card = grads(on_card, _tree_to(params, dev), card_traj)
        g_cpu = grads(on_cpu, params, traj)
        card_params = _tree_to(params, dev)
        with torch.no_grad():
            before = vt.LAUNCHES["vtrace"]
            got, _, macc_card = on_card._update(
                card_params, on_card.opt.init(card_params), card_traj, None)
            launched = vt.LAUNCHES["vtrace"] - before
            want, _, macc_cpu = on_cpu._update(
                params, on_cpu.opt.init(params), traj, None)
    torch.cuda.synchronize()
    g_excess = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                   for a, b in zip(g_card, g_cpu))
    g_err = max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu))
    diffs = [(a.to(cpu) - b).abs() for a, b in zip(_leaves(got), _leaves(want))]
    well = [g.abs() >= 1e-6 for g in g_cpu]
    p_err = max(d[w].max().item() if w.any() else 0.0
                for d, w in zip(diffs, well))
    p_all = max(d.max().item() for d in diffs)
    below = sum(int((~w).sum()) for w in well)
    m_card, m_cpu = on_card._drain_macc(macc_card), on_cpu._drain_macc(macc_cpu)
    m_err = max(abs(m_card[k] - m_cpu[k]) for k in m_cpu)
    print(f"learner one update, full-width ConvActorCritic, B={B} T={T}, "
          f"card vs cpu, TF32 off: grads max_abs_err={g_err:.3e} "
          f"(tol 1e-5 + 1e-4*|g|); params max_abs_err={p_err:.3e} where "
          f"|g| >= 1e-6 (tol 1e-4), {p_all:.3e} over all "
          f"({below} of {sum(d.numel() for d in diffs)} elements have "
          f"|g| < 1e-6); metrics max_abs_err={m_err:.3e} (tol 1e-4); "
          f"vtrace launches={launched}")
    check(launched == 1, f"the card's update launched vtrace {launched}x")
    check(g_excess <= 1e-5, f"card and cpu gradients differ by {g_err}")
    check(p_err <= 1e-4, f"card and cpu learner updates differ by {p_err}")
    check(m_err <= 1e-4, f"card and cpu learner metrics differ by {m_err}")


# ------------------------------------------------------------ phase 6

SEBULBA_FRAMES = 200 * 32 * 20  # 200 trajectories of the example's shape


def sebulba_phase(dev) -> int:
    """Train the example's configuration on the card; returns the V-trace
    launches of the run."""
    import math

    import torch

    from repro_torch.api import RESULT_KEYS
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.vtrace import ref
    from repro_torch.kernels.vtrace import vtrace as vt

    plain_on_card = [0]
    plain = ref.vtrace_ref

    def counted(log_rhos, *args, **kw):  # ops.vtrace reaches it as ref.vtrace_ref
        plain_on_card[0] += log_rhos.is_cuda
        return plain(log_rhos, *args, **kw)

    warm = _sebulba(dev)  # first-call set-up (cuDNN, streams) stays out
    warm.fit(0, total_frames=4 * 32 * 20)
    seb = _sebulba(dev)
    gc.collect()  # what earlier phases left behind stays out of the peak
    ref.vtrace_ref = counted
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vt.reset_launches()
        fd.reset_launches()
        out = seb.fit(0, total_frames=SEBULBA_FRAMES, log_every=50)
        torch.cuda.synchronize()
        launches = vt.LAUNCHES["vtrace"]
        other = dict(fd.LAUNCHES)
    finally:
        ref.vtrace_ref = plain
    peak = torch.cuda.max_memory_allocated()
    cfg = seb.cfg
    print(f"sebulba {out['frames']:,} frames, {out['updates']} updates in "
          f"{out['seconds']:.4f} s: fps={out['fps']:.2f} "
          f"updates_per_s={out['updates'] / out['seconds']:.4f} "
          f"mean_return={out['mean_return']:.4f} "
          f"publishes_sent={out['publishes_sent']} "
          f"publishes_skipped={out['publishes_skipped']} "
          f"put_blocked={out['put_blocked']} "
          f"traj_dropped={out['traj_dropped']} "
          f"peak_mem={peak / 2**30:.4f} GiB (of which "
          f"{base / 2**30:.4f} GiB held before the run) "
          f"vtrace_launches={launches} "
          f"plain_vtrace_on_card={plain_on_card[0]}")
    print(f"sebulba metrics {json.dumps(out['metrics'])}")
    check(set(out) == set(RESULT_KEYS), "result keys differ from RESULT_KEYS")
    check(out["updates"] >= 100, f"only {out['updates']} learner updates")
    check(launches > 0, "vtrace never launched in the Sebulba run")
    check(launches == out["updates"] * cfg.learner_microbatches,
          f"vtrace launches {launches} != {out['updates']} updates x "
          f"{cfg.learner_microbatches} microbatches")
    check(plain_on_card[0] == 0, "the plain V-trace ran on the card")
    check(not any(other.values()), f"flash-decode launched: {other}")
    check(out["param_version"] == out["updates"] + 1, "param_version")
    check(all(math.isfinite(v) for v in out["metrics"].values())
          and len(out["metrics"]) == 5, f"metrics {out['metrics']}")
    check(all(bool(torch.isfinite(x).all()) for x in _leaves(out["params"])),
          "trained params not finite")
    check(all(x.device.type == "cuda" for x in _leaves(out["params"])),
          "params left the card")
    sebulba_trace(dev)
    return launches


def sebulba_trace(dev) -> None:
    """A profiled Sebulba run: the device's busy share and where the
    device and host time go."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seb = _sebulba(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = seb.fit(0, total_frames=40 * 32 * 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"trace  profiled Sebulba run: {out['updates']} updates, "
          f"{out['frames']:,} frames, wall {wall:.4f} s, device busy "
          f"{busy:.4f} s = {busy / wall:.4f} of wall (profiler on; kernel "
          "time summed over streams)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"trace    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"trace    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


# ------------------------------------------------------------ phase 7


def _learner_kernels(family: str) -> list:
    """(name, kernel module, plain module, plain function's name) of each
    kernel a learner step of the family launches: the forward's (flash
    attention for dense, the SSD scan for ssm, the RG-LRU scan for
    hybrid), then V-trace."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.vtrace import ref as vt_ref
    from repro_torch.kernels.vtrace import vtrace as vt

    first = {"dense": ("flash_attention", fa, fa_ref, "flash_attention_ref"),
             "ssm": ("ssd_scan", ssd, ssd_ref, "ssd_chunk_scan_ref"),
             "hybrid": ("rglru_scan", rg, rg_ref, "rglru_scan_ref")}[family]
    return [first, ("vtrace", vt, vt_ref, "vtrace_ref")]


def _reset_all_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.vtrace import vtrace as vt

    for mod in (fa, fd, rg, ssd, vt):
        mod.reset_launches()


def _all_launches() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.vtrace import vtrace as vt

    return {**fa.LAUNCHES, **fd.LAUNCHES, **rg.LAUNCHES, **ssd.LAUNCHES,
            **vt.LAUNCHES}


def _kernel_layers(cfg) -> int:
    """The layers whose forward launches the family's kernel: every layer,
    or the recurrent (R) layers of the hybrid family."""
    from repro_torch.models.transformer import layer_kinds

    if cfg.family == "hybrid":
        return layer_kinds(cfg).count("R")
    return cfg.num_layers


def train_parity(dev, arch: str, seq: int) -> None:
    """One LLM learner step of a reduced float32 model on the card (its
    kernels) against the same step on the CPU (plain versions), from the
    same params and batch, TF32 off.

    Metrics within 1e-4, gradients within 1e-5 + 1e-4 * |g| (sums in
    another order); Adam's first step is lr * g / (|g| + 1e-8), so the
    updated params must agree within 1e-5 where |g| >= 1e-6, and the
    largest difference elsewhere is printed beside it."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import steps
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import Model

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32")
    kernels = _learner_kernels(cfg.family)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(7), device=cpu)
    batch = make_batch(cfg, 2, seq, torch.Generator().manual_seed(8),
                       device=cpu)
    card_params, card_batch = _tree_to(params, dev), _tree_to(batch, dev)
    hp = steps.TrainHParams()
    grad_fn = steps.make_grad_fn(model, hp)
    opt = steps.make_optimizer(hp)
    step = steps.make_train_step(model, opt, hp)
    with full_f32():
        g_cpu, m_cpu = grad_fn(params, batch)
        _reset_all_launches()
        g_card, m_card = grad_fn(card_params, card_batch)
        torch.cuda.synchronize()
        launched = _all_launches()
        step(params, opt.init(params), batch)
        step(card_params, opt.init(card_params), card_batch)
        torch.cuda.synchronize()
    g_cpu, g_card = _leaves(g_cpu), [g.to(cpu) for g in _leaves(g_card)]
    g_err = max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu))
    g_excess = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                   for a, b in zip(g_card, g_cpu))
    m_err = max(abs(m_card[k].item() - m_cpu[k].item()) for k in m_cpu)
    diffs = [(a.to(cpu) - b).abs()
             for a, b in zip(_leaves(card_params), _leaves(params))]
    well = [g.abs() >= 1e-6 for g in g_cpu]
    p_err = max(d[w].max().item() if w.any() else 0.0
                for d, w in zip(diffs, well))
    p_all = max(d.max().item() for d in diffs)
    want = {name: 0 for name in launched}
    want[kernels[0][0]] = 2 * _kernel_layers(cfg)  # remat reruns each layer
    want["vtrace"] = 1
    print(f"train  one step, reduced {arch} f32 (B 2, T {seq}), card vs "
          f"cpu, TF32 off: metrics max_abs_err={m_err:.3e} (tol 1e-4) "
          f"grads max_abs_err={g_err:.3e} (tol 1e-5 + 1e-4*|g|) "
          f"params max_abs_err={p_err:.3e} where |g| >= 1e-6 (tol 1e-5), "
          f"{p_all:.3e} over all; launches "
          + " ".join(f"{k}={v}" for k, v in launched.items() if v))
    check(launched == want, f"card grad step launched {launched}, not {want}")
    check(m_err <= 1e-4, f"card and cpu loss metrics differ by {m_err}")
    check(g_excess <= 1e-5, f"card and cpu gradients differ by {g_err}")
    check(p_err <= 1e-5, f"card and cpu train steps differ by {p_err}")


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 2, 2048


def learner_run(dev, arch: str) -> tuple[dict, dict]:
    """``arch`` at full width for TRAIN_STEPS steps through
    launch/train.py, every kernel's launches counted over the run and
    every plain version's calls on CUDA tensors -> (train's result, the
    launches of the path's kernels)."""
    import math

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import train

    kernels = _learner_kernels(get_config(arch).family)
    plain_on_card = {name: 0 for name, *_ in kernels}
    saved = {name: getattr(mod, attr) for name, _, mod, attr in kernels}

    def counted(name):
        def fn(x, *args, **kw):  # ops reaches them as ref.<name>
            plain_on_card[name] += x.is_cuda
            return saved[name](x, *args, **kw)
        return fn

    gc.collect()
    torch.cuda.empty_cache()
    for name, _, mod, attr in kernels:
        setattr(mod, attr, counted(name))
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        out = train.train(arch, full=True, steps=TRAIN_STEPS,
                          batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev)
        torch.cuda.synchronize()
        launched = _all_launches()
        variants = dict(fa.VARIANT_LAUNCHES)
    finally:
        for name, _, mod, attr in kernels:
            setattr(mod, attr, saved[name])
    peak = torch.cuda.max_memory_allocated()
    cfg = out["cfg"]
    secs = out["step_seconds"]
    steady = statistics.median(secs[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want = {name: 0 for name in launched}
    layers = _kernel_layers(cfg)
    want[kernels[0][0]] = 2 * layers * cfg.microbatches * TRAIN_STEPS
    want["vtrace"] = TRAIN_STEPS
    if cfg.family == "ssm":
        width = (f"d_inner={cfg.d_inner} H={cfg.ssm_heads} "
                 f"P={cfg.ssm_head_dim} N={cfg.ssm_state} Q={cfg.ssm_chunk} "
                 f"conv={cfg.conv_width}")
    else:
        width = (f"H={cfg.num_heads}/K={cfg.num_kv_heads} h={cfg.head_dim} "
                 f"d_ff={cfg.d_ff}")
        if cfg.family == "hybrid":
            width += (f" pattern={cfg.layer_pattern} W={cfg.rnn_width} "
                      f"conv={cfg.rnn_conv_width} "
                      f"window={cfg.sliding_window}")
    print(f"train  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
          f"{width} V={cfg.vocab_size} {cfg.param_dtype} "
          f"remat={cfg.remat} microbatches={cfg.microbatches}: "
          f"{out['n_params']:,} params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}")
    print(f"train  step_ms={[round(1e3 * t, 3) for t in secs]} "
          f"steady_step_ms={1e3 * steady:.3f} (median of steps 1-"
          f"{TRAIN_STEPS - 1}) steady_tokens_per_s={tokens / steady:.2f} "
          f"tokens_per_s_all_steps={out['tokens_per_s']:.2f} "
          f"peak_mem={peak / 2**30:.3f} GiB (of which {base / 2**30:.3f} GiB "
          f"held before the run)")
    print(f"train  metrics {json.dumps(out['metrics'])}")
    print(f"train  launches {launched} (expected {kernels[0][0]} 2 x "
          f"{layers} layers x {cfg.microbatches} microbatches x "
          f"{TRAIN_STEPS} steps = {want[kernels[0][0]]}, vtrace "
          f"{TRAIN_STEPS}, no other kernel) plain versions on the card "
          f"{plain_on_card}")
    check(all(math.isfinite(v) for m in out["metrics"] for v in m.values()),
          "non-finite training metrics")
    # random init: the first step's cross-entropy is that of a near-uniform
    # prediction over the vocabulary.  Not for gemma models: their tied
    # embedding, scaled by sqrt(d) on the way in, makes the untrained model
    # predict its own input token (policy entropy ~1 nat at full width), so
    # Gibbs' inequality gives the lower bound (the mean -log p of uniformly
    # drawn targets is at least log(V)); the upper bound 17.0 sits above
    # the 16.07 that recurrentgemma-2b's first step gave on an H100 in
    # every full-width run of this script, so a loss that blows up fails
    ce0 = out["metrics"][0]["ce"]
    log_v = math.log(cfg.vocab_size)
    if "gemma" in cfg.name:
        check(log_v - 0.5 < ce0 < 17.0,
              f"first-step ce {ce0} outside (log(V) - 0.5 = {log_v - 0.5}, "
              "17.0)")
    else:
        check(abs(ce0 - log_v) < 0.5,
              f"first-step ce {ce0} far from log(V) = {log_v}")
    # every flash-attention launch goes to the variant the rule picks for
    # the model's dtype and head_dim (v2 for qwen2-1.5b's bf16 h 128)
    want_variants = {"v1": 0, "v2": 0}
    want_variants[fa.variant(getattr(torch, cfg.param_dtype),
                             cfg.head_dim)] = want["flash_attention"]
    print(f"train  flash-attention launches by variant {variants} "
          f"(expected {want_variants})")
    check(launched == want, f"launches {launched} != {want}")
    check(variants == want_variants,
          f"flash-attention variants {variants} != {want_variants}")
    check(not any(plain_on_card.values()),
          f"a plain version ran on the card: {plain_on_card}")
    check(all(bool(torch.isfinite(x).all()) for x in _leaves(out["params"])),
          "trained params not finite")
    return out, {**{name: launched[name] for name, *_ in kernels},
                 "flash_attention_variants": variants}


def trace_step(dev, out, kinds: dict, ops: tuple, every: tuple = ()) -> None:
    """One profiled train step: the device's busy share, device time by
    kind of kernel (a kind's names are matched as substrings of the
    profiler's kernel names), the device time of the kernels launched
    under each of ``ops`` (autograd functions, forward and backward), and
    the top kernels and host ops.  Fails if a kind was never seen, or a
    name in ``every`` matched no kernel, so a line cannot read 0
    unnoticed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    batch = train.batch_for_step(out["cfg"], TRAIN_STEPS, TRAIN_BATCH,
                                 TRAIN_SEQ, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = out["step"](out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"trace  profiled train step: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s = {busy / wall:.4f} of wall (profiler on), loss "
          f"{m['loss'].item():.4f}")
    given = list(kinds)
    kinds = {**kinds, "GEMM": ("gemm", "nvjet", "xmma")}
    spent = {name: [0.0, 0] for name in kinds}
    for e in kernels:
        for name, keys in kinds.items():
            if any(k in e.key for k in keys):
                spent[name][0] += e.self_device_time_total / 1e3
                spent[name][1] += e.count
                break
    rest = busy * 1e3 - sum(ms for ms, _ in spent.values())
    print("trace  device ms by kind: " + ", ".join(
        f"{name} {ms:.3f} ({n}x)" for name, (ms, n) in spent.items())
        + f", other {rest:.3f}")
    for name in every:
        ms = sum(e.self_device_time_total for e in kernels
                 if name in e.key) / 1e3
        n = sum(e.count for e in kernels if name in e.key)
        print(f"trace    {name}: {ms:.3f} ms ({n}x)")
        check(n > 0, f"no {name} launch in the profiled step")
    for name in given:
        check(spent[name][1] > 0, f"no {name} launch in the profiled step")
    for e in events:  # the device time of kernels launched under each op
        if e.key in ops:
            print(f"trace  {e.key}: {e.count}x, device "
                  f"{e.device_time_total / 1e3:.3f} ms in kernels launched "
                  f"under it = {e.device_time_total / 1e6 / busy:.4f} of "
                  "the device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"trace    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"trace    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def train_phase(dev) -> dict:
    """qwen2-1.5b: the reduced step card vs CPU, then full width for
    TRAIN_STEPS steps and one profiled step; returns the launches."""
    train_parity(dev, "qwen2-1.5b", 100)
    out, launches = learner_run(dev, "qwen2-1.5b")
    trace_step(dev, out, {"flash_attention kernel": ("flash_fwd_kernel",
                                                     "flash_fwd_v2_kernel"),
                          "vtrace kernel": ("vtrace_kernel",)},
               ("_FlashAttention", "_FlashAttentionBackward"))
    return launches


def mamba2_phase(dev) -> dict:
    """mamba2-1.3b: the reduced step card vs CPU (T 128: 4 chunks of 32),
    then full width for TRAIN_STEPS steps, one full-width prefill call
    (the inference forward) with the kernel held against its plain
    version on the first layer's own inputs, and one profiled step;
    returns the launches by path."""
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.launch import steps, train
    from repro_torch.models import Model

    train_parity(dev, "mamba2-1.3b", 128)
    out, launches = learner_run(dev, "mamba2-1.3b")
    cfg = out["cfg"]

    prefill = steps.make_prefill_step(Model(cfg))
    batch = train.batch_for_step(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                                 dev)
    first = []
    kernel = ssd_ops.ssd_scan_cuda

    def keep_first(*args, **kw):  # ops reaches it as ssd_scan_cuda
        if not first:
            first.append((args, kw))
        return kernel(*args, **kw)

    ssd_ops.ssd_scan_cuda = keep_first
    try:
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        logits, values = prefill(out["params"], batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = _all_launches()
    finally:
        ssd_ops.ssd_scan_cuda = kernel
    want = {name: 0 for name in launched}
    want["ssd_scan"] = cfg.num_layers
    print(f"prefill {cfg.name} make_prefill_step, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}: {1e3 * secs:.3f} ms (v1 {SSD_V1_PREFILL_MS} ms "
          f"recorded), logits {tuple(logits.shape)} "
          f"values {tuple(values.shape)}, launches {launched} (expected "
          f"ssd_scan {cfg.num_layers}, one a layer)")
    check(tuple(logits.shape) == (TRAIN_BATCH, cfg.vocab_size)
          and tuple(values.shape) == (TRAIN_BATCH,), "prefill shapes")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(values).all()),
          "prefill outputs not finite")
    check(launched == want, f"prefill launches {launched} != {want}")
    (xs, kw), = first
    got = ssd.ssd_scan_cuda(*xs, **kw)
    ssd_check(got, xs, kw["chunk"], f"prefill, layer 0's own inputs "
              f"({xs[0].dtype}, x {tuple(xs[0].shape)} strides "
              f"{xs[0].stride()})")
    del first, xs, got, logits, values

    trace_step(dev, out, {"ssd_scan kernels": SSD_KERNELS,
                          "vtrace kernel": ("vtrace_kernel",)},
               ("_SSDChunkScan", "_SSDChunkScanBackward"), every=SSD_KERNELS)
    return {"ssd_scan": {"mamba2_train": launches["ssd_scan"],
                         "mamba2_prefill": launched["ssd_scan"]},
            "vtrace": {"mamba2_train": launches["vtrace"]}}


def griffin_phase(dev) -> dict:
    """recurrentgemma-2b: the reduced step card vs CPU (T 128 over a
    window of 64), then full width for TRAIN_STEPS steps and one profiled
    step; then one layer's windowed attention timed alone at the training
    shape;
    returns the launches by path."""
    import torch

    from repro_torch.models import attention as attn

    train_parity(dev, "recurrentgemma-2b", 128)
    out, launches = learner_run(dev, "recurrentgemma-2b")
    cfg = out["cfg"]

    trace_step(dev, out, {"rglru_scan kernel": ("rglru_kernel",),
                          "vtrace kernel": ("vtrace_kernel",)},
               ("_RGLRUScan", "_RGLRUScanBackward"))
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # one layer's windowed attention at the training shape: the forward
    # runs 3 times a layer a step (the layer's forward, its remat rerun,
    # the attention checkpoint's rerun) and the backward once
    B, T, H, K, h = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
               .requires_grad_() for s in ((B, T, H, h), (B, T, K, h),
                                           (B, T, K, h)))
    do = torch.randn((B, T, H, h), generator=gen, device=dev).bfloat16()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def fwd():
        with torch.no_grad():
            attn.sliding_window_attention(q, k, v, window=cfg.sliding_window)

    def fwd_bwd():
        attn.sliding_window_attention(
            q, k, v, window=cfg.sliding_window).backward(do)

    fwd_ms = time_ms(fwd, flush)
    both_ms = time_ms(fwd_bwd, flush)
    n_attn = cfg.num_layers - _kernel_layers(cfg)
    print(f"swa    sliding_window_attention B={B} T={T} H={H} K={K} h={h} "
          f"window={cfg.sliding_window} bf16: forward {fwd_ms:.4f} ms, "
          f"forward+backward {both_ms:.4f} ms; a step's {n_attn} windowed "
          f"layers x (3 forwards + 1 backward) = "
          f"{n_attn * (2 * fwd_ms + both_ms):.3f} ms")
    return {"rglru_scan": {"griffin_train": launches["rglru_scan"]},
            "vtrace": {"griffin_train": launches["vtrace"]}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        print(f"phase  {name}: {time.monotonic() - t0:.1f} s")
        return out

    timed("build", build_phase)
    records = timed("kernels (flash decode)", kernel_phase, dev)
    records.update(timed("kernels (V-trace)", vtrace_phase, dev))
    records.update(timed("kernels (flash attention)", flash_attention_phase,
                         dev))
    records.update(timed("kernels (SSD scan)", ssd_scan_phase, dev))
    records.update(timed("kernels (RG-LRU scan)", rglru_scan_phase, dev))
    with full_f32():
        timed("model", model_phase, dev)
    launches = timed("serve", serve_phase, dev)
    timed("learner", learner_phase, dev)
    by_path = {
        "flash_decode": {"dense_serve": launches["dense"]},
        "flash_decode_paged": {"paged_serve": launches["paged"]},
        "vtrace": {"sebulba": timed("sebulba", sebulba_phase, dev)},
    }
    trained = timed("train", train_phase, dev)
    by_path["vtrace"]["train"] = trained["vtrace"]
    by_path["flash_attention"] = {"train": trained["flash_attention"]}
    mamba = timed("mamba2", mamba2_phase, dev)
    by_path["vtrace"].update(mamba["vtrace"])
    by_path["ssd_scan"] = mamba["ssd_scan"]
    griffin = timed("griffin", griffin_phase, dev)
    by_path["vtrace"].update(griffin["vtrace"])
    by_path["rglru_scan"] = griffin["rglru_scan"]

    kernels = []
    for name, source, replaces in (
        ("flash_decode", "src/repro_torch/kernels/flash_decode/flash_decode.cu",
         "src/repro/kernels/flash_decode/flash_decode.py:103"),
        ("flash_decode_paged",
         "src/repro_torch/kernels/flash_decode/flash_decode.cu",
         "src/repro/kernels/flash_decode/flash_decode.py:157"),
        ("vtrace", "src/repro_torch/kernels/vtrace/vtrace.cu",
         "src/repro/kernels/vtrace/vtrace.py:60"),
        ("flash_attention",
         "src/repro_torch/kernels/flash_attention/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:91"),
        ("ssd_scan", "src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
         "src/repro/kernels/ssd_scan/ssd_scan.py:77"),
        ("rglru_scan", "src/repro_torch/kernels/rglru_scan/rglru_scan.cu",
         "src/repro/kernels/rglru_scan/rglru_scan.py:50"),
    ):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name], **records[name]})
        if name == "flash_attention":
            kernels[-1]["launches_by_variant"] = trained[
                "flash_attention_variants"]
        if name.startswith("flash_decode"):  # each call: split + combine
            kernels[-1]["combine_launches"] = launches["combine"][
                "paged" if name.endswith("paged") else "dense"]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
