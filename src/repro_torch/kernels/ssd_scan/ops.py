"""The Mamba-2 SSD scan with its gradient: the port of ``ssd_scan`` and the
custom-VJP chunk scan ``_ssd_chunk_scan`` of
``repro/kernels/ssd_scan/ops.py``.

The forward goes by tensor device: a CUDA ``x`` goes to the Hopper kernel
(which raises on what it does not take), a CPU ``x`` to the plain
``ref.ssd_chunk_scan_ref``.  There is no other route: nothing falls back
from the kernel to the plain version.  Both return the state entering each
chunk, which the forward saves beside the inputs, as ``_ssd_vjp_fwd``
does.

The backward is ``_ssd_vjp_bwd`` line for line, in plain PyTorch (the
reference's is jnp too): a reverse loop over the chunks, each re-running
ONE chunk's ``ssd_one_chunk`` from its saved incoming state and taking its
VJP, so live memory is one chunk's (B, Q, Q, H) intermediates plus the
(nc, B, H, P, N) states.  Its ``ssd_one_chunk`` masks before the
exponential (``ref.py``), so its gradients stay finite where the
reference's are NaN (a 256-step chunk at the model's own dt and A).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda


def _inner_dense(t: torch.Tensor, inner: int) -> torch.Tensor:
    """``t`` if its last ``inner`` elements of a row are dense (the kernel
    reads rows in place through their strides), else a contiguous copy."""
    want = 1
    for d in range(t.ndim - 1, t.ndim - 1 - inner, -1):
        if t.shape[d] > 1 and t.stride(d) != want:
            return t.contiguous()
        want *= t.shape[d]
    return t


def ssd_chunk_scan(x, dt, A, Bm, Cm, chunk: int):
    """-> (y, S_final, S_prevs): the kernel for CUDA tensors, the plain
    chunk scan for CPU tensors."""
    if x.device.type == "cuda":
        return ssd_scan_cuda(_inner_dense(x, 2), dt.float().contiguous(),
                             A.float().contiguous(), _inner_dense(Bm, 1),
                             _inner_dense(Cm, 1), chunk=chunk)
    if x.device.type != "cpu":
        raise ValueError(f"the SSD scan runs on cuda or cpu, not {x.device}")
    return ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, S_prevs, dy, dS_final):
    """``_ssd_vjp_bwd``: the cotangents of (x, dt, A, Bm, Cm), each in its
    input's dtype, from those of (y, S_final)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = S_prevs.shape[0]
    Q = T // nc
    xc, dtc, Bc, Cc = ref.chunks(x, dt, Bm, Cm, nc)
    Af = A.float()
    dyc = dy.float().reshape(Bsz, nc, Q, H, P)
    dS = dS_final.float()
    dA = torch.zeros_like(Af)
    dxs, ddts, dBs, dCs = [], [], [], []
    for c in reversed(range(nc)):
        leaves = [t.detach().requires_grad_() for t in
                  (S_prevs[c], xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], Af)]
        with torch.enable_grad():
            y_c, S_new = ref.ssd_one_chunk(*leaves)
            dS, dxi, ddi, dbi, dci, dAi = torch.autograd.grad(
                (y_c, S_new), leaves, (dyc[:, c], dS))
        dA = dA + dAi
        dxs.append(dxi)
        ddts.append(ddi)
        dBs.append(dbi)
        dCs.append(dci)

    def whole(parts, shape, dtype):
        return torch.stack(parts[::-1], dim=1).reshape(shape).to(dtype)

    return (whole(dxs, (Bsz, T, H, P), x.dtype),
            whole(ddts, (Bsz, T, H), dt.dtype), dA.to(A.dtype),
            whole(dBs, (Bsz, T, N), Bm.dtype),
            whole(dCs, (Bsz, T, N), Cm.dtype))


class _SSDChunkScan(torch.autograd.Function):
    """The reference's ``_ssd_chunk_scan``: the forward saves
    (x, dt, A, Bm, Cm, S_prevs) as ``_ssd_vjp_fwd`` does; the backward is
    ``ssd_chunk_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, S_final, S_prevs = ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, S_prevs)
        return y, S_final

    @staticmethod
    def backward(ctx, dy, dS_final):
        return (*ssd_chunk_scan_bwd(*ctx.saved_tensors, dy, dS_final), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: torch.Tensor | None = None, *, chunk: int = 256):
    """Chunked SSD scan from a zero state -> (y (B, T, H, P) in x's
    dtype, S_final (B, H, P, N) float32); shapes as in ``ref.py``.  T must
    divide into chunks of min(chunk, T) steps."""
    if init_state is not None:
        raise NotImplementedError(
            "init_state: the SSD kernel starts from a zero state, as the "
            "Pallas kernel does; a carried state is ROADMAP Queue 1 #10c")
    T = x.shape[1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"seq len {T} not divisible by chunk {Q}")
    return _SSDChunkScan.apply(x, dt, A, Bm, Cm, Q)
