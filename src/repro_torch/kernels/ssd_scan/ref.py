"""Plain PyTorch versions of the Mamba-2 SSD scan: the port of
``repro/kernels/ssd_scan/ref.py`` (``ssd_scan_ref``, the sequential
recurrence) and of the chunk scan of ``repro/kernels/ssd_scan/ops.py``
(``ssd_one_chunk`` = ``_ssd_one_chunk``, ``ssd_chunk_scan_ref`` =
``_ssd_chunk_scan_fwd_impl``).

Per batch row b and head h, with state S in R^{P x N}:

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (x_t outer B_t)
    y_t = S_t @ C_t

Shapes: x (B, T, H, P), dt (B, T, H) positive (after the softplus),
A (H,) negative, Bm and Cm (B, T, N), one group shared by the heads.
Every input is upcast to float32; y comes back in x's dtype and the states
in float32.

``ssd_one_chunk`` masks the intra-chunk decay BEFORE the exponential,
``exp(where(s <= t, cum_t - cum_s, -inf))``, where the reference takes
``where(s <= t, exp(cum_t - cum_s), 0)``.  Both give the same values, since
a masked pair adds exactly zero either way; but for s > t the delta is
positive and reaches ~250 inside a 256-step chunk at the model's own
values, so the reference's exp overflows to inf and its VJP multiplies the
zero cotangent by inf: NaN gradients for dt and A (ROADMAP Queue 3).  The
masked form has a zero derivative there.  The chunk's cumulative decay is
summed in float64 and rounded to float32 once, so the plain version gives
the same values on the CPU and on the card.  ``ssd_chunk_scan_ref`` is what
the Hopper kernel computes and what it is held against on the card.

``ssd_staged_ref`` is the same scan cut into the Hopper kernel's stages
(the head-free scores once per (row, chunk), every chunk's own state from
a zero state, the state pass, then y), for the tests and ``chip_smoke.py``;
the port's forward does not call it.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor):
    """The sequential oracle from a zero state, one time step at a time ->
    (y (B, T, H, P) in x's dtype, S (B, H, P, N) float32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * Af)  # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        S = S * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_one_chunk(S_prev: torch.Tensor, xc: torch.Tensor, dtc: torch.Tensor,
                  Bc: torch.Tensor, Cc: torch.Tensor, A: torch.Tensor):
    """One chunk of the SSD duality, all float32.  S_prev (B, H, P, N);
    xc (B, Q, H, P); dtc (B, Q, H); Bc, Cc (B, Q, N); A (H,) ->
    (y_c (B, Q, H, P), S_new (B, H, P, N))."""
    logdec = dtc * A  # (B, Q, H)
    # summed in float64 and rounded once: what torch.cumsum does for float32
    # on the CPU, and what the kernel does; CUDA's float32 cumsum sums in
    # float32 and is off by ~4e-4 at |cum| ~ 250
    cum = torch.cumsum(logdec, dim=1, dtype=torch.float64).float()
    Q = xc.shape[1]
    scores = torch.einsum("bqn,bsn->bqs", Cc, Bc)
    delta = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q(t), Q(s), H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(causal[None, :, :, None], delta,
                                  -torch.inf))
    attn = scores[..., None] * decay  # (B, Q, S, H)
    dx = xc * dtc[..., None]
    y_intra = torch.einsum("bqsh,bshp->bqhp", attn, dx)
    y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", Cc, torch.exp(cum), S_prev)
    tail = torch.exp(cum[:, -1:, :] - cum)
    S_new = S_prev * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
        "bqh,bqhp,bqn->bhpn", tail, dx, Bc)
    return y_intra + y_inter, S_new


def chunks(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, nc: int):
    """The float32 per-chunk views (B, nc, Q, ...) of the scan's inputs."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = T // nc
    return (x.float().reshape(Bsz, nc, Q, H, P),
            dt.float().reshape(Bsz, nc, Q, H),
            Bm.float().reshape(Bsz, nc, Q, N),
            Cm.float().reshape(Bsz, nc, Q, N))


def ssd_chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """The chunk scan from a zero state over chunks of Q = min(chunk, T)
    steps -> (y (B, T, H, P) in x's dtype, S_final (B, H, P, N) float32,
    S_prevs (nc, B, H, P, N) float32, the state entering each chunk)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"seq len {T} not divisible by chunk {Q}")
    nc = T // Q
    xc, dtc, Bc, Cc = chunks(x, dt, Bm, Cm, nc)
    Af = A.float()
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys, S_prevs = [], []
    for c in range(nc):
        S_prevs.append(S)
        y, S = ssd_one_chunk(S, xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], Af)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, T, H, P).to(x.dtype)
    return y, S, torch.stack(S_prevs)


def ssd_staged_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """``ssd_chunk_scan_ref`` in the stages of ``ssd_scan.cu`` -> (y, S_final,
    S_prevs), shapes and dtypes as there:

    1. cum per (row, chunk, head), summed in float64 and rounded once;
    2. G = C B^T once per (row, chunk), shared by the heads;
    3. each chunk's own state from a zero state,
       S_c = sum_s exp(cum_{Q-1} - cum_s) (x_s dt_s) (x) B_s;
    4. the state pass S_prev[c + 1] = exp(cum_{Q-1}[c]) S_prev[c] + S_c[c];
    5. y = (G exp(cum_t - cum_s), masked before the exponential) (x_s dt_s)
       + exp(cum_t) C_t . S_prev[c].

    Each term is rounded as in ``ssd_one_chunk``; the sums run per stage."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"seq len {T} not divisible by chunk {Q}")
    nc = T // Q
    xc, dtc, Bc, Cc = chunks(x, dt, Bm, Cm, nc)  # (B, nc, Q, ...)
    cum = torch.cumsum(dtc * A.float(), dim=2, dtype=torch.float64).float()
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    last = cum[:, :, -1]  # (B, nc, H)
    dx = xc * dtc[..., None]
    tail = torch.exp(last[:, :, None] - cum)
    S_c = torch.einsum("bcsh,bcshp,bcsn->cbhpn", tail, dx, Bc)
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * torch.exp(last[:, c])[..., None, None] + S_c[c]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):  # one chunk at a time: (B, Q, Q, H) is live
        delta = cum[:, c, :, None, :] - cum[:, c, None, :, :]
        decay = torch.exp(torch.where(causal[None, :, :, None], delta,
                                      -torch.inf))
        y_intra = torch.einsum("btsh,bshp->bthp", G[:, c, ..., None] * decay,
                               dx[:, c])
        y_inter = torch.einsum("btn,bth,bhpn->bthp", Cc[:, c],
                               torch.exp(cum[:, c]), S_prevs[c])
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, T, H, P).to(x.dtype)
    return y, S, torch.stack(S_prevs)
