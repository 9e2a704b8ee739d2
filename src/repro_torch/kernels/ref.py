"""Plain PyTorch versions of the port's kernels — the definitions of
correctness.

Each function is the obvious, untiled formulation of what its kernel
computes, on the same operand layout.  The kernel wrappers run them for
tensors that lie on the CPU (the tests), and ``chip_smoke.py`` holds every
CUDA kernel against them on the card.  They mirror the JAX package's
``kernels/ref.py`` oracles line for line.
"""
from __future__ import annotations

import torch


def spmm_csr_ref(indptr: torch.Tensor, indices: torch.Tensor,
                 values: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """CSR SpMM: ``out[r] = Σ values[e]·h[indices[e]]`` over row r's
    nonzeros, an ``index_select`` gather and an ``index_add_`` (on the CPU
    it adds the nonzeros in their order).

    indptr: (N+1,) int; indices, values: (nnz,); h: (N, D).  Returns (N, D)
    float32.
    """
    n = indptr.numel() - 1
    deg = indptr[1:].long() - indptr[:-1].long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=h.device), deg, output_size=indices.numel())
    gathered = h.float().index_select(0, indices.long())
    out = torch.zeros((n, h.shape[1]), dtype=torch.float32, device=h.device)
    return out.index_add_(0, rows, values.float()[:, None] * gathered)


def pack_slabs_ref(h: torch.Tensor, width: int, slabs: int) -> torch.Tensor:
    """H (N, D) as ``slabs`` column slabs of ``width``, slab-major:
    ``out[s, r, c] = h[r, s·width + c]``, zeros past D.  Returns
    (slabs, N, width)."""
    n, d = h.shape
    padded = h.new_zeros((n, slabs * width))
    padded[:, :d] = h
    return padded.view(n, slabs, width).transpose(0, 1).contiguous()


def spmm_bcsr_ref(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """BCSR reference: the TPU kernel's tile layout, contracted naively.

    tile_cols: (n_row_blocks, max_tiles) int32 — column-block index per tile
               (padding tiles point at block 0 with all-zero values).
    tile_vals: (n_row_blocks, max_tiles, BM, BN) float — dense tile contents.
    h:         (n_col_blocks * BN, D).
    Returns (n_row_blocks * BM, D) float32.
    """
    n_rb, max_t, bm, bn = tile_vals.shape
    d = h.shape[-1]
    h_blocks = h.float().reshape(-1, bn, d)
    gathered = h_blocks[tile_cols.long()]             # (n_rb, max_t, BN, D)
    out = torch.einsum("rkmn,rknd->rmd", tile_vals.float(), gathered)
    return out.reshape(n_rb * bm, d)


def edge_softmax_alpha(scores: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax weights ``α (N, F)`` in f32; all-masked rows are 0.

    Masked slots score −1e30 and the denominator is clamped at 1e-30, as in
    the JAX package's Pallas kernel.
    """
    m = mask.float()
    s = torch.where(m > 0, scores.float(), torch.full_like(m, -1e30))
    s = s - s.max(dim=-1, keepdim=True).values
    e = torch.exp(s) * m
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def edge_softmax_ref(scores: torch.Tensor, mask: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_f softmax_f(scores[n])·vals[n,f] with masked slots.

    scores: (N, F); mask: (N, F) {0,1}; vals: (N, F, D).  Returns (N, D)
    float32; rows with zero mask produce zeros.
    """
    alpha = edge_softmax_alpha(scores, mask)
    return torch.einsum("nf,nfd->nd", alpha, vals.float())


def quantize_int8_rows_ref(x: torch.Tensor, u: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire format of the compressed communication layer.

    Each row of ``x (R, C)`` is scaled by ``scale[r] = max(|x[r]|, eps)/127``
    and rounded to int8 as ``clip(floor(x/scale + u), -127, 127)``.  With
    ``u ~ U[0,1)`` this is *stochastic* rounding — the dequantized estimate
    ``q·scale`` is unbiased, the property error-feedback averaging relies
    on.  ``u=None`` means a constant 0.5, i.e. deterministic round-half-up
    (used for halo feature compression, which needs no unbiasedness).
    Returns ``(q int8 (R, C), scale float32 (R, 1))``.
    """
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, never by a Python number: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, which is not the
    # correctly rounded quotient the CUDA kernel computes
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    uu = torch.full_like(x, 0.5) if u is None else u.float()
    q = torch.clamp(torch.floor(x / scale + uu), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_int8_rows_ref(q: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows_ref`: ``q·scale`` as float32."""
    return q.float() * scale.float()


def linear_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, h0: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle for the gated linear recurrence.

      h_t = diag(w_t) h_{t-1} + k_t v_tᵀ          (h ∈ R^{dk×dv})
      y_t = h_tᵀ q_t                               (y ∈ R^{dv})

    q,k,log_w: (T, dk); v: (T, dv); w_t = exp(log_w_t) ∈ (0,1].
    Returns (y (T,dv), h_T (dk,dv)) in float32.
    """
    y, h = linear_scan_batched_ref(q[None], k[None], v[None], log_w[None],
                                   None if h0 is None else h0[None])
    return y[0], h[0]


def linear_scan_batched_ref(q, k, v, log_w, h0=None):
    """:func:`linear_scan_ref` over a leading (batch·heads) axis: one step
    at a time, every batch·head at once."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    q, k, v, w = q.float(), k.float(), v.float(), log_w.float().exp()
    h = (torch.zeros(bh, dk, dv, dtype=torch.float32, device=q.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(t):
        h = w[:, i, :, None] * h + k[:, i, :, None] * v[:, i, None, :]
        ys.append(torch.einsum("bdv,bd->bv", h, q[:, i]))
    return torch.stack(ys, dim=1), h


def chunked_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, h0: torch.Tensor | None = None,
                     chunk: int = 64, strict: bool = False,
                     u: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked form of the recurrence, one chunk of L steps at a time —
    the math of the JAX package's ``scan_common.chunked_scan`` and of the
    Pallas kernel ``linear_scan_chunked``, as a loop over chunks.

    Within a chunk, with ``P_t = exp(Σ_{s≤t} log_w_s)``::

      A[t,s]     = (q_t ⊙ P_t)·(k_s ⊘ P_s) for s ≤ t (s < t when strict)
      y          = A V + (Q ⊙ P) h_in
      h_out      = diag(P_L) h_in + (K ⊘ P ⊙ P_L)ᵀ V

    ``strict`` (RWKV6): the query reads ``h_{t−1}`` (decay ``P_{t−1}``) and
    the current token enters only through the bonus ``(q_t·(u⊙k_t)) v_t``.
    ``T % chunk == 0``: :func:`repro_torch.kernels.linear_scan.
    linear_scan_chunked` pads a ragged T before it comes here.

    q,k,log_w: (BH, T, dk); v: (BH, T, dv); h0: (BH, dk, dv) or None;
    u: (BH, dk) or None.  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32).
    """
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    q, k, v, lw = (x.float() for x in (q, k, v, log_w))
    h = (torch.zeros(bh, dk, dv, dtype=torch.float32, device=q.device)
         if h0 is None else h0.float())
    idx = torch.arange(chunk, device=q.device)
    mask = (idx[:, None] > idx[None, :]) if strict else \
        (idx[:, None] >= idx[None, :])
    ys = []
    for c0 in range(0, t, chunk):
        qx, kx, vx, lwx = (x[:, c0:c0 + chunk] for x in (q, k, v, lw))
        lw_cum = torch.cumsum(lwx, dim=1)           # log P_t  (BH, L, dk)
        p = torch.exp(lw_cum)
        qp = qx * (torch.exp(lw_cum - lwx) if strict else p)
        kp = kx * torch.exp(-lw_cum)
        attn = torch.einsum("btd,bsd->bts", qp, kp)
        attn = torch.where(mask, attn, torch.zeros_like(attn))
        y = torch.einsum("bts,bsd->btd", attn, vx)
        ys.append(y + torch.einsum("btd,bdv->btv", qp, h))
        p_last = p[:, -1]                           # (BH, dk)
        h = p_last[:, :, None] * h + torch.einsum(
            "bsd,bsv->bdv", kp * p_last[:, None, :], vx)
    y = torch.cat(ys, dim=1)
    if strict and u is not None:
        bonus = torch.einsum("btd,btd->bt", q, u.float()[:, None, :] * k)
        y = y + bonus[..., None] * v
    return y, h


def chunked_scan_scalar_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, log_w: torch.Tensor,
                            h0: torch.Tensor | None = None, chunk: int = 64
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain-convention recurrence for a decay that is one value per
    step and head (Mamba2's), in the chunked segsum form of Mamba2's SSD:
    within a chunk of L steps, with ``c_t = Σ_{s≤t} log_w_s``::

      A[t,s]     = (q_t·k_s)·exp(c_t − c_s)   for s ≤ t
      y          = A V + exp(c_t)·(Q h_in)
      h_out      = exp(c_L)·h_in + Σ_s exp(c_L − c_s) k_s v_sᵀ

    The same recurrence as :func:`chunked_scan_ref` with ``log_w``
    broadcast over dk, but for ``log_w ≤ 0`` every exponent is ≤ 0, so it
    stays finite where the factored form's ``exp(−c)`` overflows (a
    chunk's summed |log_w| past ~88.7).  ``T % chunk == 0``, as in
    :func:`chunked_scan_ref`.

    q,k: (BH, T, dk); v: (BH, T, dv); log_w: (BH, T); h0: (BH, dk, dv) or
    None.  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32).
    """
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    q, k, v, lw = (x.float() for x in (q, k, v, log_w))
    h = (torch.zeros(bh, dk, dv, dtype=torch.float32, device=q.device)
         if h0 is None else h0.float())
    idx = torch.arange(chunk, device=q.device)
    mask = idx[:, None] >= idx[None, :]
    ys = []
    for c0 in range(0, t, chunk):
        qx, kx, vx = (x[:, c0:c0 + chunk] for x in (q, k, v))
        c = torch.cumsum(lw[:, c0:c0 + chunk], dim=1)          # (BH, L)
        seg = (c[:, :, None] - c[:, None, :]).masked_fill(~mask, -torch.inf)
        attn = torch.einsum("btd,bsd->bts", qx, kx) * torch.exp(seg)
        y = torch.einsum("bts,bsv->btv", attn, vx)
        ys.append(y + torch.exp(c)[:, :, None] *
                  torch.einsum("btd,bdv->btv", qx, h))
        c_l = c[:, -1:]                                        # (BH, 1)
        h = torch.exp(c_l)[:, :, None] * h + torch.einsum(
            "bsd,bsv->bdv", kx * torch.exp(c_l - c)[:, :, None], vx)
    return torch.cat(ys, dim=1), h


def linear_scan_vjp_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor, h0: torch.Tensor | None,
                        u: torch.Tensor | None, dy: torch.Tensor,
                        dh_t: torch.Tensor | None, chunk: int = 64,
                        strict: bool = False
                        ) -> tuple[torch.Tensor | None, ...]:
    """The scan's gradient as torch autograd of :func:`chunked_scan_ref`
    (``log_w`` (BH, T, dk)) or :func:`chunked_scan_scalar_ref` (``log_w``
    (BH, T)) — the plain version of ``csrc/linear_scan_bwd.cu``.

    A ragged T is zero-padded as the forward's wrapper pads it (the
    padding gets no gradient).  ``dy`` (BH, T, dv) and ``dh_t`` (BH, dk,
    dv) or None are the cotangents of y and h_T.  Returns ``(dq, dk, dv,
    dlog_w, dh0, du)`` in f32, ``dh0`` None without ``h0`` and ``du`` None
    without ``u`` or when not ``strict``.
    """
    scalar = log_w.dim() == 2
    u = u if strict else None
    with torch.enable_grad():
        ins = [None if x is None else x.detach().float().requires_grad_(True)
               for x in (q, k, v, log_w, h0, u)]
        t = q.shape[1]
        pad = -t % chunk
        qq, kk, vv = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in ins[:3])
        lw = torch.nn.functional.pad(ins[3],
                                     (0, pad) if scalar else (0, 0, 0, pad))
        if scalar:
            y, h_t = chunked_scan_scalar_ref(qq, kk, vv, lw, ins[4],
                                             chunk=chunk)
        else:
            y, h_t = chunked_scan_ref(qq, kk, vv, lw, ins[4], chunk=chunk,
                                      strict=strict, u=ins[5])
        outs, cots = [y[:, :t]], [dy.float()]
        if dh_t is not None:
            outs.append(h_t)
            cots.append(dh_t.float())
        used = [x for x in ins if x is not None]
        grads = iter(torch.autograd.grad(outs, used, cots,
                                         allow_unused=True))
        out = []
        for x in ins:
            g = None if x is None else next(grads)
            out.append(torch.zeros_like(x) if x is not None and g is None
                       else g)
    return tuple(out)
