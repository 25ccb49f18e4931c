"""Flash attention — counterpart of ``deeplearning_cfn_tpu/ops/pallas_attention.py``.

Layout ``[batch, seq, heads, head_dim]`` in and out, grouped-query aware
(``Hkv`` divides ``Hq``; a q head ``h`` reads kv head ``h // (Hq/Hkv)``, no
repeat anywhere).

- Forward: on a CUDA tensor the hand-written kernel
  ``ops/csrc/flash_attn_fwd.cu`` (built and launched by ``ops/_kernels.py``),
  which replaces the Pallas kernel ``_attn_kernel``.  On a CPU tensor
  :func:`flash_attention_reference`, the plain PyTorch version of the same
  blockwise online softmax.  There is no fallback between the two: a CUDA
  tensor launches the kernel or raises.
- Backward: :func:`_blockwise_backward`, the FA2 recompute from the saved
  log-sum-exp, as torch ops (in the JAX package it is plain XLA too).
- :class:`FlashAttention` ties them together as a ``torch.autograd.Function``,
  in place of ``_flash_core`` and its ``custom_vjp``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# Block sizes of the TPU kernel (VMEM-sized: docs/BENCH_NOTES.md's block
# sweep on the TPU).  Here they only set the kv blocking of the plain
# reference and of the backward, so that both sum in the order the JAX
# package does; the CUDA kernel uses its own 64-row tiles.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 512

# Sequence length from which models/llama.py dispatches to flash attention.
# The value is the crossover measured on the TPU against XLA's fused
# attention.  On an NVIDIA H100 80GB HBM3 at a 700 W limit (chip_smoke.py's
# crossover rows: m435 heads, 8 of 128, causal, 16,384 tokens a call), the
# kernel's forward beats the materialised-score path at every length from
# 512 (0.10 against 1.49 ms) to 4096 (0.28 against 10.6 ms); forward plus
# backward, where this port's flash backward is f32 torch ops, the
# materialised path is faster at every length measured, 3.6 against 6.9 ms
# at 512 and 24.2 against 26.4 ms at 4096.  So on that card the training
# crossover lies above 4096 until the backward is a kernel.  The value stays
# the TPU's until a change to it is planned.
FLASH_CROSSOVER_SEQ = 2048

# Block clamping constants of the JAX package (TPU tiling).  Kept so that the
# backward's blocking, and the reference's, match the JAX package's exactly.
_SUBLANE = 16
_PAD_TOLERANCE = 0.125
_MIN_MXU_BLOCK = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _clamp_block(block: int, seq: int) -> int:
    """Effective block size: the largest candidate <= ``block`` whose padded
    sequence length ``round_up(seq, b)`` is within ``_PAD_TOLERANCE`` of the
    minimum, with candidates floored at 128 whenever the sequence reaches it.
    The same rule as the JAX package, so both block the kv axis alike."""
    seq_t = _round_up(max(seq, _SUBLANE), _SUBLANE)
    floor = min(_MIN_MXU_BLOCK, seq_t)
    candidates = []
    b = _round_up(block, _SUBLANE)
    while b >= floor:
        candidates.append((b, _round_up(seq_t, b)))
        if b > floor and b // 2 < floor:
            b = floor  # non-power-of-two ladders must still consider the floor
        else:
            b //= 2
    if not candidates:  # block < floor: honor the caller's small block
        return min(_round_up(block, _SUBLANE), seq_t)
    min_padded = min(p for _, p in candidates)
    best = next(b for b, padded in candidates if padded <= min_padded * (1.0 + _PAD_TOLERANCE))
    return min(best, seq_t)


def _causal_mask(q_lo: int, sq: int, k_lo: int, bk: int, device) -> torch.Tensor:
    """``[Sq - q_lo, bk]`` bool, True where key position <= query position."""
    q_pos = torch.arange(q_lo, sq, device=device)
    k_pos = torch.arange(k_lo, k_lo + bk, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward: ``(out [B,Sq,Hq,D] in q's
    dtype, lse [B,Hq,Sq] f32)``.

    The same arithmetic as the Pallas kernel: scores and the running max,
    denominator and accumulator in f32; masked scores at ``NEG_INF``; the
    shift clamped to 0 for rows with no valid key yet; ``p`` cast to v's
    dtype for the ``p @ v`` product; ``l == 0`` rows give out 0 and lse
    ``NEG_INF``.  All q rows are processed at once per kv block; under the
    causal mask the rows above a block (all keys masked, so the block leaves
    their state unchanged) are not touched, and blocks past the last query
    are skipped, as the kernel skips them."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = D**-0.5
    bk = _clamp_block(block_k, Sk)
    f32 = torch.float32
    qg = q.reshape(B, Sq, Hkv, group, D).to(f32)
    m = torch.full((B, Sq, Hkv, group), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, group), dtype=f32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, group, D), dtype=f32, device=q.device)
    for start in range(0, Sk, bk):
        if causal and start > Sq - 1:
            break
        lo = start if causal else 0
        kb = k[:, start : start + bk].to(f32)
        vb = v[:, start : start + bk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg[:, lo:], kb) * sm_scale
        mask = None
        if causal:
            mask = _causal_mask(lo, Sq, start, kb.shape[1], q.device)[None, :, None, None, :]
            s = s.masked_fill(~mask, NEG_INF)
        m_prev, l_prev = m[:, lo:], l[:, lo:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        shift = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new), m_new)
        p = torch.exp(s - shift[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        alpha = torch.where(
            m_prev <= NEG_INF / 2, torch.zeros_like(m_prev), torch.exp(m_prev - shift)
        )
        l_new = alpha * l_prev + p.sum(dim=-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f32), vb.to(f32))
        acc_new = acc[:, lo:] * alpha[..., None] + pv
        # New tensors, not in-place writes, so autograd can differentiate
        # the reference (the card's gradient check holds the kernel to it).
        m, l, acc = (
            torch.cat([old[:, :lo], new], dim=1)
            for old, new in ((m, m_new), (l, l_new), (acc, acc_new))
        )
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / denom[..., None]).to(q.dtype).reshape(B, Sq, Hq, D)
    lse = torch.where(l == 0.0, torch.full_like(m, NEG_INF), m + torch.log(denom))
    return out, lse.reshape(B, Sq, Hq).transpose(1, 2).contiguous()


def _blockwise_backward(
    q, k, v, out, lse, g, *, causal: bool, sm_scale: float, block_k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute ``p`` blockwise from the saved LSE and accumulate dq/dk/dv
    over kv blocks (FA2).  Never materialises ``[Sq, Sk]`` and never expands
    the kv heads: the GQA group is an explicit axis.  Contractions run in f32
    on f32 copies, as the JAX package's ``preferred_element_type=f32``
    einsums do.  Under the causal mask, rows above a block and blocks past
    the last query contribute exactly zero and are skipped."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    f32 = torch.float32
    qg = q.reshape(B, Sq, Hkv, group, D).to(f32)
    gg = g.reshape(B, Sq, Hkv, group, D).to(f32)
    # delta_i = sum_d out_i * dout_i  (FA2: the dp_ij - delta_i term)
    delta = torch.einsum("bqhgd,bqhgd->bqhg", out.reshape(B, Sq, Hkv, group, D).to(f32), gg)
    lse_g = lse.reshape(B, Hkv, group, Sq).permute(0, 3, 1, 2)  # [B, Sq, Hkv, g]
    dq = torch.zeros((B, Sq, Hkv, group, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, Sk, Hkv, D), dtype=f32, device=q.device)
    for start in range(0, Sk, block_k):
        if causal and start > Sq - 1:
            break
        lo = start if causal else 0
        kb = k[:, start : start + block_k].to(f32)
        vb = v[:, start : start + block_k].to(f32)
        q_b, g_b = qg[:, lo:], gg[:, lo:]
        s = torch.einsum("bqhgd,bkhd->bqhgk", q_b, kb) * sm_scale
        p = torch.exp(s - lse_g[:, lo:, ..., None])
        if causal:
            mask = _causal_mask(lo, Sq, start, kb.shape[1], q.device)[None, :, None, None, :]
            p = p.masked_fill(~mask, 0.0)
        dv[:, start : start + block_k] = torch.einsum("bqhgk,bqhgd->bkhd", p, g_b)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", g_b, vb)
        ds = p * (dp - delta[:, lo:, ..., None]) * sm_scale
        dq[:, lo:] += torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dk[:, start : start + block_k] = torch.einsum("bqhgk,bqhgd->bkhd", ds, q_b)
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, causal: bool, sm_scale: float):
    """Device dispatch of the forward: the CUDA kernel for CUDA tensors, the
    plain reference for CPU tensors (and for ``meta`` ones, whose trace
    computes nothing), nothing else."""
    if q.device.type == "cuda":
        from deeplearning_cfn_tpu_torch.ops import _kernels

        return _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")


class FlashAttention(torch.autograd.Function):
    """Kernel (or reference) forward, FA2 blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = _forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _blockwise_backward(
            q, k, v, out, lse, g,
            causal=ctx.causal,
            sm_scale=ctx.sm_scale,
            block_k=_clamp_block(DEFAULT_BLOCK_K, k.shape[1]),
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    sp: int = 1,
) -> torch.Tensor:
    """Flash attention, ``[B, S, H, D]`` in and out; ``Hkv`` must divide ``Hq``.

    The JAX package's mesh rules: the sequence must be whole (``sp`` > 1
    raises: ring attention splits it); under ``tp`` the caller passes one tp
    rank's heads, which keeps each q head's kv head on its rank only when
    ``tp`` divides the model's kv heads (``models/llama.py`` checks it)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if sp > 1:
        raise ValueError("flash_attention does not split the sequence; use ring "
                         "attention for sp > 1")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
