"""Attention building blocks — counterpart of ``deeplearning_cfn_tpu/ops/attention.py``.

Plain PyTorch on ``[batch, seq, heads, head_dim]`` tensors, grouped-query
aware.  ``dot_product_attention`` is the materialised-scores path (the JAX
package's "xla" attention); the blockwise flash path with its CUDA kernel
lives in ``ops/flash_attention.py``.
"""

from __future__ import annotations

import torch


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention."""
    num_kv = k.shape[2]
    if num_kv == num_q_heads:
        return k
    if num_q_heads % num_kv:
        raise ValueError(f"q heads ({num_q_heads}) must be a multiple of kv heads ({num_kv})")
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=2)


def dot_product_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    causal: bool = True,
    mask: torch.Tensor | None = None,  # [B, 1, S, S] additive or bool
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Attention with the softmax in ``softmax_dtype`` (f32: a bf16 softmax
    loses tail mass).  Masked scores take ``finfo(softmax_dtype).min``."""
    seq_q, num_heads, head_dim = q.shape[-3:]
    k = _repeat_kv(k, num_heads)
    v = _repeat_kv(v, num_heads)
    scale = head_dim**-0.5
    # [B, H, Sq, Sk]; the product is taken in the input dtype, as in JAX.
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(softmax_dtype) * scale
    neg = torch.finfo(softmax_dtype).min
    if causal:
        seq_k = k.shape[1]
        causal_mask = torch.ones(seq_q, seq_k, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal_mask, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, neg)
        else:
            scores = scores + mask.to(softmax_dtype)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def rotary_embedding(
    x: torch.Tensor,  # [B, S, H, D]
    positions: torch.Tensor,  # [B, S] or [S]
    theta: float = 500000.0,  # Llama-3 base
) -> torch.Tensor:
    """RoPE over the last dim, split-halves convention, angles in f32."""
    head_dim = x.shape[-1]
    if positions.ndim == 1:
        positions = positions[None, :]
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim
    freqs = 1.0 / (theta**exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 accumulation regardless of the compute dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    norm = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (norm * weight.to(torch.float32)).to(dtype)
