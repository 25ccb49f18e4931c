"""Autoregressive decoding for the Llama family — counterpart of
``deeplearning_cfn_tpu/models/llama_decode.py``.

The same inference path in PyTorch idiom:

- **A static cache**: ``KVCache`` is one ``[L, B, max_seq, Hkv, D]`` buffer
  for k and one for v, allocated once per generation; every step attends
  over the whole buffer under a position mask rather than a growing slice.
- **The training model's own weights**: the decode path loops over
  ``model.layers`` and reads each block's ``attn_norm``, ``wq`` ... ``w_down``
  where JAX scans the stacked ``[L, ...]`` leaves, so a trained model decodes
  as it is.  The cache is written in place (the counterpart of the carry
  JAX threads through ``lax.scan``).
- **Whole generation as a Python loop**: prefill forwards the prompt once,
  then ``max_new_tokens - 1`` one-token steps, all under
  ``torch.inference_mode()``.
- Greedy argmax at temperature 0, else a draw from ``softmax(logits / T)``
  with an explicit ``torch.Generator``.  ``torch.argmax`` returns the first
  of equal maxima, as ``jnp.argmax`` does, so greedy tokens are the JAX
  package's on the same logits.

The decode path reads the unfused ``wq``/``wk``/``wv`` and
``w_gate``/``w_up``, as the JAX package's does, so a model built with
``fused_qkv`` is refused.  An MoE model routes each step's tokens through
its experts as one group, as the JAX decode step does.  A stage-stacked
config (``pp_stages`` > 1) decodes as the flat stack, as JAX's unstacks it;
a model split over pp ranks is refused.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig
from deeplearning_cfn_tpu_torch.ops.attention import (
    dot_product_attention,
    rms_norm,
    rotary_embedding,
)

@dataclass(frozen=True)
class KVCache:
    """Per-layer K/V buffers, layer axis leading."""

    k: torch.Tensor  # [L, B, max_seq, Hkv, D]
    v: torch.Tensor


def init_cache(
    cfg: LlamaConfig, batch: int, max_seq: int, device: torch.device | str | None = None
) -> KVCache:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
    )


def check_decodable(cfg: LlamaConfig) -> None:
    """Refuse the configs the decode path cannot read.  A stage-stacked
    config (``pp_stages`` > 1) decodes as the flat stack, as JAX's does: a
    model built without a pp mesh holds every block in layer order."""
    if cfg.fused_qkv:
        raise ValueError(
            "decoding reads the unfused wq/wk/wv and w_gate/w_up, as the JAX "
            "package's decode path does; build the model with fused_qkv=False"
        )


def sample_token(
    logits: torch.Tensor,  # [..., V] float32
    generator: torch.Generator | None,
    temperature: float,
) -> torch.Tensor:
    """Greedy argmax at temperature 0.0, else a draw from
    ``softmax(logits / T)`` with ``generator``.  int32, shape ``logits[..., 0]``.

    Shared by :func:`generate` and the serving plane's paged steps, so both
    sample with the same arithmetic."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.reshape(-1, logits.shape[-1]) / temperature, dim=-1)
    draw = torch.multinomial(probs, 1, generator=generator)
    return draw.reshape(logits.shape[:-1]).to(torch.int32)


def project_qkv(cfg: LlamaConfig, layer: LlamaBlock, x: torch.Tensor, positions: torch.Tensor):
    """The block's attention inputs: rms_norm, the q/k/v projections and RoPE
    on ``x [B, T, d]`` at ``positions`` (``[T]`` or ``[B, T]``)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    q = (h @ layer.wq).reshape(B, T, cfg.n_heads, hd)
    k = (h @ layer.wk).reshape(B, T, cfg.n_kv_heads, hd)
    v = (h @ layer.wv).reshape(B, T, cfg.n_kv_heads, hd)
    q = rotary_embedding(q, positions, cfg.rope_theta)
    k = rotary_embedding(k, positions, cfg.rope_theta)
    return q, k, v


def finish_block(
    cfg: LlamaConfig, layer: LlamaBlock, x: torch.Tensor, attn: torch.Tensor
) -> torch.Tensor:
    """The rest of the block after attention: the output projection and
    the SwiGLU MLP (or, with MoE, the expert bank routing these ``B·T``
    tokens as one group, as the JAX decode step does), each with its
    residual."""
    B, T = x.shape[:2]
    x = x + attn.reshape(B, T, cfg.n_heads * cfg.head_dim) @ layer.wo
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
    if cfg.moe is not None:
        return x + layer.moe(h)[0]
    gate = F.silu((h @ layer.w_gate).to(torch.float32)).to(h.dtype)
    return x + (gate * (h @ layer.w_up)) @ layer.w_down


def embed(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, model.embed.to(model.cfg.dtype))


def logits_f32(model: Llama, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the (tied or untied) output head, as f32 logits."""
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if cfg.tied_embeddings:
        logits = x @ model.embed.to(cfg.dtype).T
    else:
        logits = x @ model.output
    return logits.to(torch.float32)


def _attend_cached(
    q: torch.Tensor,  # [B, S, H, D]
    cache_k: torch.Tensor,  # [B, max_seq, Hkv, D]
    cache_v: torch.Tensor,
    valid_len: int,  # positions < valid_len are real
    causal_offset: int,  # position of q[:, 0] in the sequence
) -> torch.Tensor:
    """Attention over the whole static cache: the training attention op
    with an explicit validity and causal mask (causal by position, since q
    and cache indices are offset from each other)."""
    S = q.shape[1]
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    qpos = causal_offset + torch.arange(S, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < valid_len)
    return dot_product_attention(q, cache_k, cache_v, causal=False, mask=mask[None, None])


def _block_cached(cfg, x, layer, lk, lv, positions, valid_len, offset) -> torch.Tensor:
    """One decoder block over cached K/V; writes the new K/V into ``lk``/``lv``
    (one layer's ``[B, max_seq, Hkv, D]``) in place, then attends through
    them, as the JAX block does (write-then-attend)."""
    S = x.shape[1]
    q, k, v = project_qkv(cfg, layer, x, positions)
    lk[:, offset : offset + S] = k.to(lk.dtype)
    lv[:, offset : offset + S] = v.to(lv.dtype)
    return finish_block(cfg, layer, x, _attend_cached(q, lk, lv, valid_len, offset))


@torch.inference_mode()
def _forward_cached(
    model: Llama, tokens: torch.Tensor, cache: KVCache, offset: int
) -> tuple[torch.Tensor, KVCache]:
    """Forward ``tokens [B, S]`` starting at position ``offset``, reading and
    writing ``cache`` in place.  Returns (f32 logits ``[B, S, V]``, cache)."""
    cfg = model.cfg
    check_decodable(cfg)
    if model.pipelined:
        raise ValueError("decoding reads every block: build the model without a pp mesh "
                         "(its stages' blocks in one stack)")
    S = tokens.shape[1]
    x = embed(model, tokens)
    positions = offset + torch.arange(S, dtype=torch.int32, device=tokens.device)
    for layer, lk, lv in zip(model.layers, cache.k, cache.v):
        x = _block_cached(cfg, x, layer, lk, lv, positions, offset + S, offset)
    return logits_f32(model, x), cache


@torch.inference_mode()
def generate(
    model: Llama,
    prompt: torch.Tensor,  # [B, S_prompt] int32, on the model's device
    generator: torch.Generator | None = None,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
) -> torch.Tensor:
    """Prefill, then ``max_new_tokens - 1`` decode steps.  Returns
    ``[B, max_new_tokens]`` int32 sampled tokens (temperature 0.0: greedy)."""
    cfg = model.cfg
    B, S = prompt.shape
    max_seq = S + max_new_tokens
    if max_seq > cfg.max_seq_len:
        raise ValueError(
            f"prompt {S} + {max_new_tokens} new tokens exceeds max_seq_len={cfg.max_seq_len}"
        )
    cache = init_cache(cfg, B, max_seq, prompt.device)
    logits, cache = _forward_cached(model, prompt, cache, 0)
    token = sample_token(logits[:, -1], generator, temperature)
    out = [token]
    for pos in range(S, max_seq - 1):
        logits, cache = _forward_cached(model, token[:, None], cache, pos)
        token = sample_token(logits[:, -1], generator, temperature)
        out.append(token)
    return torch.stack(out, dim=1)
