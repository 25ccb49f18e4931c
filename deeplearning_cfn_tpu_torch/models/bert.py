"""BERT-family encoder for masked-LM pretraining — counterpart of
``deeplearning_cfn_tpu/models/bert.py``.

The same model as the JAX package's, with its numerics:

- Dense layers cast x, kernel and bias to ``cfg.dtype`` (bf16) and add the
  bias in that dtype, as ``nn.Dense(dtype=bf16)`` does; with
  ``use_pallas_mlp`` the MLP runs through :class:`FusedDense` (the CUDA
  fused-dense kernel on the card: f32 accumulation, bias and tanh-form gelu
  in f32).
- LayerNorm is Flax's: ε 1e-6, statistics in f32 as E[x²] − E[x]², f32
  output.  So the residual stream after each norm is f32, the dense outputs
  bf16, and ``x + attn`` promotes to f32.
- The MLM head applies tanh-form gelu to the bf16 output of
  ``mlm_transform``; the logits are the bf16 product with the tied token
  table, returned as f32.
- Dropout is never applied: neither JAX entry point applies it (``mlm_loss``
  and the trainer's default objective call the model deterministically).
  ``BertConfig.dropout`` is kept so configs map one to one.
- Inits follow Flax's distributions (lecun-normal kernels, zero biases,
  normal(0, 1/dim) embeddings), drawn from the port's own generator.

Parameter names follow the JAX tree (``tok_embed.embedding``,
``layers.{i}.qkv.kernel`` ...); ``interop.bert_params_from_jax`` maps one to
the other.  Matrices are ``[in, out]``; the forward is ``x @ W``.  The
``qkv`` kernel is the Flax ``[dim, 3, heads, head_dim]`` flattened to
``[dim, 3 * dim]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.models.fused_layers import FusedDense, lecun_normal, zeros
from deeplearning_cfn_tpu_torch.ops.attention import dot_product_attention
from deeplearning_cfn_tpu_torch.ops.fused_dense import gelu_tanh
from deeplearning_cfn_tpu_torch.parallel.data_ranks import global_count

LN_EPS = 1e-6  # Flax LayerNorm's default (torch's is 1e-5)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    dtype: Any = torch.bfloat16
    # Route the MLP (mlp_in + gelu, mlp_out) through the fused-dense kernel.
    # The parameters are the same either way.
    use_pallas_mlp: bool = False

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256, seq_len: int = 64) -> "BertConfig":
        return cls(
            vocab_size=vocab_size,
            dim=64,
            n_layers=2,
            n_heads=4,
            mlp_dim=128,
            max_seq_len=seq_len,
            dropout=0.0,
            dtype=torch.float32,
        )


# --- layers -------------------------------------------------------------------


class Dense(nn.Module):
    """``nn.Dense(features, dtype)``: x, kernel and bias cast to ``dtype``,
    the product and the bias add in that dtype."""

    def __init__(self, in_features: int, features: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = lecun_normal((in_features, features), generator)
        self.bias = zeros(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype=float32)``: f32 statistics with the fast
    variance ``max(E[x²] - E[x]², 0)``, ``(x - mean) * (rsqrt(var + ε) * scale) + bias``."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = zeros(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias


class Embed(nn.Module):
    """Flax ``nn.Embed``'s parameter: ``embedding [num, dim]`` f32 from
    ``default_embed_init`` (normal, variance 1/dim)."""

    def __init__(self, num: int, dim: int, generator=None):
        super().__init__()
        w = torch.randn((num, dim), generator=generator, dtype=torch.float32) / math.sqrt(dim)
        self.embedding = nn.Parameter(w)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        d, dt, gen = cfg.dim, cfg.dtype, generator
        self.qkv = Dense(d, 3 * d, dt, gen)
        self.attn_out = Dense(d, d, dt, gen)
        self.attn_ln = LayerNorm(d)
        if cfg.use_pallas_mlp:
            self.mlp_in = FusedDense(d, cfg.mlp_dim, activation="gelu", dtype=dt, generator=gen)
            self.mlp_out = FusedDense(cfg.mlp_dim, d, dtype=dt, generator=gen)
        else:
            self.mlp_in = Dense(d, cfg.mlp_dim, dt, gen)
            self.mlp_out = Dense(cfg.mlp_dim, d, dt, gen)
        self.mlp_ln = LayerNorm(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        qkv = self.qkv(x).reshape(B, S, 3, cfg.n_heads, cfg.dim // cfg.n_heads)
        attn = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
        attn = self.attn_out(attn.reshape(B, S, cfg.dim))
        x = self.attn_ln(x + attn)
        if cfg.use_pallas_mlp:
            mlp = self.mlp_out(self.mlp_in(x))
        else:
            mlp = self.mlp_out(gelu_tanh(self.mlp_in(x)))
        return self.mlp_ln(x + mlp)


class _BertTrunk(nn.Module):
    """Embeddings and layers, shared by the encoder and the classifier so a
    pretrained trunk transfers by name (:func:`transfer_trunk_params`)."""

    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.dim, generator)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.dim, generator)
        self.embed_ln = LayerNorm(cfg.dim)
        self.layers = nn.ModuleList(BertLayer(cfg, generator) for _ in range(cfg.n_layers))

    def trunk(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        S = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embed.embedding.to(dt))
        x = self.embed_ln(x + self.pos_embed.embedding[:S].to(dt)[None])
        for layer in self.layers:
            x = layer(x)
        return x


class BertEncoder(_BertTrunk):
    """tokens ``[B, S]`` -> MLM logits ``[B, S, vocab]`` f32."""

    def __init__(self, cfg: BertConfig | None = None, generator=None):
        cfg = cfg or BertConfig()
        super().__init__(cfg, generator)
        self.mlm_transform = Dense(cfg.dim, cfg.dim, cfg.dtype, generator)
        self.mlm_ln = LayerNorm(cfg.dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.trunk(tokens)
        x = self.mlm_ln(gelu_tanh(self.mlm_transform(x)))
        # The tied output projection casts the table on its own, as Flax's
        # Embed.attend does, so its gradient reaches the f32 table apart from
        # the lookup's.
        return (x.to(dt) @ self.tok_embed.embedding.to(dt).T).to(torch.float32)


class BertClassifier(_BertTrunk):
    """tokens ``[B, S]`` -> class logits ``[B, num_classes]`` f32: first-token
    pooling, a tanh pooler in ``cfg.dtype``, an f32 classifier."""

    def __init__(self, cfg: BertConfig | None = None, num_classes: int = 2, generator=None):
        cfg = cfg or BertConfig()
        super().__init__(cfg, generator)
        self.pooler = Dense(cfg.dim, cfg.dim, cfg.dtype, generator)
        self.classifier = Dense(cfg.dim, num_classes, torch.float32, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pooled = torch.tanh(self.pooler(self.trunk(tokens)[:, 0]))
        return self.classifier(pooled.to(torch.float32))


def transfer_trunk_params(pretrained: dict, target: dict) -> dict:
    """``target`` with every entry that ``pretrained`` also has replaced by
    the pretrained one: the trunk (embeddings, layers) moves, heads present
    on one side only keep the target's."""
    return {k: pretrained.get(k, v) for k, v in target.items()}


# --- loss, counts -------------------------------------------------------------


def mlm_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Mean NLL over the masked positions (``y >= 0``; ``y < 0`` are
    unmasked and excluded), and the masked-token accuracy.  Over several
    data ranks both divide by the whole batch's masked count
    (``parallel/data_ranks.global_count``), as JAX's global mean does."""
    logits = model(x)
    logp = torch.log_softmax(logits, dim=-1)
    safe = y.long().clamp_min(0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = (y >= 0).to(torch.float32)
    _, denom = global_count(mask.sum())
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == safe).to(torch.float32) * mask).sum() / denom
    return loss, {"masked_accuracy": acc}


def jax_kernel_shapes(cfg: BertConfig) -> dict[str, tuple[int, ...]]:
    """Kernels the port stores in another shape than the JAX leaf: each
    layer's ``qkv`` kernel, Flax ``DenseGeneral`` ``[dim, 3, heads,
    head_dim]``, stored ``[dim, 3 * dim]``.  For ``ops.quant.quantize_tree``,
    whose scales follow the leaf's last axis."""
    shape = (cfg.dim, 3, cfg.n_heads, cfg.dim // cfg.n_heads)
    return {f"layers.{i}.qkv.kernel": shape for i in range(cfg.n_layers)}


def param_count(cfg: BertConfig) -> int:
    """Parameters of ``BertEncoder``."""
    d, m = cfg.dim, cfg.mlp_dim
    layer = (d * 3 * d + 3 * d) + (d * d + d) + 2 * d + (d * m + m) + (m * d + d) + 2 * d
    return (cfg.vocab_size * d + cfg.max_seq_len * d + 2 * d + cfg.n_layers * layer
            + (d * d + d) + 2 * d)


def matmul_param_count(cfg: BertConfig) -> int:
    """Weights a token meets in a matrix product: every layer's four
    kernels, ``mlm_transform``, and the tied output projection."""
    d = cfg.dim
    return cfg.n_layers * (4 * d * d + 2 * d * cfg.mlp_dim) + d * d + cfg.vocab_size * d


def train_flops_per_token(cfg: BertConfig, seq_len: int) -> float:
    """Analytic forward+backward FLOPs per trained token: 6 per matmul
    weight, plus the non-causal attention term 12·L·dim·S (two products of
    2·S·dim a token a layer, tripled for the backward)."""
    return 6.0 * matmul_param_count(cfg) + 12.0 * cfg.n_layers * cfg.dim * seq_len


def make_trainer(cfg: BertConfig, trainer_config, device: torch.device | str | None = None):
    """Wire a BERT config into the Trainer: MLM loss and the analytic FLOPs
    numerator (the fused-dense kernel is invisible to a FLOP counter)."""
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    return Trainer(
        partial(BertEncoder, cfg),
        trainer_config,
        loss_fn=mlm_loss,
        device=device,
        analytic_flops_fn=lambda x: (
            train_flops_per_token(cfg, x.shape[1]) * x.shape[0] * x.shape[1]
        ),
    )
