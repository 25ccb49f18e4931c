"""A Mistral-architecture decoder and its training step, plain PyTorch.

The published block (Mistral-7B-v0.3's ``config.json``; Jiang et al.,
arXiv:2310.06825): RMSNorm, RoPE over split halves with the configuration's
``rope_theta`` (angles in f32 as the published code forms them), grouped-query
attention (each key/value head serves ``heads/kv_heads`` consecutive query
heads), causal softmax, SwiGLU, a final RMSNorm and an untied output head.
Weights are ``[in, out]`` and applied as ``x @ W``.  No sliding window: the
configuration sets none.

The step is AdamW with decoupled decay on the matrices (not the norms),
after a clip of the global gradient norm, as the configuration's
``training`` block states, on the mean next-token loss over every position
but the last.  It runs one sequence at a time and recomputes each block in
the backward, so that it fits on one card beside nothing else; the
gradients of the sequences add up to the batch's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.lowp import Products


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    d, m, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    shapes: dict[str, tuple[int, ...]] = {"embed": (V, d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        shapes.update({p + "attn_norm": (d,), p + "wq": (d, H * hd), p + "wk": (d, Hkv * hd),
                       p + "wv": (d, Hkv * hd), p + "wo": (H * hd, d), p + "mlp_norm": (d,),
                       p + "w_gate": (d, m), p + "w_up": (d, m), p + "w_down": (m, d)})
    shapes["final_norm"] = (d,)
    if not cfg["tie_word_embeddings"]:
        shapes["output"] = (d, V)
    return shapes


def is_norm(name: str) -> bool:
    return name.endswith("norm")


def decays(name: str, shape) -> bool:
    """AdamW's decay applies to the matrices, not to the norms' scales."""
    return len(shape) > 1 and not is_norm(name)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [S, H, D]`` rotated by position, the two halves of D as pairs."""
    S, _, D = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float32) / D))
    angles = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv_freq
    cos, sin = angles.cos()[:, None, :], angles.sin()[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prod: Products) -> torch.Tensor:
    """Causal attention of one sequence: ``q [S, H, D]``, ``k, v [S, Hkv, D]``."""
    S, H, D = q.shape
    group = H // k.shape[1]
    q = q.transpose(0, 1)
    k = k.transpose(0, 1).repeat_interleave(group, dim=0)
    v = v.transpose(0, 1).repeat_interleave(group, dim=0)
    scores = prod.mm(q, k.transpose(1, 2)) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return prod.mm(probs, v).transpose(0, 1).reshape(S, H * D)


def block(x, w: dict, cfg: dict, prod: Products) -> torch.Tensor:
    S = x.shape[0]
    H, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, w["attn_norm"], eps)
    q = rope(prod.mm(h, w["wq"]).view(S, H, hd), theta)
    k = rope(prod.mm(h, w["wk"]).view(S, Hkv, hd), theta)
    v = prod.mm(h, w["wv"]).view(S, Hkv, hd)
    x = x + prod.mm(attention(q, k, v, prod), w["wo"])
    h = rms_norm(x, w["mlp_norm"], eps)
    return x + prod.mm(F.silu(prod.mm(h, w["w_gate"])) * prod.mm(h, w["w_up"]), w["w_down"])


def sequence_nll(params: dict, tokens: torch.Tensor, targets: torch.Tensor, cfg: dict,
                 prod: Products) -> torch.Tensor:
    """The summed next-token loss of one sequence over every position but the
    last (whose target would wrap); each block recomputed in the backward."""
    x = params["embed"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        w = {k.split(".")[-1]: v for k, v in params.items() if k.startswith(f"layers.{i}.")}
        x = checkpoint(block, x, w, cfg, prod, use_reentrant=False)
    head = params["embed"].T if cfg["tie_word_embeddings"] else params["output"]
    logits = prod.mm(rms_norm(x[:-1], params["final_norm"], cfg["rms_norm_eps"]), head)
    return F.cross_entropy(logits, targets[:-1].long(), reduction="sum")


def train(cfg: dict, weights: dict, batches, steps: int, precision: str = "f32",
          rows: slice | None = None) -> dict:
    """``steps`` AdamW steps from ``weights`` (any dtype; trained in f32) on
    ``batches`` (``(tokens [B, S], targets [B, S])`` device tensors).

    Returns the loss of each step, each leaf's gradient norm as the
    optimizer gets it at step 1 (after the clip), and each leaf's change
    after the last step.  ``rows`` keeps only those rows of every batch (a
    planted fault: part of the batch left out, the mean over the rest)."""
    tr = cfg["training"]
    prod = Products(precision)
    params = {n: w.detach().float().clone().requires_grad_(True) for n, w in weights.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = tr["betas"]
    lr, wd, eps, clip = tr["learning_rate"], tr["weight_decay"], tr["eps"], tr["grad_clip_norm"]
    losses, first_grad = [], {}
    for t, (tokens, targets) in enumerate(batches[:steps], start=1):
        if rows is not None:
            tokens, targets = tokens[rows], targets[rows]
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for b in range(tokens.shape[0]):
            loss = sequence_nll(params, tokens[b], targets[b], cfg, prod) / count
            loss.backward()
            total += float(loss.detach())
            del loss
        losses.append(total)
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            if float(norm) >= clip:
                for g in grads.values():
                    g.mul_(clip / norm)
            if t == 1:
                first_grad = {n: float(g.norm()) for n, g in grads.items()}
            for n, p in params.items():
                g = grads[n]
                if decays(n, p.shape):
                    p.mul_(1 - lr * wd)
                m[n].lerp_(g, 1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p.grad = None
    with torch.no_grad():
        change = {n: float((p - weights[n].float()).norm()) for n, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
