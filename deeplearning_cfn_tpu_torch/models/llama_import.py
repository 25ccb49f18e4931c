"""HuggingFace Llama checkpoint import — counterpart of
``deeplearning_cfn_tpu/models/llama_import.py``.

A ``LlamaForCausalLM`` state dict (torch tensors or numpy arrays; this
module imports no ``transformers``) becomes the port's ``Llama`` state dict.
Layout only, no numerics:

- HF linears store ``[out, in]``; the port stores ``[in, out]`` (the
  forward is ``x @ W``), so each is transposed, one tensor at a time, into a
  new contiguous tensor on the source's device;
- HF's per-layer keys (``model.layers.{i}.…``) map one to one onto the
  port's per-layer parameters (the JAX package stacks them instead);
- both use RoPE's split-halves convention, so q and k need no permutation.

:func:`from_hf_state_dict` consumes its input: each source tensor leaves the
dict as soon as it is converted, so an 8B import on the card holds one model
and one tensor more at its peak, never two models.  Configurations whose
logits this model would get wrong (RoPE scaling, biases, another activation,
another head layout, missing weights) raise :class:`ImportError_`, as the
JAX importer does.  A config with pipeline stages takes the same dict (its
blocks keep their global index).
"""

from __future__ import annotations

from typing import Any, MutableMapping

import torch

from deeplearning_cfn_tpu_torch.models.llama import LlamaConfig


class ImportError_(ValueError):
    pass


def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """``LlamaConfig`` from a ``transformers.LlamaConfig``-like object; raises
    :class:`ImportError_` for what this model does not reproduce."""
    if getattr(hf_config, "rope_scaling", None):
        raise ImportError_(
            "rope_scaling is set (Llama-3.1+ positional rescaling); this model "
            "implements plain RoPE and would produce wrong logits")
    head_dim = getattr(hf_config, "head_dim", None)
    expected = hf_config.hidden_size // hf_config.num_attention_heads
    if head_dim is not None and head_dim != expected:
        raise ImportError_(
            f"explicit head_dim={head_dim} != hidden_size/num_heads={expected}; "
            "unsupported layout")
    if getattr(hf_config, "attention_bias", False) or getattr(hf_config, "mlp_bias", False):
        raise ImportError_(
            "attention_bias/mlp_bias checkpoints are unsupported (this model has "
            "bias-free projections; importing would silently drop the bias terms)")
    act = getattr(hf_config, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ImportError_(
            f"hidden_act={act!r} unsupported (this model's MLP is SwiGLU/silu; "
            "importing would apply the wrong activation)")
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        mlp_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        dtype=dtype,
        tied_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
    )


def _as_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    from deeplearning_cfn_tpu_torch.interop import _tensor

    return _tensor(a)


def _transposed(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.T`` as one new contiguous tensor in ``dtype`` (no other copy)."""
    out = torch.empty((w.shape[1], w.shape[0]), dtype=dtype, device=w.device)
    return out.copy_(w.T)


# HF per-layer names -> the port's, and whether the tensor is a linear.
HF_LAYER_KEYS = (
    ("input_layernorm.weight", "attn_norm", False),
    ("self_attn.q_proj.weight", "wq", True),
    ("self_attn.k_proj.weight", "wk", True),
    ("self_attn.v_proj.weight", "wv", True),
    ("self_attn.o_proj.weight", "wo", True),
    ("post_attention_layernorm.weight", "mlp_norm", False),
    ("mlp.gate_proj.weight", "w_gate", True),
    ("mlp.up_proj.weight", "w_up", True),
    ("mlp.down_proj.weight", "w_down", True),
)


def from_hf_state_dict(cfg: LlamaConfig, state_dict: MutableMapping[str, Any]) -> dict:
    """HF ``LlamaForCausalLM.state_dict()`` -> the port's ``Llama`` state dict:
    linears transposed to ``[in, out]`` in ``cfg.dtype``, norms in f32, on
    the source tensors' device.  Takes ``model.``-prefixed (ForCausalLM) and
    bare (LlamaModel) keys.  Removes each tensor it converts from
    ``state_dict`` (a tied model's ``lm_head.weight`` stays).  A config with
    ``pp_stages`` > 1 takes the same dict: its blocks keep their global
    index, and ``pipeline.stack_stages`` of the per-layer tensors is the JAX
    importer's stage-stacked tree."""
    names = {k.removeprefix("model."): k for k in state_dict}

    def take(key: str) -> torch.Tensor:
        if key not in names:
            raise ImportError_(f"missing weight {key!r} in state dict")
        return _as_tensor(state_dict.pop(names.pop(key)))

    out = {"embed": take("embed_tokens.weight").to(cfg.dtype)}
    for i in range(cfg.n_layers):
        for hf, ours, linear in HF_LAYER_KEYS:
            w = take(f"layers.{i}.{hf}")
            out[f"layers.{i}.{ours}"] = _transposed(w, cfg.dtype) if linear else w.float()
            del w
    out["final_norm"] = take("norm.weight").float()
    if not cfg.tied_embeddings:
        if "lm_head.weight" not in state_dict:
            raise ImportError_(
                "config is untied but state dict has no lm_head.weight; set tied_embeddings=True")
        out["output"] = _transposed(_as_tensor(state_dict.pop("lm_head.weight")), cfg.dtype)
    return out


def from_hf(model: Any, dtype: torch.dtype = torch.bfloat16) -> tuple[LlamaConfig, dict]:
    """``(config, state dict)`` from a live ``transformers.LlamaForCausalLM``
    (or anything with its ``config`` and ``state_dict()``)."""
    cfg = config_from_hf(model.config, dtype=dtype)
    return cfg, from_hf_state_dict(cfg, dict(model.state_dict()))


def expected_hf_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """The HF ``LlamaForCausalLM`` state-dict shapes the importer expects for
    a config: the shape contract of :func:`from_hf_state_dict`."""
    d, hd = cfg.dim, cfg.head_dim
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, d),
        "model.norm.weight": (d,),
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes[p + "input_layernorm.weight"] = (d,)
        shapes[p + "self_attn.q_proj.weight"] = (cfg.n_heads * hd, d)
        shapes[p + "self_attn.k_proj.weight"] = (cfg.n_kv_heads * hd, d)
        shapes[p + "self_attn.v_proj.weight"] = (cfg.n_kv_heads * hd, d)
        shapes[p + "self_attn.o_proj.weight"] = (d, cfg.n_heads * hd)
        shapes[p + "post_attention_layernorm.weight"] = (d,)
        shapes[p + "mlp.gate_proj.weight"] = (cfg.mlp_dim, d)
        shapes[p + "mlp.up_proj.weight"] = (cfg.mlp_dim, d)
        shapes[p + "mlp.down_proj.weight"] = (d, cfg.mlp_dim)
    if not cfg.tied_embeddings:
        shapes["lm_head.weight"] = (cfg.vocab_size, d)
    return shapes
