"""Weights from the JAX package into the port.

Each function takes a JAX parameter tree as numpy arrays
(``jax.device_get(params)``; this module imports no JAX) and returns a
``state_dict`` for the port's model, every matrix kept in its ``[in, out]``
orientation (the port computes ``x @ W`` as the JAX package does, so nothing
is transposed):

- ``llama_params_from_jax``: the stacked ``[L, ...]`` leaves split per layer
  (MoE's ``layers/moe`` leaves as ``layers.{i}.moe.*``, and with
  ``ep_size`` > 1 only ``ep_rank``'s experts; with ``tp_size`` > 1 each
  tensor cut to ``tp_rank``'s contiguous share of its spec's ``tp`` dim; a
  stage-stacked tree's ``[pp, L/pp, ...]`` leaves unstacked, the whole model
  or, with ``pp_size`` > 1, only ``pp_rank``'s stage);
- ``bert_params_from_jax``: the Flax tree of ``BertEncoder`` or
  ``BertClassifier``, ``layer{i}`` as ``layers.{i}``, the ``DenseGeneral``
  ``qkv`` kernel ``[dim, 3, H, hd]`` and bias ``[3, H, hd]`` flattened in that
  order;
- ``resnet_params_from_jax``: the Flax ``ResNet`` tree and its
  ``batch_stats``.  Convolutions are the one exception to the orientation
  rule: PyTorch's are ``[out, in, kh, kw]``, so Flax's ``[kh, kw, in, out]``
  kernels are transposed;
- ``vgg_params_from_jax``: the Flax ``VGG`` tree and its ``batch_stats``, by
  the ResNet rules;
- ``retinanet_params_from_jax``: the Flax ``RetinaNet`` tree and its
  ``batch_stats``: the backbone by the ResNet rules under ``backbone.``, the
  FPN, head and protonet convolutions (``kernel`` and ``bias``) as
  ``weight`` (transposed) and ``bias``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only views
    # JAX bf16 arrays reach numpy as ml_dtypes.bfloat16, which torch.from_numpy
    # refuses: reinterpret the bits.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def llama_params_from_jax(cfg, params_np: dict, ep_rank: int = 0, ep_size: int = 1,
                          tp_rank: int = 0, tp_size: int = 1, pp_rank: int = 0,
                          pp_size: int = 1) -> dict[str, torch.Tensor]:
    """JAX ``init_params`` tree (numpy leaves) -> ``Llama`` state dict; with
    ``ep_size`` > 1, the expert leaves cut to ``ep_rank``'s experts (the
    state dict of a model after ``MoE.shard_experts``); with ``tp_size`` > 1,
    every tensor whose spec (``models.llama.param_specs``) has a ``tp`` dim
    cut to ``tp_rank``'s contiguous share of it: what that rank's ``DTensor``
    holds locally (``parallel/tensor_parallel.distribute_tp``).  With
    ``cfg.pp_stages`` > 1 the layer leaves are JAX's stage-stacked
    ``[pp, L/pp, ...]``: unstacked to ``layers.{i}``, all of them, or with
    ``pp_size`` > 1 those of ``pp_rank``'s stage (``pipeline.stage_layers``),
    what that rank's ``Llama`` over a pp mesh holds."""
    from deeplearning_cfn_tpu_torch.parallel import pipeline

    params_np = dict(params_np)
    if cfg.pp_stages > 1:
        params_np["layers"] = pipeline.unstack_stages(
            {k: ({n: np.asarray(a) for n, a in v.items()} if isinstance(v, dict)
                 else np.asarray(v)) for k, v in params_np["layers"].items()})
    own = (pipeline.stage_layers(cfg.n_layers, pp_size, pp_rank) if pp_size > 1
           else range(cfg.n_layers))
    sd = {"embed": _tensor(params_np["embed"]), "final_norm": _tensor(params_np["final_norm"])}
    if not cfg.tied_embeddings:
        sd["output"] = _tensor(params_np["output"])
    layers = dict(params_np["layers"])
    for name, stacked in layers.pop("moe", {}).items():
        arr = np.asarray(stacked)  # [L, E, ...] (the router [L, d, E])
        if name != "router" and ep_size > 1:
            per = arr.shape[1] // ep_size
            arr = arr[:, ep_rank * per:(ep_rank + 1) * per]
        layers[f"moe.{name}"] = arr
    for name, stacked in layers.items():
        arr = np.asarray(stacked)
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"layers/{name} has {arr.shape[0]} layers, config has {cfg.n_layers}")
        for i in own:
            sd[f"layers.{i}.{name}"] = _tensor(arr[i])
    if tp_size > 1:
        from deeplearning_cfn_tpu_torch.models.llama import param_specs
        from deeplearning_cfn_tpu_torch.parallel.sharding import tp_dim

        for name, spec in param_specs(cfg).items():
            d = tp_dim(spec)
            if d is not None and name in sd:
                sd[name] = sd[name].chunk(tp_size, dim=d)[tp_rank].contiguous()
    return sd


def bert_params_from_jax(cfg, params_np: dict) -> dict[str, torch.Tensor]:
    """Flax ``BertEncoder``/``BertClassifier`` params (numpy leaves) -> the
    port's state dict."""
    sd: dict[str, torch.Tensor] = {}
    n_layers = 0

    def visit(path: list[str], node) -> None:
        nonlocal n_layers
        if isinstance(node, dict):
            for key, child in node.items():
                visit(path + [key], child)
            return
        top = path[0]
        if top.startswith("layer") and top[5:].isdigit():
            n_layers = max(n_layers, int(top[5:]) + 1)
            path = ["layers", top[5:], *path[1:]]
        arr = np.asarray(node)
        if path[-2] == "qkv":  # DenseGeneral: [dim, 3, H, hd] / [3, H, hd]
            arr = arr.reshape(cfg.dim, 3 * cfg.dim) if path[-1] == "kernel" else arr.reshape(-1)
        sd[".".join(path)] = _tensor(arr)

    visit([], params_np)
    if n_layers != cfg.n_layers:
        raise ValueError(f"params have {n_layers} layers, config has {cfg.n_layers}")
    return sd


def resnet_params_from_jax(params_np: dict, batch_stats_np: dict | None = None) -> dict[str, torch.Tensor]:
    """Flax ``ResNet`` params and ``batch_stats`` (numpy leaves) -> the port's
    ``ResNet`` state dict: conv ``kernel [kh, kw, in, out]`` -> ``weight [out,
    in, kh, kw]`` (and the folded variant's conv ``bias``); norm ``scale`` /
    ``bias`` -> ``weight`` / ``bias`` (GroupNorm's inner ``gn`` scope dropped);
    ``batch_stats`` ``mean`` / ``var`` -> the BatchNorm buffers; the head's
    ``[in, out]`` kernel and bias as they are."""
    sd: dict[str, torch.Tensor] = {}

    def visit(path: list[str], node) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                visit(path + [key], child)
            return
        scope = [p for p in path[:-1] if p != "gn"]
        leaf, arr = path[-1], np.asarray(node)
        if scope[-1].startswith("conv") and leaf == "kernel":
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif scope[-1].startswith("bn") and leaf == "scale":
            leaf = "weight"
        sd[".".join(scope + [leaf])] = _tensor(arr)

    visit([], params_np)
    visit([], batch_stats_np or {})
    return sd


def vgg_params_from_jax(params_np: dict, batch_stats_np: dict | None = None) -> dict[str, torch.Tensor]:
    """Flax ``VGG`` params and ``batch_stats`` -> the port's ``VGG`` state
    dict: ``conv{i}`` kernels transposed, ``bn{i}`` ``scale`` as ``weight``,
    the f32 ``head`` as it is (the names follow the ResNet rules)."""
    return resnet_params_from_jax(params_np, batch_stats_np)


def retinanet_params_from_jax(params_np: dict,
                              batch_stats_np: dict | None = None) -> dict[str, torch.Tensor]:
    """Flax ``RetinaNet`` params and ``batch_stats`` -> the port's
    ``RetinaNet`` state dict."""
    stats = (batch_stats_np or {}).get("backbone")
    sd = {f"backbone.{k}": v
          for k, v in resnet_params_from_jax(params_np["backbone"], stats).items()}
    for top, scopes in params_np.items():
        if top == "backbone":
            continue
        for scope, leaves in scopes.items():
            for leaf, arr in leaves.items():
                arr = np.asarray(arr)
                if leaf == "kernel":
                    leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
                sd[f"{top}.{scope}.{leaf}"] = _tensor(arr)
    return sd
