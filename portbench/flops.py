"""The benchmark's own operation and byte counts (frozen copies).

- :func:`decoder_train_flops_per_token`: copied from the port's
  ``models/llama.py::train_flops_per_token``: 6 FLOPs a parameter a token
  (forward and backward) plus the causal attention term ``12·L·dim·S``
  halved; no recompute is counted.  The parameter count is the reference's.
- :func:`causal_attention`: the FLOPs and bytes that causal attention needs
  for ``B×S`` rows of ``H`` query heads of width ``D`` over ``Hkv`` key and
  value heads: the forward's two products and the backward's four over the
  ``S(S+1)/2`` scored pairs a head, each input byte read once and each
  output byte written once, whatever implements it.
- :func:`resnet_train_flops`: the port's ``models/resnet.py::train_flops``
  method (``FlopCounterMode`` over a forward and backward of one example on
  the ``meta`` device, times the batch), counted on the benchmark's own
  reference ResNet-50 and not on the program's model.
"""

from __future__ import annotations


def decoder_param_count(cfg: dict) -> int:
    from portbench.reference.decoder import param_shapes

    n = 0
    for shape in param_shapes(cfg).values():
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def decoder_train_flops_per_token(cfg: dict, seq_len: int) -> float:
    return (6.0 * decoder_param_count(cfg)
            + 6.0 * cfg["num_hidden_layers"] * cfg["hidden_size"] * seq_len)


def causal_attention(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                     bytes_per_element: int = 2, backward: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of causal attention, forward and (by default) backward."""
    pairs = seq * (seq + 1) / 2  # scored (query, key) pairs a head
    products = 2 + (4 if backward else 0)  # QKᵀ, PV; then dV, dP, dQ, dK
    flops = products * 2.0 * pairs * head_dim * batch * heads
    q_like = batch * seq * heads * head_dim * bytes_per_element
    kv_like = batch * seq * kv_heads * head_dim * bytes_per_element
    fwd = 2 * q_like + 2 * kv_like  # read q, k, v; write o
    bwd = 4 * q_like + 4 * kv_like  # read q, k, v, o, dO; write dq, dk, dv
    return flops, float(fwd + (bwd if backward else 0))


def resnet_train_flops(cfg: dict, batch: int, image_size: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.resnet import ReferenceResNet

    with torch.device("meta"):
        model = ReferenceResNet(cfg)
        params = {n: torch.empty(s, requires_grad=True) for n, s in model.param_shapes().items()}
        x = torch.empty((1, image_size, image_size, 3))
        y = torch.zeros(1, dtype=torch.long)
        with FlopCounterMode(display=False) as counter:
            model.loss(params, x, y, label_smoothing=0.0).backward()
    return float(counter.get_total_flops()) * batch
