"""Mixture-of-experts feed-forward — counterpart of ``deeplearning_cfn_tpu/ops/moe.py``.

The same function as the JAX package's ``moe_mlp``:

- a router in f32, top-k over its softmax, the gate renormalised when
  k > 1 (k = 1 keeps the raw top-1 probability, so the task gradient reaches
  the router);
- fixed capacity ``C`` a routing group and expert, slots claimed with top-1
  priority (a cumsum over ``[k·t, E]``: every token's first choice before any
  second choice), claims past ``C`` dropped (the token's residual still
  flows);
- the Switch load-balancing loss, ``w · E · Σ_e f_e p_e``.

**Routing groups.**  JAX routes each data-parallel shard of the batch as one
group (``_n_data_groups``: G = dp × fsdp) and averages the aux loss over the
groups.  Here each rank routes its own tokens, so a rank's local batch *is*
JAX's group, and the mean over groups is the mean over ranks that the data
parallelism's gradient average (and the trainer's logged metrics) take.  On
one process there is one group, as JAX without a mesh has.

**Dispatch and combine by index.**  JAX writes them as einsums against a
dense one-hot ``[G, t, E, C]``; at the m435 training shape (t = 16 384,
E·C = 40 960) that tensor is 671 M elements a layer and the einsums do more
work than the model.  Here each expert slot gathers the token that claimed
it into ``[E, C, d]`` (an empty slot reads a zero row), the experts run as
batched products, and each token gathers its ≤ k slot outputs back, weighted
by its gates.  The same function: dispatch exactly, combine up to the order
of ≤ k additions a token.

**Expert parallelism** keeps JAX's layout (``moe_param_specs``): the batch is
split over ``("dp", "fsdp")`` only, so the ranks along ``ep`` hold the same
tokens and route them alike; each holds ``E / ep`` experts and computes their
share of ``y``, and the shares are summed over the ``ep`` group.  Every
``ep`` rank then holds the same ``y`` and, downstream, the same gradient of
it, so the sum's backward is the identity (an all-reduce would multiply the
gradient by ``ep``).  Upstream, each rank's share reaches the MoE input and
the gates only through its own experts, so the input the experts read and
the gate weights pass through the converse op (the identity forward, a sum
over ``ep`` backward); the router, which every rank computes alike, then gets
the whole gradient on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import CopyToGroup as _CopyToGroup
from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import SumOverGroup as _SumOverGroup


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    # C = ceil(top_k * tokens * capacity_factor / n_experts), rounded up to a
    # multiple of 8.
    capacity_factor: float = 1.25
    # Weight of the Switch load-balancing auxiliary loss.
    aux_loss_weight: float = 0.01


def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, int(math.ceil(cap / 8)) * 8)


def moe_param_specs() -> dict[str, tuple]:
    """Expert axis over ``ep``; the within-expert axes as the dense MLP's."""
    return {
        "router": (None, None),
        "w_gate": ("ep", "fsdp", "tp"),
        "w_up": ("ep", "fsdp", "tp"),
        "w_down": ("ep", "tp", "fsdp"),
    }


@dataclass
class Routing:
    """One routing group's decisions over ``t`` tokens."""

    probs: torch.Tensor  # [t, E] f32
    gate: torch.Tensor  # [t, k] f32, renormalised when k > 1
    expert: torch.Tensor  # [t, k] int64, the chosen experts in order
    slot: torch.Tensor  # [t, k] int64, the slot claimed (0 where dropped)
    kept: torch.Tensor  # [t, k] f32, 1 where the claim fits the capacity
    capacity: int


def route(cfg: MoEConfig, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """Top-k routing with top-1 slot priority over the tokens ``xt [t, d]``."""
    t = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, t)
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)
    if k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    with torch.no_grad():
        sel = F.one_hot(expert, E).to(torch.int32)  # [t, k, E]
        # [E, k*t]: each expert's claims, every first choice before any
        # second one; the cumsum runs along the contiguous dim (a scan
        # across rows of [k*t, E] is the slow, outer-dim one on the card).
        priority = sel.permute(2, 1, 0).reshape(E, k * t)
        pos = (torch.cumsum(priority, dim=1) - priority).reshape(E, k, t).permute(2, 1, 0)
        pos = (pos * sel).sum(dim=-1)  # [t, k]: the slot each claim asks for
        fits = pos < C
        slot = torch.where(fits, pos, 0).to(torch.int64)
        kept = fits.to(torch.float32)
    return Routing(probs, gate, expert, slot, kept, C)


def aux_loss(cfg: MoEConfig, r: Routing) -> torch.Tensor:
    """Switch load balancing: ``E · Σ_e f_e p_e`` times the weight, with f_e
    the share of tokens whose first choice is e and p_e e's mean
    probability; 1 at uniform routing."""
    E = cfg.n_experts
    f = F.one_hot(r.expert[:, 0], E).to(torch.float32).mean(dim=0)
    p = r.probs.mean(dim=0)
    return cfg.aux_loss_weight * E * torch.sum(f * p)


def moe_mlp(cfg: MoEConfig, params, x: torch.Tensor, ep_group=None,
            expert_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` -> ``(y [B, S, d], aux_loss)`` over the experts in
    ``params`` (``router [d, E]``, ``w_gate``/``w_up [E', d, m]``,
    ``w_down [E', m, d]``): all E on one rank, or with ``ep_group`` the
    ``E' = E / ep`` experts from ``expert_offset`` that this rank holds."""
    B, S, d = x.shape
    t = B * S
    xt = x.reshape(t, d)
    r = route(cfg, params["router"], xt)
    n_local = params["w_gate"].shape[0]
    C = r.capacity
    gates = r.gate * r.kept
    if ep_group is not None:
        xt = _CopyToGroup.apply(xt, ep_group)
        gates = _CopyToGroup.apply(gates, ep_group)
    with torch.no_grad():
        local = r.expert - expert_offset
        mine = (local >= 0) & (local < n_local) & (r.kept > 0)
        sink = n_local * C
        flat = torch.where(mine, local * C + r.slot, sink)  # [t, k]
        # Each slot's token (t: the zero row) — claims are unique but for
        # the sink, which nothing reads.
        token = torch.full((sink + 1,), t, dtype=torch.int64, device=x.device)
        ids = torch.arange(t, device=x.device).unsqueeze(1).expand(t, cfg.top_k)
        token.scatter_(0, flat.reshape(-1), ids.reshape(-1))
    # index_select, not x[idx]: its backward is an index_add (a slot's row
    # gets one gradient; a token's, at most k), where advanced indexing's is
    # a sort-based accumulation several times slower on the card.
    pad = torch.cat([xt, xt.new_zeros(1, d)])
    expert_in = pad.index_select(0, token[:sink]).reshape(n_local, C, d)
    gate = F.silu(torch.bmm(expert_in, params["w_gate"]).to(torch.float32)).to(x.dtype)
    up = torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(gate * up, params["w_down"]).reshape(sink, d)
    out = torch.cat([expert_out, expert_out.new_zeros(1, d)])
    out = out.index_select(0, flat.reshape(-1)).reshape(t, cfg.top_k, d)
    y = (out * (gates * mine).to(x.dtype).unsqueeze(-1)).sum(dim=1)
    if ep_group is not None:
        y = _SumOverGroup.apply(y, ep_group)
    return y.reshape(B, S, d), aux_loss(cfg, r)


def _device(generator):
    """Where a draw from ``generator`` lands: its device (the default one
    without a generator), as ``models/llama._dense`` draws."""
    return generator.device if generator is not None else None


def _dense(shape, dtype, generator) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=_device(generator)) / shape[-2] ** 0.5
    return nn.Parameter(w.to(dtype))


class MoE(nn.Module):
    """The expert bank of one block, leaves named as JAX's ``layers/moe``:
    ``router [d, E]`` (f32), ``w_gate``/``w_up [E, d, m]``, ``w_down
    [E, m, d]``, each expert normal / sqrt(fan_in), the router normal ×
    0.02.  :meth:`shard_experts` keeps one ``ep`` rank's experts."""

    def __init__(self, cfg: MoEConfig, dim: int, mlp_dim: int, dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_experts
        self.router = nn.Parameter(
            torch.randn((dim, E), generator=generator, dtype=torch.float32,
                        device=_device(generator)) * 0.02)
        self.w_gate = _dense((E, dim, mlp_dim), dtype, generator)
        self.w_up = _dense((E, dim, mlp_dim), dtype, generator)
        self.w_down = _dense((E, mlp_dim, dim), dtype, generator)
        self.ep_group = None
        self.expert_offset = 0

    @torch.no_grad()
    def shard_experts(self, rank: int, size: int, group) -> None:
        """Keep experts ``[rank·E/size, (rank+1)·E/size)``; their share of
        ``y`` is summed over ``group``."""
        E = self.cfg.n_experts
        if E % size:
            raise ValueError(f"{E} experts do not split over ep={size}")
        per = E // size
        lo = rank * per
        for name in ("w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(getattr(self, name)[lo:lo + per].clone()))
        self.ep_group, self.expert_offset = group, lo

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        params = {"router": self.router, "w_gate": self.w_gate, "w_up": self.w_up,
                  "w_down": self.w_down}
        return moe_mlp(self.cfg, params, x, self.ep_group, self.expert_offset)
