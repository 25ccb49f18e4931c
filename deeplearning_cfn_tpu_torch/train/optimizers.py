"""LAMB and Adafactor with optax's semantics — two optimizers of
``deeplearning_cfn_tpu/train/trainer.py``'s ``_make_optimizer`` (``adamw``
is ``torch.optim.AdamW``).

- ``Lamb``: ``optax.lamb`` (b1 0.9, b2 0.999, eps 1e-6): the bias-corrected
  Adam update plus the masked decay, scaled by the trust ratio
  ``‖p‖ / ‖u‖`` of each leaf (1 where either norm is 0).
- ``Adafactor``: ``optax.adafactor`` at its defaults: second moments
  factored into row and column means for leaves whose two largest dims are
  >= 128, decay ``1 − (t+1)^−0.8``, eps 1e-30, no first moment; the update
  clipped to rms 1 per leaf, times the learning rate, times the leaf's
  parameter rms (floored at 1e-3); then the group's ``weight_decay`` (the
  raw ``weight_decay_rate``) times ``p``.

**Leaves.**  optax works per leaf of the JAX parameter tree, and the JAX
Llama stacks each kind of layer weight into one ``[L, ...]`` leaf.  So the
per-leaf quantities (LAMB's norms, Adafactor's block rms, which dims
Adafactor factors) are taken over a :class:`Leaf`: the parameters that make
up one JAX leaf (``layers.{i}.wq`` for every i), with that leaf's global
shape.  Adafactor's row and column statistics stay per layer, as they are
in JAX, whose factored dims never include the layer axis here.

**Sharded parameters.**  Under FSDP2 a parameter is a ``DTensor`` shard;
under expert parallelism an expert leaf is split over the ``ep`` ranks
(``Leaf.groups``).  Elementwise work runs on the local shard; every
reduction a leaf's statistics need (a norm, an rms, a row or column mean
over a sharded dim) sums the local part and all-reduces it over the groups
the leaf is split across, so the numbers are those of the whole tensors, as
``optax`` computes them on the JAX mesh.  No host synchronisation.

All state, the step count included (``state[p]["step"]``, as
``torch.optim`` keeps it), is tensors on the parameter's device and starts
at zero, and the learning rate is a float or a 0-d device tensor, so a
captured step (``trainer.CapturedSteps``) reads both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6
# optax.adafactor's defaults.
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
ADAFACTOR_EPS = 1e-30
MIN_PARAM_SCALE = 1e-3


@dataclass
class Leaf:
    """One leaf of the JAX parameter tree: ``params`` are its parts (one a
    layer when ``stacked``, along a leading layer axis of ``shape``),
    ``shape`` its global shape, ``groups`` the process groups it is split
    over besides its DTensor sharding."""

    params: list
    shape: tuple
    stacked: bool = False
    groups: tuple = field(default_factory=tuple)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def local_part(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def shard_groups(p: torch.Tensor) -> list[tuple[int, object]]:
    """``(dim, group)`` for each mesh dim a DTensor is sharded over."""
    if not hasattr(p, "placements"):
        return []
    mesh = p.device_mesh
    return [(pl.dim, mesh.get_group(i)) for i, pl in enumerate(p.placements) if pl.is_shard()]


def all_reduce_over(t: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        if dist.get_world_size(g) > 1:
            dist.all_reduce(t, group=g)
    return t


class _LeafOptimizer(torch.optim.Optimizer):
    """Parameter groups carry ``lr`` and ``weight_decay`` (0 for the
    unmasked group); ``leaves`` group the parameters into JAX leaves."""

    def __init__(self, params, lr, leaves: list[Leaf]):
        super().__init__(params, dict(lr=lr, weight_decay=0.0))
        self.leaves = leaves
        self._leaf_of = {id(p): i for i, leaf in enumerate(leaves) for p in leaf.params}
        missing = [p for g in self.param_groups for p in g["params"] if id(p) not in self._leaf_of]
        if missing:
            raise ValueError(f"{len(missing)} parameters belong to no leaf")

    def _leaf_sums(self, per_param: dict[int, torch.Tensor]) -> list[torch.Tensor | None]:
        """For each leaf, the sum over its parts of ``per_param[id(p)]`` (a
        local 0-d f32 sum), all-reduced over the groups the leaf is split
        across: one all-reduce for each distinct set of groups."""
        by_groups: dict[tuple, list[int]] = {}
        local = []
        for i, leaf in enumerate(self.leaves):
            parts = [per_param[id(p)] for p in leaf.params if id(p) in per_param]
            local.append(torch.stack(parts).sum() if parts else None)
            groups = tuple(g for _, g in shard_groups(leaf.params[0])) + tuple(leaf.groups)
            if parts and groups:
                by_groups.setdefault(groups, []).append(i)
        for groups, idx in by_groups.items():
            vec = all_reduce_over(torch.stack([local[i] for i in idx]), groups)
            for j, i in enumerate(idx):
                local[i] = vec[j]
        return local

    def _init_param(self, p) -> None:
        if not self.state[p]:
            lp = local_part(p)
            self.state[p]["step"] = torch.zeros((), dtype=torch.float32, device=lp.device)
            self.state[p].update(self._init(p, lp))

    @torch.no_grad()
    def init_state(self) -> None:
        """Every parameter's state as its first step makes it (zeros): what a
        checkpoint restores into."""
        for group in self.param_groups:
            for p in group["params"]:
                self._init_param(p)

    def _live_groups(self):
        """Per parameter group with a gradient: (group, params, local params,
        local grads, step counts); a parameter's state (``step`` and
        ``_init``'s, all zeros) is made at its first step."""
        out = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            local = [local_part(p) for p in params]
            for p in params:
                self._init_param(p)
            steps = [self.state[p]["step"] for p in params]
            out.append((group, params, local, [local_part(p.grad) for p in params], steps))
        return out


class Lamb(_LeafOptimizer):
    def _init(self, p, lp) -> dict:
        return {"mu": torch.zeros_like(lp), "nu": torch.zeros_like(lp)}

    @torch.no_grad()
    def step(self, closure=None):
        live, updates = self._live_groups(), {}
        for group, params, local, grads, steps in live:
            # optax scale_by_adam, the moments in the parameter dtype.
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_add_(steps, 1.0)
            torch._foreach_mul_(mus, LAMB_B1)
            torch._foreach_add_(mus, grads, alpha=1.0 - LAMB_B1)
            torch._foreach_mul_(nus, LAMB_B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - LAMB_B2)
            bc1 = torch._foreach_pow(LAMB_B1, steps)  # 1 - b1^t after the next two
            torch._foreach_neg_(bc1)
            torch._foreach_add_(bc1, 1.0)
            bc2 = torch._foreach_pow(LAMB_B2, steps)
            torch._foreach_neg_(bc2)
            torch._foreach_add_(bc2, 1.0)
            u = torch._foreach_div(mus, bc1)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, LAMB_EPS)
            torch._foreach_div_(u, den)
            if group["weight_decay"]:  # optax add_decayed_weights under the mask
                torch._foreach_add_(u, local, alpha=group["weight_decay"])
            updates.update({id(p): x for p, x in zip(params, u)})
        # optax scale_by_trust_ratio per leaf, then the learning rate.
        p_sq = self._leaf_sums({id(p): lp.float().square().sum()
                                for _, params, local, *_ in live for p, lp in zip(params, local)})
        u_sq = self._leaf_sums({k: x.float().square().sum() for k, x in updates.items()})
        for leaf, p_s, u_s in zip(self.leaves, p_sq, u_sq):
            if p_s is None:
                continue
            p_n, u_n = p_s.sqrt(), u_s.sqrt()
            ratio = torch.where((p_n == 0) | (u_n == 0), 1.0, p_n / u_n)
            for p in leaf.params:
                if id(p) in updates:
                    updates[id(p)].mul_(ratio.to(updates[id(p)].dtype))
        for group, params, local, _, _ in live:
            torch._foreach_sub_(local, torch._foreach_mul([updates[id(p)] for p in params],
                                                          group["lr"]))


def factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the two largest dims (``numpy.argsort``'s
    order), or None when the second largest is below the threshold."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _mean(x: torch.Tensor, dim: int, size: int, shards: dict[int, object], keepdim=False):
    """The mean over ``dim`` of a local part whose global extent there is
    ``size``: the local sum, all-reduced when ``dim`` is sharded."""
    s = x.sum(dim=dim, keepdim=keepdim)
    if dim in shards:
        all_reduce_over(s, (shards[dim],))
    return s / size


class Adafactor(_LeafOptimizer):
    """A group's ``weight_decay`` is optax's ``weight_decay_rate``, added
    after the learning rate's scaling."""

    def _dims(self, p) -> tuple[int, int] | None:
        """The factored dims of ``p``'s leaf, in ``p``'s own coordinates."""
        leaf = self.leaves[self._leaf_of[id(p)]]
        dims = factored_dims(leaf.shape)
        if dims is None or not leaf.stacked:
            return dims
        if 0 in dims:
            raise NotImplementedError(f"a stacked leaf {leaf.shape} factored over its layer axis")
        return dims[0] - 1, dims[1] - 1

    def _init(self, p, lp) -> dict:
        dims = self._dims(p)
        if dims is None:
            return {"v": torch.zeros_like(lp)}
        d1, d0 = dims
        return {"v_row": torch.zeros_like(lp.select(d0, 0)),
                "v_col": torch.zeros_like(lp.select(d1, 0))}

    @torch.no_grad()
    def step(self, closure=None):
        """Two passes over the parameters, so that no more than one
        parameter's f32 update is alive at a time (at Llama-3-8B the whole
        tree's would be 30 GiB): the first updates the second moments and
        sums each leaf's squared update, the second forms each update again
        from the updated moments (the same arithmetic on the same values)
        and applies it."""
        live = self._live_groups()
        factors, u_parts = {}, {}
        for _, params, _, grads, steps in live:
            powers = torch._foreach_pow(torch._foreach_add(steps, 1.0), -DECAY_RATE)  # (t+1)^-0.8
            torch._foreach_add_(steps, 1.0)
            for p, g, power in zip(params, grads, powers):
                g32 = g.float()
                factors[id(p)] = self._update_moments(p, g32, 1.0 - power)
                u_parts[id(p)] = self._scaled(p, g32, factors[id(p)]).square().sum()
        # Per leaf: clip the update's rms at the threshold, then scale by the
        # learning rate and by the parameter's rms.
        u_sq = self._leaf_sums(u_parts)
        p_sq = self._leaf_sums({id(p): lp.float().square().sum()
                                for _, params, local, *_ in live for p, lp in zip(params, local)})
        scales = {}
        for leaf, u_s, p_s in zip(self.leaves, u_sq, p_sq):
            if u_s is not None:
                clip = torch.clamp((u_s / leaf.numel).sqrt() / CLIPPING_THRESHOLD, min=1.0)
                param_scale = torch.clamp((p_s / leaf.numel).sqrt(), min=MIN_PARAM_SCALE)
                scales.update({id(p): (clip, param_scale) for p in leaf.params})
        for group, params, local, grads, _ in live:
            for p, lp, g in zip(params, local, grads):
                clip, param_scale = scales[id(p)]
                u = self._scaled(p, g.float(), factors[id(p)])
                u = u.div_(clip).mul_(group["lr"]).mul_(param_scale)  # optax's order
                if group["weight_decay"]:
                    u.add_(lp.float(), alpha=group["weight_decay"])
                lp.sub_(u.to(lp.dtype))

    def _update_moments(self, p, g32: torch.Tensor, decay: torch.Tensor):
        """optax ``scale_by_factored_rms``'s state update; returns the row
        and column factors of a factored leaf (O(rows + cols)), else None."""
        st = self.state[p]
        g2 = g32.square() + ADAFACTOR_EPS
        dims = self._dims(p)
        if dims is None:
            st["v"].copy_(decay * st["v"].float() + (1.0 - decay) * g2)
            return None
        d1, d0 = dims
        shards = dict(shard_groups(p))
        shape = p.shape  # global (a DTensor reports its global shape)
        st["v_row"].copy_(decay * st["v_row"].float() + (1.0 - decay) * _mean(g2, d0, shape[d0], shards))
        st["v_col"].copy_(decay * st["v_col"].float() + (1.0 - decay) * _mean(g2, d1, shape[d1], shards))
        v_row, v_col = st["v_row"].float(), st["v_col"].float()
        r1 = d1 - 1 if d1 > d0 else d1  # d1 in v_row's coordinates
        row_shards = {(k - 1 if k > d0 else k): grp for k, grp in shards.items() if k != d0}
        row_col_mean = _mean(v_row, r1, shape[d1], row_shards, keepdim=True)
        return (v_row / row_col_mean).rsqrt(), v_col.rsqrt()

    def _scaled(self, p, g32: torch.Tensor, factors) -> torch.Tensor:
        """``g`` over the root of its second moment."""
        if factors is None:
            return g32 * self.state[p]["v"].float().rsqrt()
        d1, d0 = self._dims(p)
        row_factor, col_factor = factors
        return g32 * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
