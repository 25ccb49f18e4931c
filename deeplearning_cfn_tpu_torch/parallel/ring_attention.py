"""Ring attention — counterpart of ``deeplearning_cfn_tpu/parallel/ring_attention.py``.

Causal attention over a sequence split over the ``sp`` ranks: each rank
holds a ``[B, S/sp, H, D]`` block of q, k and v.  In ``sp`` steps each rank
attends its q block to the k/v block it holds, accumulating the online
softmax (running max, denominator and weighted values), then passes k/v on
to the next rank of the ring.  After step ``t`` rank ``r`` holds block
``(r - t) mod sp``: a block from the future is skipped (it still moves
on), the diagonal block takes the causal mask, a past block none.  No score
matrix larger than ``[S/sp, S/sp]`` is made.

As in JAX it is plain tensor code, with no kernel; the arithmetic is JAX's
``_block_attend`` (scores in the inputs' dtype, then f32; the max and the
denominator in f32; the accumulator in v's dtype).  GQA k/v stay compact
(``Hkv`` heads) through the ring and are expanded a block at a time: the
port's tensor parallelism splits heads only where ``tp`` divides the kv
heads, so every q head's kv head is on its rank.

The ring is point-to-point (``torch.distributed.batch_isend_irecv``) inside
a ``torch.autograd.Function``, since autograd does not differentiate
through ``isend``/``irecv``.  The backward is the FA2 recompute from the
saved log-sum-exp, in f32: k/v go round the ring again, each block's dK/dV
travel with it and take one more hop home at the end.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _expand(kv: torch.Tensor, heads: int) -> torch.Tensor:
    group = heads // kv.shape[2]
    return kv if group == 1 else torch.repeat_interleave(kv, group, dim=2)


def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``group`` and received from the
    previous one."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prev = dist.get_global_rank(group, (rank - 1) % n)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        r = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, r, prev, group)]
        out.append(r)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _diagonal_mask(s: int, device) -> torch.Tensor:
    pos = torch.arange(s, device=device)
    return pos[:, None] >= pos[None, :]


def _block_attend(q, k, v, m, l, acc, mask):
    """One online-softmax step (JAX's ``_block_attend``): q ``[B, Sq, H, D]``,
    k/v ``[B, Sk, H, D]``, m/l ``[B, H, Sq]`` f32, acc ``[B, Sq, H, D]``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    new_m = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - new_m)
    probs = torch.exp(scores - new_m[..., None])
    probs = torch.nan_to_num(probs, nan=0.0)
    new_l = l * correction + probs.sum(dim=-1)
    weighted = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    new_acc = acc * correction.transpose(1, 2)[..., None].to(acc.dtype) + weighted
    return new_m, new_l, new_acc


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool):
        sp, rank = dist.get_world_size(group), dist.get_rank(group)
        B, S, H, D = q.shape
        m = torch.full((B, H, S), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, S, H, D), dtype=v.dtype, device=q.device)
        mask = _diagonal_mask(S, q.device)
        k_cur, v_cur = k, v
        for step in range(sp):
            src = (rank - step) % sp
            if not causal or src <= rank:
                m, l, acc = _block_attend(q, _expand(k_cur, H), _expand(v_cur, H), m, l, acc,
                                          mask if causal and src == rank else None)
            if step < sp - 1:
                k_cur, v_cur = _rotate([k_cur, v_cur], group)
        out = acc / l.transpose(1, 2)[..., None].to(acc.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        sp, rank = dist.get_world_size(group), dist.get_rank(group)
        B, S, H, D = q.shape
        Hkv = k.shape[2]
        f32 = torch.float32
        scale = D**-0.5
        q32, g32 = q.to(f32), g.to(f32)
        delta = (out.to(f32) * g32).sum(-1).transpose(1, 2)  # [B, H, S]
        mask = _diagonal_mask(S, q.device)
        dq = torch.zeros((B, S, H, D), dtype=f32, device=q.device)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros((B, S, Hkv, D), dtype=f32, device=q.device)
        dv_cur = torch.zeros_like(dk_cur)
        for step in range(sp):
            src = (rank - step) % sp
            if not causal or src <= rank:
                kk, vv = _expand(k_cur, H).to(f32), _expand(v_cur, H).to(f32)
                s = torch.einsum("bqhd,bkhd->bhqk", q32, kk) * scale
                p = torch.exp(s - lse[..., None])
                if causal and src == rank:
                    p = p.masked_fill(~mask, 0.0)
                dv = torch.einsum("bhqk,bqhd->bkhd", p, g32)
                dp = torch.einsum("bqhd,bkhd->bhqk", g32, vv)
                ds = p * (dp - delta[..., None]) * scale
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kk)
                dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
                dk_cur = dk_cur + dk.reshape(B, S, Hkv, H // Hkv, D).sum(3)
                dv_cur = dv_cur + dv.reshape(B, S, Hkv, H // Hkv, D).sum(3)
            if step < sp - 1:
                k_cur, v_cur, dk_cur, dv_cur = _rotate([k_cur, v_cur, dk_cur, dv_cur], group)
        if sp > 1:  # rank r holds block r + 1's gradients: one hop home
            dk_cur, dv_cur = _rotate([dk_cur, dv_cur], group)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True) -> torch.Tensor:
    """Causal ring attention over the ranks of ``group`` (the ``sp`` axis):
    q ``[B, S/sp, Hq, D]``, k/v ``[B, S/sp, Hkv, D]`` (``Hkv`` divides
    ``Hq``), this rank's block of the sequence; returns its block of the
    output, ``[B, S/sp, Hq, D]``."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    return _RingAttention.apply(q, k, v, group, bool(causal))
