"""The trainer — counterpart of ``deeplearning_cfn_tpu/train/trainer.py``.

The same ``TrainerConfig`` field names and the same step semantics as the
JAX package's jitted step, in eager PyTorch:

- Optimizers ``adamw``, ``lamb``, ``adafactor`` (``train/optimizers.py``),
  ``sgd`` and ``momentum`` as optax builds them: ``decay_mask`` becomes two
  parameter groups (decay and no decay); the global-norm clip is optax's
  (scale by ``max_norm / norm`` only when ``norm >= max_norm``, no
  epsilon), applied before the update; the learning rate comes from the
  0-based step.  Moments follow the parameter dtype, as optax's do.
  ``adafactor`` decays at ``weight_decay × learning_rate`` (the JAX
  trainer's translation, so ``weight_decay`` means one thing across
  optimizers).  ``sgd`` and ``momentum`` are the port's own :class:`SGD`
  (optax's trace, the decay added to the gradient first).  Every learning
  rate may be a device tensor, so a captured step can read it.
- ``matmul_precision`` (JAX's names) sets PyTorch's f32 matmul precision,
  and cuDNN's TF32 switch, for the trainer's steps only.
- Over a mesh (``parallel/mesh.build_mesh``), each rank takes its slice of
  the global batch over ``("dp", "fsdp")``; ``strategy="dp"`` replicates the
  parameters (DDP over the data ranks), ``"fsdp"`` shards them with FSDP2
  ``fully_shard`` over the fsdp sub-mesh (HSDP over ``("dp", "fsdp")`` when
  dp > 1), one unit per block and one at the root.  A model's explicit
  specs (Llama's ``param_specs``) decide each parameter's fsdp dim, and
  shard whenever fsdp > 1, whatever the strategy, as in the JAX trainer.
  MoE experts split over ``ep``.  Under ``tp`` (``parallel/tensor_parallel.py``)
  every parameter whose spec has a ``tp`` dim becomes a ``DTensor`` split
  over the ``tp`` axis, and FSDP2 shards it over ``fsdp`` on its other
  dim (``shard_placement_fn``): the JAX specs' 2-D layout; what the specs
  replicate over ``tp`` (the norms) gets no tp reduction: every tp rank
  computes the same gradient.  Under ``sp`` each rank takes its block of
  the sequence, and since every parameter is replicated over ``sp`` its
  gradient is summed over the ``sp`` ranks as well as averaged over the
  data ranks.  The loss and every gradient are the global batch's; so are
  the logged metrics.  Inside a step the batch's reductions span the data
  ranks (``parallel/data_ranks.py``): BatchNorm's statistics and the counts
  that losses divide by are the global batch's, as in JAX's GSPMD step.
- The input stage in front of every loss, as the JAX step composes it:
  ``augment`` (train steps only, keyed by the step), then uint8
  ``input_stats`` normalisation (``train.pipeline.dequantize_normalize``).
- Gradient accumulation over strided microbatches ``x[a::k]``: part
  gradients summed into ``.grad`` in place (``AccumulateGrad``: no second
  gradient-sized buffer, where JAX's scan carries one), then divided by
  ``k``.
- ``remat``: ``jax.checkpoint`` on the whole loss becomes
  ``torch.utils.checkpoint`` (non-reentrant) around it, in the eager and
  the captured step alike; it nests under the model's own per-block remat
  (``train/remat.py``: inside it a model checkpoints its blocks whole, so
  that no selective cache is held twice and the peak only falls).
  Buffers a forward updates (BatchNorm's statistics) keep the forward's
  update, not the recomputation's second one.
- The state is updated in place (PyTorch parameters, buffers and optimizer
  state are mutable); ``train_step`` returns the same ``TrainState`` object.
  A model with ``has_train_arg`` is called with ``train=``; its BatchNorm
  statistics move in train steps only.
- With no ``loss_fn``, the default classification objective: softmax
  cross-entropy with ``label_smoothing`` and accuracy.
- ``multi_step_fn(k)``: on the card, ``k`` train steps captured once as one
  CUDA graph and replayed (every optimizer); on the CPU, ``k`` eager steps.
- ``fit`` feeds the steps through ``train.data.DevicePrefetcher``;
  ``fit(profiler=)`` splits each call into the ``obs.profiler`` phases.

- ``TrainState.state_dict`` / ``load_state_dict``: the whole state by
  parameter name, loaded in place; ``fit(checkpointer=, datastream=)``
  saves on the checkpointer's policy (``train/checkpoint.py``), the data
  stream's position with it.

- Pipeline stages (a mesh with ``pp`` > 1 and a model built over it with
  as many stages, ``models/llama.py``): each pp rank holds its stage, the
  model's loss runs GPipe with the backward inside it, and the step then
  sums the gradients of what every stage holds (the embedding, final norm
  and output) over ``pp``.  Over the data ranks of each stage the gradients
  are averaged by the step (no DDP: the schedule calls the stage, not a
  wrapper), or FSDP2 shards the stage's blocks as above.  The global norm
  of the clip and the per-leaf statistics of LAMB and Adafactor span the
  stages.
- ``comms_overlap`` (``parallel/overlap.py``): the data ranks' gradient sync
  runs the buckets of ``plan_buckets`` (``overlap_bucket_bytes``) from
  hooks, each issued as soon as its last gradient exists, in place of DDP's
  (bitwise DDP's step on two ranks); the fsdp-sharded leaves stay FSDP2's.
  ``overlap_compress`` sends each bucket as int8 with an error-feedback
  residual a rank (``TrainState.error_feedback``, saved with the optimizer
  state).  JAX's gates refuse a single data rank, a non-data axis larger
  than 1, a sequence split over sp and a model with buffers.

Without a mesh the trainer runs on one device and ``strategy`` is the
identity.  On the ``meta`` device (``models/llama_memory.trace_check``) a
step traces shapes only, and FSDP2 and DDP, which cannot run on ``meta``,
are left out (the one guard for it, in ``_distribute``): each rank's
parameters keep their fsdp-gathered size.  Live reshard is ported in a
later slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.parallel import mesh as mesh_lib
from deeplearning_cfn_tpu_torch.parallel import overlap as overlap_lib
from deeplearning_cfn_tpu_torch.parallel import sharding
from deeplearning_cfn_tpu_torch.parallel.data_ranks import data_ranks
from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import distribute_tp
from deeplearning_cfn_tpu_torch.train.optimizers import (
    Adafactor,
    Lamb,
    Leaf,
    all_reduce_over,
    local_part,
    shard_groups,
)
from deeplearning_cfn_tpu_torch.train.data import (
    Batch,
    DevicePrefetcher,
    donate_buffers,
    tree_map,
    device_put_batch,
    stack_batches,
)
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger, peak_flops_per_chip
from deeplearning_cfn_tpu_torch.train.pipeline import PipelineStats, dequantize_normalize
from deeplearning_cfn_tpu_torch.train.remat import outer_remat_contexts

_LATER = "a later slice of the PyTorch port"


@dataclass
class TrainerConfig:
    learning_rate: float = 0.01
    has_train_arg: bool = False
    optimizer: str = "momentum"  # sgd | momentum | adamw | lamb | adafactor
    momentum: float = 0.9
    weight_decay: float = 0.0
    strategy: str = "dp"  # dp | fsdp; both the identity without a mesh
    # JAX's names: "float32"/"highest", "tensorfloat32"/"high", "bfloat16";
    # None (or "default") keeps PyTorch's setting.
    matmul_precision: str | None = None
    bf16_compute: bool = False
    remat: bool = False
    input_stats: tuple[tuple[float, ...], tuple[float, ...]] | None = None
    augment: Any | None = None
    grad_clip_norm: float | None = None
    label_smoothing: float = 0.0
    lr_schedule: Callable[[int], float] | None = None
    log_every: int = 10
    grad_accum_steps: int = 1
    comms_overlap: bool = False
    overlap_bucket_bytes: int = 4 * 1024 * 1024
    overlap_compress: bool = False


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    # What a step calls: the DDP wrapper under strategy "dp" over a mesh,
    # else the model itself.
    runner: nn.Module | None = None
    # Parameters split over ranks outside their DTensor layout (experts over
    # ``ep``): name -> the 1-D mesh their dim 0 is split over.
    split: dict[str, Any] = field(default_factory=dict)
    # comms_overlap: the bucketed sync's hooks on this model's parameters,
    # and with overlap_compress the error-feedback residuals it updates.
    grad_sync: overlap_lib.BucketedGradSync | None = None
    error_feedback: overlap_lib.ErrorFeedbackState | None = None
    # The trainer's mesh (the global views of what is split over it).
    mesh: Any = None

    def state_dict(self) -> dict:
        """``{"model": ..., "optimizer": {"state": ...}, "step": ...}`` keyed
        by parameter names (``torch.distributed.checkpoint.state_dict``),
        holding the live tensors, so a load into it writes the state in
        place.  The optimizer's state is created first where a first step
        would create it (:func:`init_optimizer_state`); its hyperparameters
        are the config's and are not saved.  Whatever a rank holds of a
        larger tensor is a ``DTensor`` with its global shape: FSDP2's shards,
        and the optimizer state and experts this rank keeps a part of, so
        a checkpoint restores onto another mesh."""
        from torch.distributed.checkpoint.state_dict import (
            get_model_state_dict,
            get_optimizer_state_dict,
        )

        init_optimizer_state(self.optimizer)
        sd = {"model": get_model_state_dict(self.model),
              "step": torch.tensor(self.step, dtype=torch.int64)}
        if self.optimizer.state:
            osd = get_optimizer_state_dict(self.model, self.optimizer)
            sd["optimizer"] = {"state": osd["state"]}
        _global_views(self, sd)
        if self.error_feedback is not None:
            from torch.distributed.tensor import Shard

            data = mesh_lib.data_mesh(self.mesh)  # a residual's rows are split over it
            sd.setdefault("optimizer", {})["error_feedback"] = {
                str(i): _as_global(r, data, [Shard(0)], (data.size(), r.shape[1]))
                for i, r in enumerate(self.error_feedback.residual)}
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` (what :meth:`state_dict` gives, or on one device the
        whole host tensors ``Checkpointer.restore_raw`` returns) into the
        live tensors.  Every tensor keeps its address, so a CUDA graph
        captured on this state (``CapturedSteps``) replays on the loaded
        one; ``torch.optim.Optimizer.load_state_dict`` would replace them."""
        live = self.state_dict()
        _copy_into(live["model"], sd["model"], "model")
        if "optimizer" in live:
            _copy_into(live["optimizer"], sd["optimizer"], "optimizer")
        self.step = int(sd["step"])


@torch.no_grad()
def init_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Create every parameter's optimizer state where its first step would,
    at the zeros it starts from (nothing for a stateless optimizer).  DCP's
    ``state_dict`` helpers would otherwise make it by a zero-gradient step
    at learning rate 0, which moves the weights of an optimizer whose decay
    is not scaled by the learning rate (Adafactor's)."""
    if isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
        scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        for group in opt.param_groups:
            on_device = group["capturable"] or group["fused"]
            for p in group["params"]:
                st = opt.state[p]
                if st:
                    continue
                st["step"] = (torch.zeros((), dtype=torch.float32 if group["fused"] else scalar,
                                          device=p.device) if on_device
                              else torch.tensor(0.0, dtype=scalar))
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if group["amsgrad"]:
                    st["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    elif hasattr(opt, "init_state"):
        opt.init_state()
    else:
        raise TypeError(f"no state initialiser for {type(opt).__name__}")


def _placements_without(placements, dim: int) -> list:
    """A tensor's placements after ``dim`` is reduced away: a shard on it
    becomes a replica (the reduction all-reduced it), later dims move down."""
    from torch.distributed.tensor import Replicate, Shard

    return [(Replicate() if pl.dim == dim else Shard(pl.dim - (pl.dim > dim)))
            if pl.is_shard() else pl for pl in placements]


def _as_global(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _global_views(state: "TrainState", sd: dict) -> None:
    """Give every tensor of ``sd`` that holds a part of a larger one its
    global view (sharing storage): the LAMB and Adafactor state of an FSDP2
    parameter (local tensors: elementwise state takes the parameter's
    placements, a factored second moment those of the dims it keeps), and
    experts split over ``ep`` with their optimizer state (dim 0 sharded
    over the ep mesh)."""
    from torch.distributed.tensor import Shard

    params = dict(state.model.named_parameters())
    opt_state = sd.get("optimizer", {}).get("state", {})
    dims = getattr(state.optimizer, "_dims", None)
    for name, p in params.items():
        # A copy: the optimizer's own per-parameter dict must keep its tensors.
        st = opt_state[name] = dict(opt_state[name]) if name in opt_state else {}
        if name in state.split:
            ep_mesh = state.split[name]
            sd["model"][name] = _split_global(p.detach(), state, ep_mesh)
            for k, v in st.items():
                if not v.ndim:
                    continue
                if hasattr(p, "device_mesh") and not hasattr(v, "device_mesh"):
                    if v.shape != p.to_local().shape:
                        raise NotImplementedError(
                            f"no global view of the optimizer state {name}.{k}")
                    v = _as_global(v, p.device_mesh, p.placements, p.shape)
                st[k] = _split_global(v, state, ep_mesh)
            continue
        if not hasattr(p, "device_mesh"):
            continue
        for k, v in st.items():
            if not v.ndim or hasattr(v, "device_mesh"):
                continue
            if v.shape == p.to_local().shape:
                st[k] = _as_global(v, p.device_mesh, p.placements, p.shape)
            elif k in ("v_row", "v_col") and dims is not None:
                d1, d0 = dims(p)
                gone = d0 if k == "v_row" else d1
                shape = [s for i, s in enumerate(p.shape) if i != gone]
                st[k] = _as_global(v, p.device_mesh, _placements_without(p.placements, gone), shape)
            else:
                raise NotImplementedError(f"no global view of the optimizer state {name}.{k}")


def _split_global(t: torch.Tensor, state: "TrainState", ep_mesh) -> torch.Tensor:
    """The global view of a tensor split on dim 0 over ``ep_mesh`` (the
    experts): a plain local tensor as Shard(0) over the ep mesh; one that
    FSDP2 also shards over the data ranks (a ``DTensor`` over their mesh) as
    a ``DTensor`` over those axes and ``ep``, Shard(0) on ``ep`` and its own
    placements on the others."""
    from torch.distributed.tensor import Shard

    if not hasattr(t, "device_mesh"):
        return _as_global(t, ep_mesh, [Shard(0)], (t.shape[0] * ep_mesh.size(), *t.shape[1:]))
    names = t.device_mesh.mesh_dim_names
    order = sorted((*names, "ep"), key=mesh_lib.AXIS_ORDER.index)
    placements = [Shard(0) if n == "ep" else t.placements[names.index(n)] for n in order]
    shape = (t.shape[0] * ep_mesh.size(), *t.shape[1:])
    return _as_global(t.to_local(), state.mesh[tuple(order)], placements, shape)


def _copy_into(dst: Any, src: Any, path: str) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same structure and
    layout), skipping those that already share storage (DCP loaded them in
    place)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            if k not in src:
                raise KeyError(f"{path}.{k} is missing from the state to load")
            _copy_into(v, src[k], f"{path}.{k}")
        return
    if not isinstance(dst, torch.Tensor):
        return
    d, s = local_part(dst), local_part(src)
    if d.data_ptr() == s.data_ptr() and d.device == s.device:
        return
    if tuple(d.shape) != tuple(s.shape):
        raise ValueError(f"{path}: shape {tuple(s.shape)} does not fit {tuple(d.shape)}")
    d.copy_(s)


_EXCLUDED = ("norm", "bias", "scale")


def decay_mask(named_parameters) -> dict[str, bool]:
    """Which parameters take weight decay: not those whose leaf name (the
    last '.'-component) is, or ends in '_' + one of, norm/bias/scale, and
    nothing of rank <= 1.  The name match is anchored, never a substring
    test ('normalizer_proj' decays)."""
    mask = {}
    for name, p in named_parameters:
        leaf = name.rsplit(".", 1)[-1].lower()
        if leaf in _EXCLUDED or leaf.rsplit("_", 1)[-1] in _EXCLUDED:
            mask[name] = False
        else:
            mask[name] = p.ndim > 1
    return mask


def _param_groups(model: nn.Module, weight_decay: float) -> list[dict]:
    named = list(model.named_parameters())
    mask = decay_mask(named)
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    return [g for g in groups if g["params"]]


class SGD(torch.optim.Optimizer):
    """optax's ``sgd(lr, momentum, nesterov)`` behind ``add_decayed_weights``:
    ``g += weight_decay·p``; with momentum ``t = momentum·t + g`` (t starts
    at zero) and the update ``g + momentum·t`` (Nesterov) or ``t``; then
    ``p -= lr·update``.  ``lr`` is a float or a 0-d device tensor, read the
    same way (a captured step reads the tensor).  Foreach ops, no host
    synchronisation."""

    def __init__(self, params, lr, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def init_state(self) -> None:
        """Create the momentum buffers (zeros, as optax's trace starts)."""
        for group in self.param_groups:
            if group["momentum"]:
                for p in group["params"]:
                    if "momentum_buffer" not in self.state[p]:
                        self.state[p]["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            m = group["momentum"]
            if m:
                trace = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(trace, m)
                torch._foreach_add_(trace, grads)
                updates = torch._foreach_add(grads, trace, alpha=m) if group["nesterov"] else trace
            else:
                updates = grads
            torch._foreach_sub_(params, torch._foreach_mul(updates, group["lr"]))


def _make_optimizer(model: nn.Module, cfg: TrainerConfig,
                    leaves: list[Leaf]) -> torch.optim.Optimizer:
    """``leaves`` (the JAX tree's, ``Trainer._leaves``) for the per-leaf
    optimizers.  On the card AdamW is capturable, with or without a mesh:
    its step count stays on the device, it reads a device learning rate (a
    CUDA graph's), and every path runs one arithmetic."""
    lr = cfg.learning_rate
    groups = _param_groups(model, cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 capturable=next(model.parameters()).is_cuda)
    if cfg.optimizer == "lamb":
        return Lamb(groups, lr, leaves)
    if cfg.optimizer == "adafactor":
        # optax.adafactor decays by weight_decay_rate raw (after the lr
        # scaling); adamw by lr·wd.  The rate is wd at the base lr, so one
        # config value means one effective decay across optimizers.
        return Adafactor(_param_groups(model, cfg.weight_decay * lr), lr, leaves)
    if cfg.optimizer == "sgd":
        # L2 decay joins the gradient before the update, on the decay group.
        return SGD(groups, lr=lr)
    if cfg.optimizer == "momentum":
        return SGD(groups, lr=lr, momentum=cfg.momentum, nesterov=True)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@torch.no_grad()
def clip_by_global_norm(parameters, max_norm: float,
                        split_groups: dict[int, tuple] | None = None) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients: ``g / norm * max_norm``
    when ``norm >= max_norm``, untouched otherwise.  Returns the norm.

    The norm is that of the whole gradient tree: a DTensor gradient (FSDP2)
    contributes its local shard, summed over the groups it is sharded on,
    and a gradient split over other ranks (MoE experts over ``ep``:
    ``split_groups[id(param)]``) is summed over those.  One all-reduce for
    each distinct set of groups; no host sync: the choice is made on the
    device."""
    split_groups = split_groups or {}
    sums: dict[tuple, list[torch.Tensor]] = {}
    grads = []
    for p in parameters:
        if p.grad is None:
            continue
        g = local_part(p.grad)
        grads.append(g)
        groups = tuple(grp for _, grp in shard_groups(p.grad)) + tuple(split_groups.get(id(p), ()))
        sums.setdefault(groups, []).append(g.to(torch.float32).square().sum())
    if not grads:
        return torch.zeros(())
    total = []
    for groups, parts in sums.items():
        total.append(all_reduce_over(torch.stack(parts).sum(), groups))
    norm = torch.sqrt(torch.stack(total).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


# JAX's precision names -> torch.set_float32_matmul_precision's.
_PRECISION = {"float32": "highest", "highest": "highest", "tensorfloat32": "high",
              "high": "high", "bfloat16": "medium"}


@contextlib.contextmanager
def matmul_precision(name: str | None):
    """f32 matmul precision (and cuDNN's TF32 switch) for the block only;
    None or "default" leaves PyTorch's settings."""
    if name is None or name == "default":
        yield
        return
    if name not in _PRECISION:
        raise ValueError(f"unknown matmul_precision {name!r}")
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = _PRECISION[name] != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


def _check_config(cfg: TrainerConfig) -> None:
    if cfg.strategy not in ("dp", "fsdp"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of integer labels, the log-softmax in f32.  With
    ``smoothing`` the target is ``onehot·(1 − s) + s/classes``, formed in
    the logits' dtype, as the JAX package forms it."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if not smoothing:
        return -torch.gather(logp, -1, labels.long()[..., None]).mean()
    num_classes = logits.shape[-1]
    # scatter_, not F.one_hot: the same one-hot, with no host sync (capturable).
    onehot = torch.zeros_like(logits).scatter_(-1, labels.long()[..., None], 1.0)
    onehot = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -torch.mean(torch.sum(onehot.to(torch.float32) * logp, dim=-1))


class Trainer:
    """Runs ``loss_fn(model, x, y) -> (loss, aux)`` steps (the default
    classification objective when no ``loss_fn`` is given), on one device
    or, with ``mesh``, on this rank's share of the mesh.

    ``model_fn(generator)`` builds the model (its weights drawn from the
    generator); ``analytic_flops_fn(x)`` gives the training FLOPs of one
    step on batch ``x``, the MFU numerator (``models.resnet.train_flops``
    counts them with ``FlopCounterMode``).  ``param_specs`` maps parameter
    names to their specs over the mesh axes (``parallel/sharding.py``);
    without them the FSDP rule picks each fsdp dim."""

    def __init__(
        self,
        model_fn: Callable[[torch.Generator], nn.Module],
        config: TrainerConfig,
        loss_fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], tuple[torch.Tensor, dict]]
        | None = None,
        device: torch.device | str | None = None,
        analytic_flops_fn: Callable[[Any], float] | None = None,
        mesh=None,
        param_specs: dict[str, tuple] | None = None,
    ):
        _check_config(config)
        self.model_fn = model_fn
        self.config = config
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.analytic_flops_fn = analytic_flops_fn
        self.mesh = mesh
        self.param_specs = param_specs
        self._split_groups: dict[int, tuple] = {}
        self._replicated: list[nn.Parameter] = []  # outside FSDP2, synced by the step
        self._sp_index, self._sp_count, self._sp_group = 0, 1, None
        self._pp_group = None
        self._stage_params: set[int] = set()  # a pp rank's own blocks
        self._pp_replicated: list[nn.Parameter] = []  # held by every pp rank
        self._sync_axes: tuple[str, ...] = ()
        if config.comms_overlap and mesh is None:
            overlap_lib.check_sync(overlap_lib.BucketPlan((), 0, 1), overlap_lib.SYNC_AXES, 1,
                                   config.grad_accum_steps)
        if mesh is not None:
            sizes = mesh_lib.mesh_spec(mesh)
            self._data_index, self._data_count = mesh_lib.data_rank(mesh)
            self._data_group = mesh_lib.data_group(mesh)
            self._sizes = sizes
            if sizes.sp > 1:
                self._sp_index, self._sp_count = mesh_lib.axis_rank(mesh, "sp"), sizes.sp
                self._sp_group = mesh.get_group("sp")
            if sizes.pp > 1:
                self._pp_group = mesh.get_group("pp")
            if config.comms_overlap:
                batch_spec = (("dp", "fsdp"),) + (("sp",) if sizes.sp > 1 else ())
                self._sync_axes = overlap_lib._resolve_sync_axes(batch_spec, sizes.axis_sizes())
        # Set by fit(): seconds from fit entry to the first completed step,
        # the perf_counter stamp of that completion, and the input
        # pipeline's counters.
        self.first_step_seconds: float | None = None
        self.first_step_at: float | None = None
        self.last_pipeline_stats: PipelineStats | None = None
        # Set by fit(): the last eager step's metrics (device tensors).
        self.last_metrics: dict | None = None
        self._input_stats: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def init(self, seed: int = 0, draw_on_device: bool = False) -> TrainState:
        """Build the model from ``seed`` on the trainer's device, lay it out
        over the mesh (when there is one), and build its optimizer.  The
        weights are drawn on the CPU (one seed, the same weights on any
        device), or with ``draw_on_device`` on the trainer's device: at
        Llama-3-8B the CPU's draw of 8 B normals takes minutes."""
        gen = torch.Generator(self.device if draw_on_device else "cpu").manual_seed(seed)
        return self.init_from(self.model_fn(gen).to(self.device))

    def init_from(self, model: nn.Module) -> TrainState:
        """Lay a model built on the trainer's device out over the mesh (when
        there is one) and build its optimizer: :meth:`init` from a model
        made elsewhere (shapes on ``meta``: ``models/llama_memory.trace_check``)."""
        if self._pp_group is not None:
            if not getattr(model, "pipelined", False):
                raise ValueError("a mesh with pp > 1 needs a model built over it with as many "
                                 "pipeline stages (LlamaConfig.pp_stages)")
            if self.config.remat:
                raise NotImplementedError(
                    f"TrainerConfig.remat over pipeline stages is ported in {_LATER}")
        runner = self._distribute(model) if self.mesh is not None else None
        split = {n: self.mesh["ep"] for n, p in model.named_parameters()
                 if id(p) in self._split_groups}
        opt = _make_optimizer(model, self.config, self._leaves(model))
        state = TrainState(step=0, model=model, runner=runner, split=split, optimizer=opt,
                           mesh=self.mesh)
        if self.config.comms_overlap:
            self._attach_overlap(state)
        return state

    def _attach_overlap(self, state: TrainState) -> None:
        """The bucketed sync over the data ranks: the plan over the JAX
        tree of the model's leaves (a leaf is sharded where FSDP2 holds its
        parameters), the hooks on the fused buckets' parameters (first set
        to the first data rank's values, as DDP sets them), and with
        ``overlap_compress`` a zero residual row a fused bucket."""
        model = state.model
        overlap_lib.check_stateless([n for n, _ in model.named_buffers()])
        plan, members = self._bucket_plan(model)
        overlap_lib.check_sync(plan, self._sync_axes, self._data_count,
                               self.config.grad_accum_steps)
        # As DDP does at construction: what the buckets sync starts as the
        # first data rank's, whatever each rank drew.
        src = dist.get_global_rank(self._data_group, 0)
        with torch.no_grad():
            for p in self._replicated:
                dist.broadcast(p.data, src=src, group=self._data_group)
        if self.config.overlap_compress:
            state.error_feedback = overlap_lib.init_error_feedback(
                plan, self._data_count, state.optimizer, rows=1,
                device=next(model.parameters()).device)
        state.grad_sync = overlap_lib.BucketedGradSync(members, self._data_group,
                                                      self._data_count, state.error_feedback)
        self.bucket_plan = plan

    def _bucket_plan(self, model: nn.Module):
        """``(plan, members)``: :func:`overlap.plan_buckets` over the model's
        JAX leaves (``layers.wq`` as the tree's ``['layers']['wq']``), a
        leaf's spec naming ``fsdp`` on its dim that FSDP2 shards here;
        ``members[i]`` the parameters of fused bucket ``i`` in its flat
        order."""
        replicated = {id(p) for p in self._replicated}
        tree, specs, by_path = {}, {}, {}
        for key, leaf in self._leaf_items(model):
            p = leaf.params[0]
            *scopes, last = key.split(".")
            node, snode = tree, specs
            for k in scopes:
                node, snode = node.setdefault(k, {}), snode.setdefault(k, {})
            spec = [None] * len(leaf.shape)
            if hasattr(p, "placements") and id(p) not in replicated:
                d = next(pl.dim for pl in p.placements if pl.is_shard())
                spec[d + leaf.stacked] = "fsdp"
            node[last] = torch.empty(leaf.shape, dtype=p.dtype, device="meta")
            snode[last] = tuple(spec)
            by_path["".join(f"[{k!r}]" for k in key.split("."))] = leaf
        plan = overlap_lib.plan_buckets(tree, specs, self.config.overlap_bucket_bytes)
        flat = [by_path[path] for path, _ in overlap_lib.flatten_with_path(tree)]
        members = [[p for i in b.indices for p in flat[i].params] for b in plan.fused]
        return plan, members

    # --- the layout over the mesh -------------------------------------------
    def _specs(self, model: nn.Module) -> dict[str, tuple]:
        """Each parameter's spec: the model's explicit one, else the FSDP
        rule on its shape."""
        fsdp = self._sizes.fsdp if self.mesh is not None else 1
        specs = {}
        for name, p in model.named_parameters():
            if self.param_specs is not None and name in self.param_specs:
                specs[name] = self.param_specs[name]
            elif self.config.strategy == "fsdp":
                specs[name] = sharding.fsdp_spec_for_shape(p.shape, fsdp)
            else:
                specs[name] = (None,) * p.ndim
        return specs

    def _distribute(self, model: nn.Module) -> nn.Module | None:
        """Split the experts over ``ep`` and the tp dims over ``tp``, then
        shard (FSDP2) or replicate (DDP) over the data ranks.  Returns the DDP
        wrapper, or None: under pipeline stages or comms_overlap there is no
        DDP, and the step syncs what FSDP2 does not hold."""
        runner = self._layout(model)
        if self._pp_group is not None:
            stage = {n for n, _ in model.named_parameters() if not model.replicated_over_pp(n)}
            self._stage_params = {id(p) for n, p in model.named_parameters() if n in stage}
            self._pp_replicated = [p for n, p in model.named_parameters() if n not in stage]
        return runner

    def _layout(self, model: nn.Module) -> nn.Module | None:
        sizes = self._sizes
        if sizes.ep > 1:
            ep_rank, ep_group = mesh_lib.axis_rank(self.mesh, "ep"), self.mesh.get_group("ep")
            for module in model.modules():
                if hasattr(module, "shard_experts"):
                    module.shard_experts(ep_rank, sizes.ep, ep_group)
        specs = self._specs(model)
        for name, p in model.named_parameters():
            if sharding.axis_dim(specs[name], "ep") is not None and sizes.ep > 1:
                self._split_groups[id(p)] = (self.mesh.get_group("ep"),)
        if sizes.tp > 1:
            distribute_tp(model, specs, self.mesh["tp"])
        if self.device.type == "meta":
            return None  # a shapes-only trace: FSDP2 and DDP need real tensors
        sharded = any(sharding.fsdp_dim(s) is not None for s in specs.values())
        if self.config.strategy == "fsdp" or (sharded and sizes.fsdp > 1) or sizes.tp > 1:
            from torch.distributed.fsdp import fully_shard

            dmesh = self.mesh["dp", "fsdp"] if sizes.dp > 1 else self.mesh["fsdp"]
            by_id = {id(p): specs[n] for n, p in model.named_parameters()}
            # What the specs replicate (norms, the router, arrays the rule
            # leaves whole) stays out of FSDP2: whole on every rank, its
            # gradient averaged over the data ranks by the step.  (FSDP2 would
            # shard every parameter of a unit, and needs one dtype a unit,
            # while the norms and the router are f32 in a bf16 model.)
            self._replicated = [p for n, p in model.named_parameters()
                                if sharding.fsdp_dim(specs[n]) is None]
            fn = sharding.placement_fn(by_id)
            ignored = set(self._replicated)
            units = model.blocks() if hasattr(model, "blocks") else getattr(model, "layers", [])
            for unit in units:
                fully_shard(unit, mesh=dmesh, shard_placement_fn=fn, ignored_params=ignored)
            fully_shard(model, mesh=dmesh, shard_placement_fn=fn, ignored_params=ignored)
            # FSDP2 made new (DTensor) parameters: key the split groups anew.
            old = {n: self._split_groups.get(i) for n, i in zip(specs, by_id)}
            self._split_groups = {id(p): old[n] for n, p in model.named_parameters() if old[n]}
            return None
        if self._pp_group is not None or self.config.comms_overlap:
            # The schedule calls the stage itself, and the bucketed sync
            # runs its own hooks: no wrapper; the step syncs every gradient.
            self._replicated = list(model.parameters())
            return None
        from torch.nn.parallel import DistributedDataParallel as DDP

        return DDP(model, process_group=self._data_group,
                   device_ids=[self.device.index] if self.device.type == "cuda" else None)

    def _leaves(self, model: nn.Module) -> list[Leaf]:
        return [leaf for _, leaf in self._leaf_items(model)]

    def _leaf_items(self, model: nn.Module) -> list[tuple[str, Leaf]]:
        """The JAX parameter tree's leaves over the model's parameters, by
        key: a model whose ``stacked_layers`` is set (Llama) stacks
        ``layers.{i}.<name>`` into one ``[L, ...]`` leaf ``layers.<name>``,
        as the JAX model does; experts split over ``ep`` count at their
        global size, and a pp rank's blocks as a part of the leaf that spans
        the stages (split over the pp group)."""
        stacked = getattr(model, "stacked_layers", False)
        groups: dict[str, list] = {}
        for name, p in model.named_parameters():
            key = re.sub(r"(^|\.)layers\.\d+\.", r"\1layers.", name) if stacked else name
            groups.setdefault(key, []).append(p)
        items = []
        for key, params in groups.items():
            p = params[0]
            split = self._split_groups.get(id(p), ())
            shape = list(p.shape)
            for g in split:
                shape[0] *= dist.get_world_size(g)  # the expert axis
            is_stacked = stacked and key.startswith("layers.")
            n_layers = len(params)
            if id(p) in self._stage_params:
                n_layers *= dist.get_world_size(self._pp_group)
                split = (*split, self._pp_group)
            leaf_shape = (n_layers, *shape) if is_stacked else tuple(shape)
            items.append((key, Leaf(params, tuple(leaf_shape), is_stacked, split)))
        return items

    def _local_batch(self, t):
        """This rank's contiguous slice of a global batch, and under ``sp``
        its block of the sequence (no mesh: all)."""
        if self.mesh is None:
            return t
        return tree_map(lambda a: sharding.local_batch(a, self._data_index, self._data_count,
                                                       self._sp_index, self._sp_count), t)

    def _sync_replicated_grads(self) -> None:
        """Average the gradients of the parameters FSDP2 does not hold over
        the data ranks: one all-reduce a dtype."""
        if not self._replicated or self._data_count == 1:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for p in self._replicated:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self._data_group)
            flat /= self._data_count
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def _sum_grads_over_sp(self, model: nn.Module) -> None:
        """Sum every gradient over the ``sp`` ranks (each rank's holds the
        part of its block of the sequence): one all-reduce a dtype."""
        if self._sp_group is None:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for p in model.parameters():
            if p.grad is not None:
                g = local_part(p.grad)
                by_dtype.setdefault(g.dtype, []).append(g)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self._sp_group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def _sum_grads_over_pp(self) -> None:
        """Sum the gradients of what every pp rank holds (the embedding, the
        final norm, the output) over the pp ranks: the tied embedding's
        lookup part from stage 0 and its logits part from the last stage,
        as GSPMD sums them in JAX.  A rank whose stage left one without a
        gradient contributes zeros.  One all-reduce a dtype."""
        if self._pp_group is None:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for p in self._pp_replicated:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = local_part(p.grad)
            by_dtype.setdefault(g.dtype, []).append(g)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self._pp_group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def _clip_groups(self) -> dict[int, tuple]:
        """The groups each parameter's gradient is split over besides its
        DTensor sharding, for the global norm: the experts' ep, and a pp
        rank's blocks' pp."""
        if self._pp_group is None:
            return self._split_groups
        groups = dict(self._split_groups)
        for i in self._stage_params:
            groups[i] = (*groups.get(i, ()), self._pp_group)
        return groups

    def _data_ranks(self):
        """The block's batch reductions span the data ranks
        (``parallel/data_ranks.py``): BatchNorm's statistics and the counts
        that losses divide by are the global batch's, as in JAX's step."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return data_ranks(self._data_group, self._data_count)

    def _global_metrics(self, loss: torch.Tensor, aux: dict) -> tuple[torch.Tensor, dict]:
        """The metrics' means over the data ranks (one all-reduce; the ranks
        hold equal shares of the batch, and a count-normalised metric is
        divided by the global count over the ranks, so its mean is the
        global quotient)."""
        if self.mesh is None or self._data_count == 1:
            return loss, aux
        keys = list(aux)
        vec = torch.stack([loss.float()] + [aux[k].float() for k in keys])
        dist.all_reduce(vec, group=self._data_group)
        vec = vec / self._data_count
        return vec[0], {k: vec[i + 1] for i, k in enumerate(keys)}

    # --- the input stage and the objective ---------------------------------
    def _normalize_input(self, x):
        """uint8 images -> normalised f32 (``config.input_stats``); other
        inputs pass as they are."""
        stats = self.config.input_stats
        if stats is None or not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
            return x
        # The (mean, std) tensors are made once per device, outside any
        # graph capture (a host-to-device copy cannot be captured).
        if x.device not in self._input_stats:
            self._input_stats[x.device] = tuple(
                torch.tensor(v, dtype=torch.float32, device=x.device) for v in stats)
        return dequantize_normalize(x, *self._input_stats[x.device])

    def _prepare(self, step: int, x, train: bool, decisions=None):
        """The input stage of a step: augmentation (train steps only; from
        ``decisions`` when given, else drawn for ``step``), then
        normalisation."""
        augment = self.config.augment
        if train and augment is not None:
            x = augment(step, x) if decisions is None else augment.apply(x, *decisions)
        return self._normalize_input(x)

    def _default_objective(self, model: nn.Module, x, y, train: bool):
        """Softmax cross-entropy (with ``label_smoothing``) and accuracy;
        eval (``train=False``) reads BatchNorm's running statistics."""
        x = self._normalize_input(x)
        if self.config.bf16_compute:
            x = x.to(torch.bfloat16)
        logits = model(x, train=train) if self.config.has_train_arg else model(x)
        loss = softmax_xent(logits, y, self.config.label_smoothing)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return loss, {"accuracy": acc}

    def _loss(self, model: nn.Module, x, y, train: bool = True):
        if self.loss_fn is not None:
            return self.loss_fn(model, x, y)
        return self._default_objective(model, x, y, train)

    def _backward(self, model: nn.Module, x, y, sync=None) -> tuple[torch.Tensor, dict]:
        """The loss and its backward; with ``remat`` the loss's activations
        are recomputed in the backward (``jax.checkpoint`` on the loss), and
        the buffers keep what the forward made of them.  A pipelined model's
        loss runs the backward in its schedule.  ``sync`` (the bucketed
        sync) issues its buckets from the backward and is drained after it,
        as DDP drains its own."""
        if sync is not None:
            sync.begin()
        if not self.config.remat:
            loss, aux = self._loss(model, x, y)
            if not getattr(model, "runs_own_backward", False):
                loss.backward()
            if sync is not None:
                sync.finish()
            return loss, aux
        loss, aux = checkpoint(self._loss, model, x, y, use_reentrant=False,
                               context_fn=outer_remat_contexts)
        after_forward = [b.detach().clone() for b in model.buffers()]
        loss.backward()
        if sync is not None:
            sync.finish()
        with torch.no_grad():
            for b, kept in zip(model.buffers(), after_forward):
                b.copy_(kept)
        return loss, aux

    def _grads(self, model: nn.Module, x, y, sync=None) -> tuple[torch.Tensor, dict]:
        accum = self.config.grad_accum_steps
        if accum == 1:
            loss, aux = self._backward(model, x, y, sync)
            return loss.detach(), {k: v.detach() for k, v in aux.items()}
        n = x.shape[0]
        if n % accum:
            raise ValueError(f"batch axis {n} not divisible by grad_accum_steps={accum}")
        losses, auxes = [], []
        for a in range(accum):
            part = lambda t: t[a::accum]  # noqa: E731
            # .grad sums the part gradients in place.
            loss, aux = self._backward(model, tree_map(part, x), tree_map(part, y), sync)
            losses.append(loss.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        aux = {k: torch.stack([d[k] for d in auxes]).mean() for k in auxes[0]}
        return torch.stack(losses).mean(), aux

    def _update(self, state: TrainState, x, y, lr, decisions=None):
        """One optimizer update at learning rate ``lr`` (a float, or a device
        tensor in a captured step) on this rank's share of the global batch
        ``x``, ``y``; returns the global batch's loss and aux metrics."""
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        x, y = self._local_batch(x), self._local_batch(y)
        x = self._prepare(state.step, x, train=True, decisions=decisions)
        with matmul_precision(self.config.matmul_precision):
            with self._data_ranks():
                loss, aux = self._grads(state.runner or model, x, y, state.grad_sync)
            if state.grad_sync is None:
                self._sync_replicated_grads()
            self._sum_grads_over_pp()
            self._sum_grads_over_sp(model)
            if self.config.grad_clip_norm:
                clip_by_global_norm(model.parameters(), self.config.grad_clip_norm,
                                    self._clip_groups())
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        return self._global_metrics(loss, aux)

    def _lr(self, step: int) -> float:
        cfg = self.config
        return cfg.lr_schedule(step) if cfg.lr_schedule is not None else cfg.learning_rate

    # --- steps -------------------------------------------------------------
    def train_step(self, state: TrainState, x, y):
        """One optimizer update; returns ``(state, metrics)`` with the metrics
        as device tensors (no host sync)."""
        loss, aux = self._update(state, x, y, self._lr(state.step))
        state.step += 1
        return state, {"loss": loss, **aux}

    @torch.no_grad()
    def eval_step(self, state: TrainState, x, y) -> dict:
        """The no-gradient eval step: the model in eval mode (BatchNorm on its
        running statistics, nothing updated), uint8 inputs normalised, no
        augmentation; returns the metrics as device tensors."""
        model = state.model
        model.eval()
        x, y = self._local_batch(x), self._local_batch(y)
        try:
            with matmul_precision(self.config.matmul_precision), self._data_ranks():
                loss, aux = self._loss(state.runner or model, self._normalize_input(x), y,
                                       train=False)
        finally:
            model.train()
        loss, aux = self._global_metrics(loss, aux)
        return {"loss": loss, **aux}

    def multi_step_fn(self, k: int):
        """``fn(state, xs [k, B, ...], ys [k, B, ...]) -> (state, losses [k])``:
        ``k`` consecutive train steps, the inputs stacked on a leading axis
        (``train.data.stack_batches``).  On the card the ``k`` steps are
        captured once as one CUDA graph (:class:`CapturedSteps`) and replayed
        at each call; on the CPU they run eagerly."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self.device.type == "cuda":
            return CapturedSteps(self, k)

        def k_steps(state: TrainState, xs, ys):
            xs, ys = device_put_batch(Batch(x=xs, y=ys), self.device)
            losses = []
            for i in range(k):
                state, metrics = self.train_step(
                    state, tree_map(lambda t: t[i], xs), tree_map(lambda t: t[i], ys))
                losses.append(metrics["loss"])
            return state, torch.stack(losses)

        return k_steps

    # --- loops ---------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        batches,
        steps: int,
        logger: ThroughputLogger | None = None,
        checkpointer: Any = None,
        stop_fn: Callable[[dict], bool] | None = None,
        prefetch: int = 2,
        prefetch_workers: int = 1,
        reshard: Any = None,
        profiler: Any = None,
        steps_per_call: int = 1,
        datastream: Any = None,
    ) -> tuple[TrainState, list[float]]:
        """Train on at most ``steps`` batches.  Losses are read back to the
        host each time the step count passes a multiple of
        ``config.log_every`` (and at the end), not per step.  There, and after
        the last call, ``stop_fn(metrics)`` (the last call's metrics; a
        stacked call's are its last loss) ends the run when it returns True:
        the time-to-accuracy mode, stopping at ``log_every`` granularity.
        ``prefetch`` > 0
        copies batches to the device on ``prefetch_workers`` producer
        threads, ``prefetch`` batches ahead (0: inline copies); the counters
        land on ``self.last_pipeline_stats``.  ``steps_per_call`` = k > 1
        stacks k batches a call and runs them through ``multi_step_fn(k)``;
        the ``steps % k`` remainder runs one step a call, in the same loop.
        A stacked call's batch is freed once the call is dispatched
        (``train.data.donate_buffers``).

        After each call, ``checkpointer.should_save(state.step)`` decides a
        save at the state's true step (a restored run continues the count);
        with ``datastream`` (a ``train.datastream.HostShardStream``) the
        stream's position rides the save when the checkpointer
        ``accepts_stream_state``.  ``profiler`` (an ``obs.profiler.StepProfiler``)
        splits each call into ``data_wait`` (the pull from the prefetcher or
        the source), ``h2d`` (the copy, or the prefetcher's hand-off of a
        batch already on the card; its producers' copies fold as overlapped),
        ``dispatch`` (the step call), ``compute`` (the wait at the loss
        readback, spread over the steps it drains) and ``host`` (the rest),
        one ``step_done`` a call.  ``reshard`` (live reshard, slice 7) is a
        later slice's."""
        from deeplearning_cfn_tpu_torch.obs.profiler import NULL_PROFILER

        if reshard is not None:
            raise NotImplementedError(f"fit(reshard) is ported in {_LATER}")
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        k = steps_per_call
        stacked = steps // k if k > 1 else 0  # calls of k steps, first
        batches = itertools.islice(batches, steps)
        if stacked:
            kfn = self.multi_step_fn(k)
            batches = itertools.chain(stack_batches(itertools.islice(batches, stacked * k), k),
                                      batches)
        last_call = stacked + steps - stacked * k - 1
        losses: list[float] = []
        pending: list[torch.Tensor] = []
        sync_every = max(1, int(self.config.log_every))
        prof = profiler if profiler is not None else NULL_PROFILER
        t_fit = time.perf_counter()
        batches, prefetcher = self._pipeline(batches, prefetch, prefetch_workers,
                                             profiler=profiler)
        # data_wait: the pull from the prefetcher (a full buffer reads as
        # no wait) or from the source itself.
        batches = prof.wrap_source(batches)
        prof.start()
        try:
            for i, batch in enumerate(batches):
                with prof.phase("h2d"):
                    x, y = device_put_batch(batch, self.device)
                before = state.step
                with prof.phase("dispatch"):
                    if i < stacked:
                        state, loss = kfn(state, x, y)
                        metrics = {"loss": loss[-1]}
                        # The stack was made by stack_batches and placed
                        # here or by the prefetcher: ours to free.
                        donate_buffers((x, y))
                    else:
                        state, metrics = self.train_step(state, x, y)
                        self.last_metrics = metrics
                        loss = metrics["loss"][None]
                pending.append(loss)
                if i == 0:
                    with prof.sync_boundary():
                        float(loss[-1])  # waits for the first call
                    self.first_step_seconds = time.perf_counter() - t_fit
                    self.first_step_at = time.perf_counter()
                if logger:
                    logger.step(state.step, loss[-1])
                if checkpointer is not None and checkpointer.should_save(state.step):
                    self._save_checkpoint(checkpointer, state.step, state, datastream)
                if state.step // sync_every > before // sync_every or i == last_call:
                    # The readback is where the device's time shows: the
                    # wait is spread over the steps it drains.
                    with prof.sync_boundary(sum(len(p) for p in pending)):
                        losses.extend(torch.cat(pending).tolist())
                    pending.clear()
                    if stop_fn is not None and stop_fn(metrics):
                        break
                prof.step_done(step=state.step, steps=state.step - before)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if pending:
            losses.extend(torch.cat(pending).tolist())
        return state, losses

    def _save_checkpoint(self, checkpointer: Any, step: int, state: TrainState,
                         datastream: Any) -> None:
        """One checkpoint save, with the data plane's position attached
        when both sides support it.  With ``prefetch > 0`` the stream's
        host-side cursor can run up to ``prefetch + 1`` batches ahead of
        the trained step (the buffer was filled ahead); runs that need
        bit-exact stream resume use ``prefetch=0``."""
        if datastream is not None and getattr(checkpointer, "accepts_stream_state", False):
            stream_state = datastream.stream_state()
            if hasattr(stream_state, "to_json"):
                stream_state = stream_state.to_json()
            checkpointer.save(step, state, stream_state=stream_state)
        else:
            checkpointer.save(step, state)

    def _pipeline(self, batches, prefetch: int, workers: int, name: str = "fit",
                  profiler=None):
        """``batches`` behind a DevicePrefetcher when ``prefetch`` > 0."""
        self.last_pipeline_stats = stats = PipelineStats(name=name)
        if prefetch <= 0:
            return batches, None
        prefetcher = DevicePrefetcher(batches, self.device, prefetch, workers=workers, stats=stats,
                                      profiler=profiler)
        return prefetcher, prefetcher

    def evaluate(self, state: TrainState, batches, steps: int | None = None) -> dict:
        """Example-weighted mean of the eval step's metrics over the batches,
        plus ``examples``; one readback at the end.  Batches are prefetched
        two ahead by one producer."""
        if steps is not None:
            batches = itertools.islice(batches, steps)
        batches, prefetcher = self._pipeline(batches, 2, 1, name="eval")
        per_batch: list[tuple[int, dict]] = []
        try:
            for batch in batches:
                x, y = device_put_batch(batch, self.device)
                per_batch.append((len(batch.x), self.eval_step(state, x, y)))
        finally:
            if prefetcher is not None:
                prefetcher.close()
        examples = sum(n for n, _ in per_batch)
        if examples == 0:
            return {"examples": 0}
        totals: dict[str, float] = {}
        for n, metrics in per_batch:
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
        out = {k: v / examples for k, v in totals.items()}
        out["examples"] = examples
        return out

    def throughput_logger(
        self,
        sample_x,
        examples_per_step: int,
        *,
        name: str = "train",
        sink: Any = None,
        log_every: int | None = None,
    ) -> ThroughputLogger:
        """A ThroughputLogger whose MFU numerator is ``analytic_flops_fn`` of
        the model's input (after an augment crop) and whose denominator is
        this card's peak (no MFU on the CPU or an unknown card)."""
        peak = peak_flops_per_chip() if self.device.type == "cuda" else None
        flops = None
        if peak is not None and self.analytic_flops_fn is not None:
            shape = list(sample_x.shape)
            crop = getattr(self.config.augment, "crop", None)
            if crop is not None:
                shape[1:3] = crop
            flops = self.analytic_flops_fn(np.empty(shape, dtype=np.uint8))
        return ThroughputLogger(
            global_batch_size=examples_per_step,
            log_every=log_every if log_every is not None else self.config.log_every,
            name=name,
            sink=sink,
            flops_per_step=flops,
            peak_flops=peak,
        )


class CapturedSteps:
    """``k`` train steps of ``trainer`` captured once as one CUDA graph.

    The graph reads static device buffers: the ``[k, B, ...]`` inputs, the
    ``k`` learning rates (a device tensor the optimizer reads, not a float
    baked into the graph) and, with augmentation, the ``k`` steps' flip and
    crop decisions, drawn before each replay for the steps it runs.
    Parameters, BatchNorm statistics and momentum buffers are updated in
    place inside the graph.  Capture follows one warm-up step on a side
    stream (cuDNN and cuBLAS workspaces, the kernels' attributes), whose
    changes to the state are undone.  A kernel wrapper's launch counter
    counts the warm-up's launches and the capture's, not the replays'.

    Takes every optimizer of :func:`_make_optimizer`: their learning rate
    and step count are device tensors.  Optimizer state that the warm-up
    creates is zeroed after it, which is where every one of them starts.
    Over a mesh the graph holds FSDP2's all-gathers and reduce-scatters (and
    the step's other collectives) on NCCL; a DDP step does not capture."""

    def __init__(self, trainer: Trainer, k: int):
        self.trainer, self.k = trainer, k
        self.graph: torch.cuda.CUDAGraph | None = None
        self._owner: nn.Module | None = None
        self.captures = 0

    def _state_tensors(self, state: TrainState) -> list[torch.Tensor]:
        return (list(state.model.parameters()) + list(state.model.buffers())
                + [v for s in state.optimizer.state.values() for v in s.values()
                   if isinstance(v, torch.Tensor)])

    def _run(self, state: TrainState, n: int) -> torch.Tensor:
        losses = []
        for i in range(n):
            decisions = None if self.decisions is None else tuple(
                None if d is None else d[i] for d in self.decisions)
            loss, _ = self.trainer._update(state, tree_map(lambda t: t[i], self.xs),
                                           tree_map(lambda t: t[i], self.ys), self.lrs[i],
                                           decisions)
            losses.append(loss)
        return torch.stack(losses)

    def _fill(self, state: TrainState, xs, ys) -> None:
        """The replay's inputs into the static buffers."""
        tree_map(lambda dst, src: dst.copy_(src, non_blocking=True), self.xs, xs)
        tree_map(lambda dst, src: dst.copy_(src, non_blocking=True), self.ys, ys)
        t = self.trainer
        lrs = torch.tensor([t._lr(state.step + i) for i in range(self.k)], dtype=torch.float32)
        self.lrs.copy_(lrs.pin_memory(), non_blocking=True)
        augment = t.config.augment
        if self.decisions is not None:
            b, h, w = self.xs.shape[1:4]
            drawn = [augment.decisions(state.step + i, b, h, w, device=t.device)
                     for i in range(self.k)]
            for j, buf in enumerate(self.decisions):
                if buf is not None:
                    buf.copy_(torch.stack([d[j] for d in drawn]))

    def _capture(self, state: TrainState, xs, ys) -> None:
        t = self.trainer
        if t.device.type != "cuda":
            raise RuntimeError("a CUDA graph captures steps on the card only; "
                               "multi_step_fn runs them eagerly on the CPU")
        if t.mesh is not None and (state.runner is not None or state.grad_sync is not None
                                   or t._pp_group is not None):
            # DDP's forward runs an operation a stream capture forbids
            # (cudaErrorStreamCaptureUnsupported, torch 2.11); the bucketed
            # sync counts its buckets on the host; GPipe's send/recv run on
            # CPU ranks.  FSDP2 and the collectives of tp/sp/ep capture.
            raise NotImplementedError(
                "capturing a step over a mesh takes FSDP2 (strategy 'fsdp'), not DDP, "
                "comms_overlap or pipeline stages")
        self.xs = tree_map(torch.empty_like, xs)
        self.ys = tree_map(torch.empty_like, ys)
        self.lrs = torch.zeros(self.k, dtype=torch.float32, device=t.device)
        self.decisions = None
        augment = t.config.augment
        if augment is not None and not augment.is_identity:
            b, h, w = xs.shape[1:4]
            self.decisions = tuple(None if d is None else torch.stack([d] * self.k)
                                   for d in augment.decisions(state.step, b, h, w, t.device))
        self._fill(state, xs, ys)
        saved = {id(s): (s, s.detach().clone()) for s in self._state_tensors(state)}
        side = torch.cuda.Stream(t.device)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            self._run(state, 1)
        torch.cuda.current_stream(t.device).wait_stream(side)
        with torch.no_grad():
            for s in self._state_tensors(state):
                if id(s) in saved:
                    s.copy_(saved[id(s)][1])
                else:  # made by the warm-up
                    s.zero_()
        del saved
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetcher's producers may copy while this captures.
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.losses = self._run(state, self.k)
        self._owner = state.model
        self.captures += 1

    def __call__(self, state: TrainState, xs, ys):
        xs, ys = device_put_batch(Batch(x=xs, y=ys), self.trainer.device)
        if self.graph is None or self._owner is not state.model:
            self._capture(state, xs, ys)
        self._fill(state, xs, ys)
        self.graph.replay()
        state.step += self.k
        return state, self.losses.clone()
