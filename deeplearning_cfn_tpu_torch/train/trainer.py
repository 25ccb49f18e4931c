"""The trainer — counterpart of ``deeplearning_cfn_tpu/train/trainer.py`` for
one device.

The same ``TrainerConfig`` field names and the same step semantics as the
JAX package's jitted step, in eager PyTorch:

- Optimizers ``adamw``, ``sgd`` and ``momentum`` as optax builds them:
  ``decay_mask`` becomes two parameter groups (decay and no decay); the
  global-norm clip is optax's (scale by ``max_norm / norm`` only when
  ``norm >= max_norm``, no epsilon), applied before the update; the learning
  rate comes from the 0-based step.  Adam moments follow the parameter
  dtype, as optax's do.
- Gradient accumulation over strided microbatches ``x[a::k]``: part
  gradients summed, then divided by ``k``.
- The state is updated in place (PyTorch parameters and optimizer state are
  mutable); ``train_step`` returns the same ``TrainState`` object.
- With no ``loss_fn``, the default classification objective: softmax
  cross-entropy (no label smoothing) and accuracy.

One device only: ``strategy="fsdp"`` (or ``"dp"``) is the identity.  Meshes,
comms overlap, multi-step programs, checkpointing and live reshard are
ported in later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.train.data import device_put_batch
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger, peak_flops_per_chip

_LATER = "a later slice of the PyTorch port"


@dataclass
class TrainerConfig:
    learning_rate: float = 0.01
    has_train_arg: bool = False
    optimizer: str = "momentum"  # sgd | momentum | adamw
    momentum: float = 0.9
    weight_decay: float = 0.0
    strategy: str = "dp"  # dp | fsdp; both are the identity on one device
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


def _make_optimizer(model: nn.Module, cfg: TrainerConfig) -> torch.optim.Optimizer:
    lr = cfg.learning_rate
    groups = _param_groups(model, cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "sgd":
        # L2 decay joins the gradient before the update, on the decay group.
        return torch.optim.SGD(groups, lr=lr)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum, nesterov=True, dampening=0.0)
    if cfg.optimizer in ("lamb", "adafactor"):
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is ported in {_LATER}")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@torch.no_grad()
def clip_by_global_norm(parameters, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients: ``g / norm * max_norm``
    when ``norm >= max_norm``, untouched otherwise.  Returns the norm.  No
    host sync: the choice is made on the device."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def _check_in_slice(cfg: TrainerConfig) -> None:
    unsupported = {
        "comms_overlap": cfg.comms_overlap,
        "overlap_compress": cfg.overlap_compress,
        "has_train_arg": cfg.has_train_arg,
        "bf16_compute": cfg.bf16_compute,
        "remat": cfg.remat,
        "input_stats": cfg.input_stats is not None,
        "augment": cfg.augment is not None,
        "label_smoothing": bool(cfg.label_smoothing),
        "matmul_precision": cfg.matmul_precision is not None,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"TrainerConfig.{name} is ported in {_LATER}")
    if cfg.strategy not in ("dp", "fsdp"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer labels, the log-softmax in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def classification_objective(model: nn.Module, x: torch.Tensor, y: torch.Tensor):
    """The JAX trainer's default objective: ``softmax_xent`` and accuracy."""
    logits = model(x)
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    return softmax_xent(logits, y), {"accuracy": acc}


class Trainer:
    """Runs ``loss_fn(model, x, y) -> (loss, aux)`` steps on one device
    (``classification_objective`` when no ``loss_fn`` is given).

    ``model_fn(generator)`` builds the model (its weights drawn from the
    generator); ``analytic_flops_fn(x)`` gives the training FLOPs of one
    step on batch ``x``, the MFU numerator."""

    def __init__(
        self,
        model_fn: Callable[[torch.Generator], nn.Module],
        config: TrainerConfig,
        loss_fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], tuple[torch.Tensor, dict]]
        | None = None,
        device: torch.device | str | None = None,
        analytic_flops_fn: Callable[[Any], float] | None = None,
    ):
        _check_in_slice(config)
        self.model_fn = model_fn
        self.config = config
        self.loss_fn = loss_fn or classification_objective
        self.device = resolve_device(device)
        self.analytic_flops_fn = analytic_flops_fn
        # Set by fit(): seconds from fit entry to the first completed step,
        # and the perf_counter stamp of that completion.
        self.first_step_seconds: float | None = None
        self.first_step_at: float | None = None

    def init(self, seed: int = 0) -> TrainState:
        """Build the model from ``seed`` on the trainer's device, and its optimizer."""
        gen = torch.Generator().manual_seed(seed)
        model = self.model_fn(gen).to(self.device)
        return TrainState(step=0, model=model, optimizer=_make_optimizer(model, self.config))

    def _grads(self, model: nn.Module, x, y) -> tuple[torch.Tensor, dict]:
        accum = self.config.grad_accum_steps
        if accum == 1:
            loss, aux = self.loss_fn(model, x, y)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in aux.items()}
        n = x.shape[0]
        if n % accum:
            raise ValueError(f"batch axis {n} not divisible by grad_accum_steps={accum}")
        losses, auxes = [], []
        for a in range(accum):
            loss, aux = self.loss_fn(model, x[a::accum], y[a::accum])
            loss.backward()  # .grad sums the part gradients
            losses.append(loss.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        aux = {k: torch.stack([d[k] for d in auxes]).mean() for k in auxes[0]}
        return torch.stack(losses).mean(), aux

    def train_step(self, state: TrainState, x: torch.Tensor, y: torch.Tensor):
        """One optimizer update; returns ``(state, metrics)`` with the metrics
        as device tensors (no host sync)."""
        cfg = self.config
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, aux = self._grads(model, x, y)
        if cfg.grad_clip_norm:
            clip_by_global_norm(model.parameters(), cfg.grad_clip_norm)
        lr = cfg.lr_schedule(state.step) if cfg.lr_schedule is not None else cfg.learning_rate
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss, **aux}

    def multi_step_fn(self, k: int):
        raise NotImplementedError(f"multi-step programs are ported in {_LATER}")

    def fit(
        self,
        state: TrainState,
        batches,
        steps: int,
        logger: ThroughputLogger | None = None,
        checkpointer: Any = None,
        reshard: Any = None,
        steps_per_call: int = 1,
    ) -> tuple[TrainState, list[float]]:
        """Train on at most ``steps`` batches.  Losses are read back to the
        host every ``config.log_every`` steps (and at the end), not per step."""
        for name, on in (("checkpointer", checkpointer is not None),
                         ("reshard", reshard is not None),
                         ("steps_per_call > 1", steps_per_call != 1)):
            if on:
                raise NotImplementedError(f"fit({name}) is ported in {_LATER}")
        losses: list[float] = []
        pending: list[torch.Tensor] = []
        sync_every = max(1, int(self.config.log_every))
        t_fit = time.perf_counter()
        for i, batch in enumerate(itertools.islice(batches, steps)):
            x, y = device_put_batch(batch, self.device)
            state, metrics = self.train_step(state, x, y)
            pending.append(metrics["loss"])
            if i == 0:
                float(metrics["loss"])  # waits for the first step
                self.first_step_seconds = time.perf_counter() - t_fit
                self.first_step_at = time.perf_counter()
            if logger:
                logger.step(state.step, metrics["loss"])
            if state.step % sync_every == 0 or i == steps - 1:
                losses.extend(torch.stack(pending).tolist())
                pending.clear()
        if pending:
            losses.extend(torch.stack(pending).tolist())
        return state, losses

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches, steps: int | None = None) -> dict:
        """Example-weighted mean of the loss and metrics over the batches,
        with no gradients, plus ``examples``."""
        model = state.model
        model.eval()
        if steps is not None:
            batches = itertools.islice(batches, steps)
        per_batch: list[tuple[int, dict]] = []
        for batch in batches:
            x, y = device_put_batch(batch, self.device)
            loss, aux = self.loss_fn(model, x, y)
            per_batch.append((len(batch.x), {"loss": loss, **aux}))
        model.train()
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
        """A ThroughputLogger whose MFU numerator is the model's analytic
        FLOPs per step and whose denominator is this card's peak (no MFU on
        the CPU or an unknown card)."""
        peak = peak_flops_per_chip() if self.device.type == "cuda" else None
        flops = None
        if peak is not None and self.analytic_flops_fn is not None:
            flops = self.analytic_flops_fn(sample_x)
        return ThroughputLogger(
            global_batch_size=examples_per_step,
            log_every=log_every if log_every is not None else self.config.log_every,
            name=name,
            sink=sink,
            flops_per_step=flops,
            peak_flops=peak,
        )
