"""Llama memory accounting and its checks — counterpart of
``deeplearning_cfn_tpu/models/llama_memory.py``.

- :func:`memory_report`: per-device bytes of one (config, mesh, batch)
  point, from the shapes of a ``Llama`` built on the ``meta`` device (in
  place of ``jax.eval_shape``) and the specs of ``param_specs``: params,
  optimizer state, gradients, the remat-checkpointed activations, the logits
  (JAX's terms, term for term), and the port's own term for the loss's f32
  work (:class:`MemoryReport`).
- :func:`trace_check` (in place of ``compile_check``, which lowers XLA):
  one full train step at the given shapes on the ``meta`` device over a fake
  process group of the mesh's size; it allocates nothing.
- :func:`validate_on_device`: trains a few steps on the card and holds the
  allocator's peak against :func:`memory_report`.

Run ``python -m deeplearning_cfn_tpu_torch.models.llama_memory`` for the 8B
table, ``--trace`` for the two traced layouts, ``--validate`` on a card.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from deeplearning_cfn_tpu_torch.models import llama
from deeplearning_cfn_tpu_torch.models.llama import LlamaConfig

# Usable HBM per chip (GiB) of the TPU generations the JAX package names,
# copied as they are (book values); ``MemoryReport.fits()`` without a chip
# reads the card's own memory instead.
HBM_PER_CHIP_GIB = {
    "v4": 32,
    "v5litepod": 16,
    "v5p": 95,
    "v6e": 32,
}

GIB = 1024**3


def _shard_factor(spec, mesh_axes: dict[str, int]) -> int:
    """How many ways a spec divides an array on this mesh."""
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            factor *= mesh_axes.get(name, 1)
    return factor


def param_leaves(cfg: LlamaConfig) -> list[tuple[tuple[int, ...], int, tuple]]:
    """``(shape, itemsize, spec)`` of each leaf of the JAX parameter tree: the
    port's parameters, from a model on the ``meta`` device, with
    ``layers.{i}.<name>`` stacked into one ``[L, ...]`` leaf whose spec leads
    with the unsharded layer axis."""
    with torch.device("meta"):
        model = llama.Llama(cfg)
    specs = llama.param_specs(cfg)
    leaves: dict[str, list] = {}
    for name, p in model.named_parameters():
        key = re.sub(r"^layers\.\d+\.", "layers.", name)
        if key in leaves:
            leaves[key][0][0] += 1
        else:
            stacked = key != name
            shape = [1, *p.shape] if stacked else list(p.shape)
            spec = (None, *specs[name]) if stacked else tuple(specs[name])
            leaves[key] = [shape, p.element_size(), spec]
    return [(tuple(shape), size, spec) for shape, size, spec in leaves.values()]


def _tree_bytes(leaves, mesh_axes: dict[str, int]) -> int:
    """Sharded per-device bytes of the leaves."""
    return sum(math.prod(shape) * size // _shard_factor(spec, mesh_axes)
               for shape, size, spec in leaves)


def _adafactor_state_bytes(leaves) -> int:
    """Per-device bytes of Adafactor's state, JAX's formula: f32 row and
    column second moments (``n/d_last + n/d_second_last``) for a leaf of
    rank >= 2, a full f32 moment otherwise, no first moment, replicated."""
    total = 0
    for shape, _, _ in leaves:
        n = math.prod(shape)
        if len(shape) >= 2:
            total += 4 * (n // shape[-1] + n // shape[-2])
        else:
            total += 4 * n
    return total


@dataclass
class MemoryReport:
    cfg_name: str
    mesh_axes: dict[str, int]
    batch_global: int
    seq_len: int
    params_gib: float
    optimizer_gib: float
    gradients_gib: float
    activations_gib: float
    logits_gib: float
    loss_f32_gib: float
    total_gib: float

    def fits(self, chip: str | None = None, utilization: float = 0.9) -> bool:
        """Within ``utilization`` of a TPU chip's book memory, or with no
        ``chip`` of this process's card (``cuda:0``)."""
        if chip is None:
            capacity = torch.cuda.get_device_properties(0).total_memory / GIB
        else:
            capacity = HBM_PER_CHIP_GIB[chip]
        return self.total_gib <= capacity * utilization

    def row(self) -> str:
        axes = "x".join(f"{k}{v}" for k, v in self.mesh_axes.items() if v > 1)
        return (
            f"| {axes or 'replicated'} | {self.batch_global} | {self.seq_len} "
            f"| {self.params_gib:.2f} | {self.optimizer_gib:.2f} "
            f"| {self.gradients_gib:.2f} | {self.activations_gib:.2f} "
            f"| {self.logits_gib:.2f} | {self.loss_f32_gib:.2f} | **{self.total_gib:.2f}** |"
        )


def memory_report(
    cfg: LlamaConfig,
    mesh_axes: dict[str, int],
    batch_global: int,
    seq_len: int | None = None,
    optimizer: str = "adamw",
    cfg_name: str = "llama",
    grad_accum: int = 1,
) -> MemoryReport:
    """Per-device bytes for one (config, mesh, batch) point, as a sum of terms.

    JAX's terms, term for term: the parameters (each leaf's bytes over its
    spec's shard factor); the optimizer state (Adafactor's factored moments,
    or 2, 1, 0 parameter copies for adamw/lamb, momentum, sgd); the
    activations of remat per layer (the ``[B, S, D]`` residual checkpointed a
    layer, plus one block's live x, h, q, attention out, k, v and the
    gate/up pair, ``mlp_dim/tp`` wide); the logits and their cotangent in
    the compute dtype, vocab over ``tp``.  The batch splits over
    ``dp × fsdp``, the sequence over ``sp``, and with ``grad_accum`` the
    activations and logits are one microbatch's.

    The gradient term is the port's own program: ``Trainer._grads`` lets
    ``AccumulateGrad`` sum each microbatch's gradient into ``.grad`` in
    place, so it is one parameter-sized copy whatever ``grad_accum`` (JAX's
    scan carries a second one, a sum buffer, and doubles the term).

    ``loss_f32`` is the port's too: ``causal_lm_loss`` upcasts the logits to
    f32 for the logsumexp, which saves that copy, and its backward makes
    three f32 tensors of the same size (the difference, its exponential,
    the product with the incoming gradient): 16 bytes a logit, over the
    rank's share of the vocabulary (under ``tp`` the loss is vocab-parallel,
    ``ModelParallel.nll``).  The terms are summed, as JAX sums them: without accumulation
    the gradients and the logits are never alive together, so the sum is an
    upper bound, loosest there."""
    seq_len = seq_len or cfg.max_seq_len
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if batch_global % grad_accum:
        raise ValueError(
            f"batch_global={batch_global} not divisible by grad_accum={grad_accum}")
    leaves = param_leaves(cfg)
    params_b = _tree_bytes(leaves, mesh_axes)
    if optimizer == "adafactor":
        optimizer_b = _adafactor_state_bytes(leaves)
    else:
        n_moments = {"adamw": 2, "lamb": 2, "momentum": 1, "sgd": 0}[optimizer]
        optimizer_b = n_moments * params_b
    gradients_b = params_b

    batch_shards = mesh_axes.get("dp", 1) * mesh_axes.get("fsdp", 1)
    tp = mesh_axes.get("tp", 1)
    b_local = max(1, batch_global // grad_accum // batch_shards)
    s_local = max(1, seq_len // mesh_axes.get("sp", 1))
    bf16 = 2
    act_b = cfg.n_layers * b_local * s_local * cfg.dim * bf16
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    act_b += b_local * s_local * (4 * cfg.dim + 2 * kv_dim + 2 * (cfg.mlp_dim // tp)) * bf16
    logits_b = 2 * b_local * s_local * (cfg.vocab_size // tp) * bf16
    loss_f32_b = 16 * b_local * s_local * (cfg.vocab_size // tp)

    total = params_b + optimizer_b + gradients_b + act_b + logits_b + loss_f32_b
    return MemoryReport(
        cfg_name=cfg_name,
        mesh_axes=dict(mesh_axes),
        batch_global=batch_global,
        seq_len=seq_len,
        params_gib=params_b / GIB,
        optimizer_gib=optimizer_b / GIB,
        gradients_gib=gradients_b / GIB,
        activations_gib=act_b / GIB,
        logits_gib=logits_b / GIB,
        loss_f32_gib=loss_f32_b / GIB,
        total_gib=total / GIB,
    )


class _HostBytes:
    """Counts the bytes of every tensor an op makes off the ``meta``
    device while it is entered, and the largest of them."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and t.device.type != "meta":
                        n = t.untyped_storage().nbytes()
                        outer.bytes += n
                        outer.largest = max(outer.largest, n)
                return out

        self.bytes = self.largest = 0
        self._mode = Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def trace_check(
    cfg: LlamaConfig,
    mesh_axes: dict[str, int],
    batch_global: int,
    seq_len: int,
    optimizer: str = "adamw",
    grad_accum: int = 1,
) -> dict:
    """One full train step of the port's trainer at the given shapes, traced
    on the ``meta`` device: the model built there, the mesh a fake process
    group of the mesh's size (``FakeStore`` and the ``"fake"`` backend, its
    collectives no-ops), this process its rank 0, and the card's attention
    path (the flash forward's plain version and the blockwise backward).
    Shape and layout errors surface, and nothing of the model is allocated:
    ``host_bytes`` counts every tensor made off ``meta`` and
    ``host_largest`` the largest, which are torch AdamW's CPU step counters
    (4 bytes a parameter tensor) and the mesh's rank tables.

    FSDP2 cannot run on ``meta`` (it refuses parameters it cannot
    materialise), nor under ``FakeTensorMode`` over the fake group (its 2-D
    ``fsdp``×``tp`` mesh is built with data-dependent ops), so this is one
    rank's local program with FSDP2's gathers and reduce-scatters left out
    (``fsdp8×tp2`` is traced without FSDP2): the tp layout is the real one (parameters
    split over ``tp`` as ``DTensor`` s, the tp collectives on the fake
    group), the batch and the sequence are the rank's share, each parameter
    keeps its fsdp-gathered size, and the optimizer steps on that."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    world = math.prod(mesh_axes.values())
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    elif dist.get_world_size() != world:
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                           f"the mesh needs {world}")
    t0 = time.perf_counter()
    try:
        mesh = build_mesh(MeshSpec(**mesh_axes), device_type="cpu")
        trainer = llama.make_trainer(
            cfg, TrainerConfig(strategy="fsdp", optimizer=optimizer, learning_rate=1e-4,
                               grad_accum_steps=grad_accum),
            device="meta", mesh=mesh)
        tok = torch.zeros((batch_global, seq_len), dtype=torch.int32, device="meta")
        with _HostBytes() as host, llama.force_attention_kind("flash"):
            with torch.device("meta"):
                model = trainer.model_fn(None)
            state = trainer.init_from(model)
            state, metrics = trainer.train_step(state, tok, tok)
        n_local = sum(p.to_local().numel() if hasattr(p, "to_local") else p.numel()
                      for p in state.model.parameters())
        return {"traced": True, "seconds": time.perf_counter() - t0,
                "host_bytes": host.bytes, "host_largest": host.largest, "loss_shape": tuple(metrics["loss"].shape),
                "local_params": n_local, "step": state.step}
    finally:
        if owned:
            dist.destroy_process_group()


def validate_on_device(
    cfg: LlamaConfig,
    batch_global: int,
    seq_len: int,
    steps: int = 3,
    cfg_name: str = "llama",
    optimizer: str = "adamw",
) -> dict:
    """Trains ``steps`` steps on the card (weights drawn there from seed 0,
    tokens from numpy's seed 0, as JAX's) and holds :func:`memory_report`'s
    prediction against the allocator's peak: ``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats``, less what was allocated before the
    call (so that a caller's live tensors do not count)."""
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    if not torch.cuda.is_available():
        raise RuntimeError("validate_on_device measures the card; CUDA is not available")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = llama.make_trainer(
        cfg, TrainerConfig(strategy="fsdp", optimizer=optimizer, learning_rate=1e-4),
        device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch_global, seq_len))
    tok = torch.as_tensor(tokens, dtype=torch.int32, device="cuda")
    tgt = torch.roll(tok, -1, dims=1)
    state = trainer.init(seed=0, draw_on_device=True)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, tok, tgt)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]  # waits for the last step
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    predicted = memory_report(cfg, {"fsdp": 1}, batch_global=batch_global, seq_len=seq_len,
                              optimizer=optimizer, cfg_name=cfg_name)
    del state, trainer
    return {
        "config": cfg_name,
        "device": torch.cuda.get_device_name(0),
        "params": llama.param_count(cfg),
        "batch": batch_global,
        "seq_len": seq_len,
        "steps": steps,
        "losses": losses,
        "final_loss": losses[-1],
        "tokens_per_sec": batch_global * seq_len * steps / dt,
        "predicted_gib": predicted.total_gib,
        "predicted": vars(predicted),
        "measured_peak_gib": peak / GIB,
        "bytes_limit_gib": torch.cuda.get_device_properties(0).total_memory / GIB,
        "prediction_error_pct": 100.0 * (predicted.total_gib - peak / GIB) / (peak / GIB),
    }


# The layouts JAX's tests lower at 8B, traced by ``--trace``.
TRACED_LAYOUTS = (
    dict(mesh_axes={"fsdp": 1}, batch_global=8, seq_len=8192, optimizer="adafactor",
         grad_accum=8),
    dict(mesh_axes={"fsdp": 8, "tp": 2}, batch_global=16, seq_len=8192),
)


def main(argv: list[str] | None = None) -> None:
    import json
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--validate" in argv:
        for name, cfg, batch, seq in (
            ("435m", LlamaConfig.m435(seq_len=1024), 8, 1024),
            ("1b", LlamaConfig.b1(seq_len=1024), 4, 1024),
        ):
            print(json.dumps(validate_on_device(cfg, batch, seq, cfg_name=name)))
        return
    cfg = LlamaConfig.llama3_8b()
    if "--trace" in argv:
        for layout in TRACED_LAYOUTS:
            print(json.dumps({**layout, **trace_check(cfg, **layout)}))
        return
    print("# Llama-3 8B per-device memory (GiB) — the port's accounting\n")
    print("| mesh | global batch | seq | params | adamw | grads | acts "
          "| logits | loss f32 | total GiB/device |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for mesh_axes, batch in (
        ({"fsdp": 16, "tp": 1}, 16),
        ({"fsdp": 8, "tp": 2}, 16),
        ({"fsdp": 4, "tp": 4}, 16),
        ({"fsdp": 8, "tp": 2}, 32),
    ):
        print(memory_report(cfg, mesh_axes, batch_global=batch, cfg_name="llama3_8b").row())


if __name__ == "__main__":
    main()
