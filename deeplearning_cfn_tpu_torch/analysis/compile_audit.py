"""The dynamic compile-audit sentinel: prove steady state builds nothing.

The DLC4xx static rules (analysis/sharding.py) catch capture *hazards*;
this module catches what actually gets built at run time.  The port's
form of a JAX compile is what it makes while it runs:

- a **CUDA-graph capture**: ``train/trainer.CapturedSteps`` (a
  ``multi_step_fn(k)`` wrapper, recaptured when handed another model) and
  ``serve/engine.CapturedDecode`` (one per engine on the card);
- a **kernel library build** that misses the cache
  (``ops/_kernels.build``: ``nvcc`` over ``csrc/<name>.cu``).

Each calls :func:`note_capture` / :func:`note_build`, and every active
:class:`CompileWatcher` counts the event under its owner's name
(``CapturedSteps(k=2)``, ``CapturedDecode``, ``build:flash_attn_fwd``).
A watcher given ``owners`` counts only the captures of those wrapper
objects (or of wrappers of those classes), so a graph that an unrelated
path captures in the same process (a serving engine beside the trainer)
does not count against it; builds count for every watcher.  After the
warm-up the watcher marks steady state; any owner whose count then grows
is a finding (DLC410).
``cache_size`` is the number of graphs a wrapper holds.

**Donation** (DLC411) is observed directly: a state leaf (a parameter, a
persistent buffer, an optimizer state tensor) counts as donated when the
step updated it IN PLACE — the same storage, new values.  A leaf that
got new storage counts as retained: the old copy lived through the
update.  A step that donates nothing is a finding.  The eager multi-step
path also reports the bytes ``train.data.donate_buffers`` freed of the
batch it placed (``DonationReport.freed_bytes``), as ``fit`` frees a
stacked call's batch.  The serve audit checks that the paged pool
(``cache.k``/``cache.v``) keeps its storage across decode steps.

Findings are ordinary :class:`Violation`\\ s against the audited source
file, flowing through the baseline ratchet (analysis/lint_baseline.json),
and the results are journaled as a ``compile_audit`` event.  The fields
and messages are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.analysis.core import Violation
from deeplearning_cfn_tpu_torch.analysis.sharding import (
    AUDIT_RULE_DONATION,
    AUDIT_RULE_RETRACE,
)

REPO_ROOT = Path(__file__).resolve().parents[2]
# Findings anchor on the file that owns the audited step loop: the
# baseline key is (rule, repo-relative path, message).
AUDITED_FILE = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "train" / "trainer.py"
SERVE_AUDITED_FILE = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "serve" / "engine.py"

_ACTIVE_WATCHERS: list["CompileWatcher"] = []
_LOCK = threading.Lock()  # builds run on a pool's threads


def note_capture(owner: Any, name: str) -> None:
    """Hook: ``owner`` (a captured-step wrapper) just captured a graph."""
    with _LOCK:
        for w in _ACTIVE_WATCHERS:
            if w.owners is None or any(
                owner is o or (isinstance(o, type) and isinstance(owner, o))
                for o in w.owners
            ):
                w._count(name, capture=True)


def note_build(source: str) -> None:
    """Hook: ``ops/_kernels.build`` just compiled ``csrc/<source>.cu``."""
    with _LOCK:
        for w in _ACTIVE_WATCHERS:
            w.backend_compiles += 1
            w._count(f"build:{source}", capture=False)


class CompileWatcher:
    """Context manager counting per-owner captures and builds while active.

    ``traces`` counts the captures (the recording of a step, JAX's trace),
    ``compiles`` the captures and the builds; ``backend_compiles`` the
    builds alone (the aggregate cross-check).  ``mark_steady()``
    snapshots the counters; ``new_compiles_since_mark`` is then the
    report: any owner that captured or built after the mark.
    """

    def __init__(self, owners: tuple | list | None = None) -> None:
        self.owners = None if owners is None else list(owners)
        self.traces: dict[str, int] = {}
        self.compiles: dict[str, int] = {}
        self.backend_compiles = 0
        self._mark_traces: dict[str, int] = {}
        self._mark_compiles: dict[str, int] = {}

    def _count(self, name: str, capture: bool) -> None:
        if capture:
            self.traces[name] = self.traces.get(name, 0) + 1
        self.compiles[name] = self.compiles.get(name, 0) + 1

    # --- context --------------------------------------------------------
    def __enter__(self) -> "CompileWatcher":
        with _LOCK:
            _ACTIVE_WATCHERS.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        with _LOCK:
            if self in _ACTIVE_WATCHERS:
                _ACTIVE_WATCHERS.remove(self)

    # --- counters -------------------------------------------------------
    def mark_steady(self) -> None:
        self._mark_traces = dict(self.traces)
        self._mark_compiles = dict(self.compiles)

    def _delta(self, now: dict[str, int], mark: dict[str, int]) -> dict[str, int]:
        out = {}
        for fn, count in now.items():
            grew = count - mark.get(fn, 0)
            if grew > 0:
                out[fn] = grew
        return out

    def new_compiles_since_mark(self) -> dict[str, int]:
        return self._delta(self.compiles, self._mark_compiles)

    def new_traces_since_mark(self) -> dict[str, int]:
        return self._delta(self.traces, self._mark_traces)

    @property
    def compile_count(self) -> int:
        return sum(self.compiles.values())

    @property
    def retrace_count(self) -> int:
        """Captures or builds beyond the first per owner — 0 when healthy."""
        return sum(c - 1 for c in self.compiles.values() if c > 1)

    def snapshot(self) -> dict:
        return {
            "traces": dict(sorted(self.traces.items())),
            "compiles": dict(sorted(self.compiles.items())),
            "compile_count": self.compile_count,
            "retrace_count": self.retrace_count,
            "backend_compiles": self.backend_compiles,
        }


# --- donation ---------------------------------------------------------------


@dataclass(frozen=True)
class DonationReport:
    donated_bytes: int
    retained_bytes: int
    donated_leaves: int
    retained_leaves: int
    # Leaves the step left in place with their values unchanged (neither
    # donated nor retained), and the bytes donate_buffers freed of the
    # batch the audited call read (None where the path frees none).
    untouched_leaves: int = 0
    freed_bytes: int | None = None

    @property
    def effective(self) -> bool:
        return self.donated_bytes > 0

    def to_dict(self) -> dict:
        return {
            "donated_bytes": self.donated_bytes,
            "retained_bytes": self.retained_bytes,
            "donated_leaves": self.donated_leaves,
            "retained_leaves": self.retained_leaves,
            "untouched_leaves": self.untouched_leaves,
            "freed_bytes": self.freed_bytes,
            "effective": self.effective,
        }


def _local(t: Any) -> Any:
    return t.to_local() if hasattr(t, "to_local") else t


def state_leaves(state: Any) -> dict[str, Any]:
    """A ``TrainState``'s leaves by path: the model's parameters and
    persistent buffers (its state dict) and the optimizer's state tensors."""
    import torch

    out = {f"model.{k}": v for k, v in state.model.state_dict(keep_vars=True).items()
           if isinstance(v, torch.Tensor)}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            if isinstance(v, torch.Tensor):
                out[f"optimizer.{names.get(id(p), id(p))}.{k}"] = v
    return out


def measure_donation(
    fn: Callable,
    state: Any,
    *args: Any,
    leaves: Callable[[Any], dict[str, Any]] = state_leaves,
) -> tuple[Any, DonationReport]:
    """Call ``fn(state, *args)`` and report how much of ``state`` the step
    updated in place (donated) and how much it rebound to new storage
    (retained).  ``leaves(state)`` names the state's tensors by path; they
    are read again after the call, from the returned state when ``fn``
    returns one."""
    import torch

    before = {}
    for path, t in leaves(state).items():
        loc = _local(t).detach()
        before[path] = (loc.data_ptr(), loc.untyped_storage().nbytes(), loc.clone())
    out = fn(state, *args)
    returned = out[0] if isinstance(out, tuple) and out else None
    after = leaves(returned if type(returned) is type(state) else state)
    if any(_local(t).is_cuda for t in after.values()):
        torch.cuda.synchronize()
    donated_bytes = retained_bytes = donated_leaves = retained_leaves = untouched = 0
    for path, (ptr, nbytes, old) in before.items():
        t = after.get(path)
        loc = None if t is None else _local(t).detach()
        size = old.numel() * old.element_size()
        if loc is None or loc.data_ptr() != ptr or loc.untyped_storage().nbytes() != nbytes:
            retained_bytes += size
            retained_leaves += 1
        elif torch.equal(loc, old):
            untouched += 1
        else:
            donated_bytes += size
            donated_leaves += 1
    return out, DonationReport(
        donated_bytes=donated_bytes,
        retained_bytes=retained_bytes,
        donated_leaves=donated_leaves,
        retained_leaves=retained_leaves,
        untouched_leaves=untouched,
    )


# --- the audit itself -------------------------------------------------------


@dataclass
class PathAudit:
    """One audited dispatch path (single_step / multi_step / serve_decode)."""

    name: str
    steady_steps: int
    new_compiles: dict[str, int] = field(default_factory=dict)
    new_traces: dict[str, int] = field(default_factory=dict)
    cache_size: int | None = None
    donation: DonationReport | None = None
    # Which source file findings anchor on (the baseline key's path);
    # None -> the trainer.
    audited_file: str | None = None

    @property
    def clean(self) -> bool:
        return not self.new_compiles and (
            self.donation is None or self.donation.effective
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "steady_steps": self.steady_steps,
            "new_compiles": dict(sorted(self.new_compiles.items())),
            "new_traces": dict(sorted(self.new_traces.items())),
            "cache_size": self.cache_size,
            "donation": self.donation.to_dict() if self.donation else None,
            "clean": self.clean,
        }


@dataclass
class CompileAuditReport:
    paths: list[PathAudit]
    watcher: dict
    violations: list[Violation]

    def to_dict(self) -> dict:
        return {
            "paths": [p.to_dict() for p in self.paths],
            "watcher": self.watcher,
            "violations": [v.to_dict() for v in self.violations],
            "clean": not self.violations,
        }


def violations_for(paths: list[PathAudit]) -> list[Violation]:
    """Fold path audits into baseline-ratchet findings (the JAX package's
    messages: count-free, so a recapture that fires 3 times vs 4 times is
    the same finding)."""
    out: list[Violation] = []
    for p in paths:
        anchor = p.audited_file or str(AUDITED_FILE)
        if p.new_compiles:
            fns = ", ".join(sorted(p.new_compiles))
            out.append(
                Violation(
                    rule=AUDIT_RULE_RETRACE,
                    path=anchor,
                    line=1,
                    col=1,
                    message=(
                        f"steady-state retrace on the {p.name} path: "
                        f"{fns} recompiled after warmup (compile-audit "
                        "sentinel; see docs/STATIC_ANALYSIS.md retrace "
                        "runbook)"
                    ),
                )
            )
        if p.donation is not None and not p.donation.effective:
            out.append(
                Violation(
                    rule=AUDIT_RULE_DONATION,
                    path=anchor,
                    line=1,
                    col=1,
                    message=(
                        f"state donation ineffective on the {p.name} "
                        "path: no input buffer was deleted by the step "
                        "(donate_argnums dropped or aliasing declined; "
                        "compile-audit sentinel)"
                    ),
                )
            )
    return out


def cache_size(wrapper: Any) -> int | None:
    """Graphs a captured-step wrapper holds (None for an eager callable)."""
    if hasattr(wrapper, "graph"):
        return int(wrapper.graph is not None)
    return None


def _journal(paths: list[PathAudit], snapshot: dict, violations: list[Violation]) -> None:
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    get_recorder().record(
        "compile_audit",
        clean=not violations,
        compile_count=snapshot["compile_count"],
        retrace_count=snapshot["retrace_count"],
        backend_compiles=snapshot["backend_compiles"],
        paths={p.name: p.to_dict() for p in paths},
    )


def audit_mlp(hidden: int = 32, classes: int = 4, inputs: int = 64):
    """``model_fn`` of the audit MLP (flatten, Dense(hidden), relu,
    Dense(classes)): the JAX audit's ``_AuditMLP``."""
    import torch
    from torch import nn

    def model_fn(generator=None):
        model = nn.Sequential(nn.Flatten(), nn.Linear(inputs, hidden), nn.ReLU(),
                              nn.Linear(hidden, classes))
        if generator is not None:
            with torch.no_grad():
                for layer in (model[1], model[3]):
                    layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                       * layer.weight.shape[1] ** -0.5)
                    layer.bias.zero_()
        return model

    return model_fn


def run_compile_audit(
    steady_steps: int = 4,
    warmup_steps: int = 2,
    k: int = 2,
    batch_size: int = 8,
    journal: bool = True,
    device: str = "cuda",
) -> CompileAuditReport:
    """Run the real trainer and assert steady state captures and builds
    nothing: the single-step ``fit`` path and a ``multi_step_fn(k)``
    wrapper built once and called many times (its graph on the card, its
    eager steps on the CPU).  Small on purpose (the audit MLP, a handful
    of steps): the question is whether the dispatch layer reaches a fixed
    point, which is shape-independent."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.train.data import (
        Batch,
        SyntheticDataset,
        device_put_batch,
        donate_buffers,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    ds = SyntheticDataset(shape=(8, 8, 1), num_classes=4, batch_size=batch_size, seed=0)
    trainer = Trainer(audit_mlp(), TrainerConfig(learning_rate=0.05, optimizer="sgd"),
                      device=device)
    sample = next(iter(ds.batches(1)))
    paths: list[PathAudit] = []
    kfn = trainer.multi_step_fn(k)
    with CompileWatcher(owners=[kfn]) as watcher:
        state = trainer.init(seed=0)

        # --- single-step fit path (the production loop) ----------------
        state, _ = trainer.fit(state, ds.batches(warmup_steps), steps=warmup_steps, prefetch=0)
        watcher.mark_steady()
        state, losses = trainer.fit(state, ds.batches(steady_steps), steps=steady_steps,
                                    prefetch=0)
        assert len(losses) == steady_steps
        single = PathAudit(
            name="single_step",
            steady_steps=steady_steps,
            new_compiles=watcher.new_compiles_since_mark(),
            new_traces=watcher.new_traces_since_mark(),
            cache_size=None,
        )
        x, y = device_put_batch(sample, trainer.device)
        (state, _metrics), single.donation = measure_donation(trainer.train_step, state, x, y)
        paths.append(single)

        # --- multi-step path: one wrapper, many calls ------------------
        stack = list(ds.batches(2 * k))
        xs = np.stack([b.x for b in stack[:k]])
        ys = np.stack([b.y for b in stack[:k]])
        state, _ = kfn(state, xs, ys)  # the capture, on the card
        watcher.mark_steady()
        multi = PathAudit(name="multi_step", steady_steps=steady_steps)
        for i in range(steady_steps):
            xs2, ys2 = device_put_batch(
                Batch(x=np.stack([b.x for b in stack[k:]]), y=np.stack([b.y for b in stack[k:]])),
                trainer.device)
            if i == steady_steps - 1:
                (state, _losses), donation = measure_donation(kfn, state, xs2, ys2)
                # As fit frees a stacked call's batch once it is launched.
                multi.donation = dataclasses.replace(
                    donation, freed_bytes=donate_buffers((xs2, ys2)))
            else:
                state, _losses = kfn(state, xs2, ys2)
        multi.new_compiles = watcher.new_compiles_since_mark()
        multi.new_traces = watcher.new_traces_since_mark()
        multi.cache_size = cache_size(kfn)
        paths.append(multi)
        snapshot = watcher.snapshot()

    violations = violations_for(paths)
    if journal:
        _journal(paths, snapshot, violations)
    return CompileAuditReport(paths=paths, watcher=snapshot, violations=violations)


def run_serve_audit(
    steady_requests: int = 24,
    journal: bool = True,
    device: str = "cuda",
    cfg: Any = None,
    serve_cfg: Any = None,
    seed: int = 0,
) -> CompileAuditReport:
    """The serving-plane sentinel: continuous batching must reach ONE
    captured decode step and stay there.

    Warms an engine (one request through prefill and decode), marks
    steady, then pushes ``steady_requests`` requests of MIXED prompt and
    output lengths through the scheduler: every admission, occupancy
    pattern and page placement must replay the same graph.  Any capture
    after the warm-up is a DLC410 finding anchored on serve/engine.py; a
    decode step that moves the paged pool to new storage is DLC411.
    ``cfg`` defaults to the JAX audit's tiny f32 Llama (vocab 64, window
    64); ``serve_cfg`` to its 4 slots of 8 pages of 4."""
    import numpy as np
    import torch

    from deeplearning_cfn_tpu_torch.models.llama import Llama, LlamaConfig
    from deeplearning_cfn_tpu_torch.serve.engine import (
        CapturedDecode,
        ContinuousBatchingEngine,
        ServeConfig,
        ServeRequest,
    )

    cfg = cfg or LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    scfg = serve_cfg or ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8,
                                    prefill_len=16)
    gen = torch.Generator().manual_seed(seed)
    model = Llama(cfg, generator=gen).to(device).eval()
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    max_prompt = scfg.prefill_len
    max_new = scfg.max_context - max_prompt

    def make_request(i: int) -> ServeRequest:
        prompt = rng.integers(0, vocab, size=int(rng.integers(1, max_prompt + 1)))
        return ServeRequest(f"audit-{i}", prompt.astype(np.int32),
                            int(rng.integers(1, max_new + 1)))

    paths: list[PathAudit] = []
    with CompileWatcher(owners=[CapturedDecode]) as watcher:
        engine = ContinuousBatchingEngine(model, scfg, clock=lambda: 0.0, journal=False)
        engine.submit(make_request(0))
        while engine.pending():
            engine.step()
        watcher.mark_steady()
        pool = (engine.cache.k.data_ptr(), engine.cache.v.data_ptr())

        decode_steps = 0
        for i in range(1, steady_requests + 1):
            engine.submit(make_request(i))
        while engine.pending():
            engine.step()
            decode_steps += 1

        audit = PathAudit(
            name="serve_decode",
            steady_steps=decode_steps,
            new_compiles=watcher.new_compiles_since_mark(),
            new_traces=watcher.new_traces_since_mark(),
            cache_size=cache_size(engine.captured) if engine.captured is not None else None,
            audited_file=str(SERVE_AUDITED_FILE),
        )
        # Donation on a real steady-state decode step: the paged pool must
        # be written in place, not copied.
        engine.submit(make_request(steady_requests + 1))

        def pool_leaves(eng):
            return {"cache.k": eng.cache.k, "cache.v": eng.cache.v}

        def one_step(eng):
            eng.step()
            return eng

        _, audit.donation = measure_donation(one_step, engine, leaves=pool_leaves)
        while engine.pending():
            engine.step()
        paths.append(audit)
        snapshot = watcher.snapshot()
        snapshot["decode_captures"] = engine.decode_captures
        snapshot["pool_storage_unchanged"] = pool == (
            engine.cache.k.data_ptr(), engine.cache.v.data_ptr())

    violations = violations_for(paths)
    if journal:
        _journal(paths, snapshot, violations)
    return CompileAuditReport(paths=paths, watcher=snapshot, violations=violations)


def main(argv: list[str] | None = None) -> int:
    """``python -m deeplearning_cfn_tpu_torch.analysis.compile_audit
    [--device cpu]``: the trainer and serve audits; print the reports, exit
    1 on findings the baseline does not hold."""
    import argparse
    import json

    from deeplearning_cfn_tpu_torch.analysis.runner import apply_audit_baseline
    from deeplearning_cfn_tpu_torch.analysis.sharding import AUDIT_RULE_IDS

    ap = argparse.ArgumentParser(prog="compile_audit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reports = [run_compile_audit(device=args.device), run_serve_audit(device=args.device)]
    found = [v for r in reports for v in r.violations]
    fresh, stale = apply_audit_baseline(found, None, AUDIT_RULE_IDS)
    print(json.dumps({"reports": [r.to_dict() for r in reports],
                      "fresh": [v.to_dict() for v in fresh],
                      "stale": [list(e) for e in stale]}, indent=2))
    return 1 if fresh else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
