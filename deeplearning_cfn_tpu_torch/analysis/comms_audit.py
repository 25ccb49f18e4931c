"""The dynamic comms-audit sentinel: count the collectives a step ran.

The DLC50x static rules (analysis/collectives.py) catch the *source
patterns* that tend to produce accidental collectives; this module
measures the collectives the real train and serve programs actually run.
The JAX package reads them off compiled HLO; the port has no program
text, so it reads the run: each audited program takes one warm-up step
and one profiled step on each of 2 gloo ranks (``torch.profiler``, CPU
activity, shapes recorded), and three signals come off the trace:

- the **collectives**: c10d's dispatcher ops (``c10d::allreduce_``,
  ``c10d::_allgather_base_``, ``c10d::_reduce_scatter_base_``, ...), each
  with its result bytes (the output tensor's, as the JAX audit counts HLO
  result shapes).  A **second witness** counts the backend's own work
  events (``gloo:*``, ``nccl:*``): one per c10d call, counted at another
  layer of the stack, cross-checked as the JAX audit cross-checks its
  compiles.  (gloo runs a reduce-scatter as an all-reduce: the witness
  checks counts, the c10d op names the kind.)
- ``peak_hbm_bytes``: on the CPU the peak of the profiler's memory
  events over the step (what the step allocates above what it started
  with); on the card ``torch.cuda.max_memory_allocated`` over the step
  (everything resident).  The committed budget holds the CPU's number.
- ``overlap_score``: per collective, the compute ops the issuing thread
  runs between the collective's issue and the next collective boundary
  (or the end of the step) — the slack that the JAX audit's schedule
  reader counts.  The trace shows no event for the wait on a gloo work
  handle, so the next boundary stands for it.  The mean over the
  collectives is the score; a bucketed sync that issues early should
  score above the monolithic end-of-backward bundle.

Each program yields a **comms budget**
``{collective_count, collective_bytes, peak_hbm_bytes, overlap_score}``
committed in analysis/comms_budget.json and ratcheted: DLC510 when a
program's collective count or bytes exceed it, DLC511 when an FSDP step
all-gathers a shape its parameter groups do not predict (FSDP2 gathers a
module's parameters as ONE flat padded buffer: the prediction is each
group's ``world x sum of padded shards``, not the parameters' shapes),
DLC512 when a ``*_overlap`` program fails to beat its monolithic twin or
falls below its committed score.  The fields and messages are the JAX
package's; findings flow through the baseline ratchet and results are
journaled as ``comms_audit`` events.

The six programs are JAX's, under JAX's names, at its audit shapes
(``AUDIT_HIDDEN`` 256, batch 16, input 8x8x1, 4 classes): ``train_step``
and ``multi_step`` (fsdp), ``train_step_dp`` (the dp step: DDP's sync),
``train_step_dp_overlap`` and ``multi_step_dp_overlap`` (the bucketed
sync at 32 KiB buckets; grad accumulation 2 on the latter) and
``serve_decode`` (one device, no collectives).

The ranks are NCCL's, one card each, when the host has a card for each
rank, and gloo's otherwise (on the CPU, or sharing cuda:0).  Over NCCL,
``multi_step`` and ``multi_step_dp_overlap`` go through
``Trainer.multi_step_fn(k)`` captured as one CUDA graph, as the JAX audit
compiles them (the **captured** form): their collectives are the c10d ops
that the capture dispatched (the records inside the
``CapturedSteps.capture`` range), and one more call, a replay, is
profiled on the card, where it must launch one NCCL kernel a collective on
each rank (``replay_nccl_kernels``).  A CUDA graph cannot hold a gloo
group's collectives (``parallel/mesh.capture_refusal``), so over gloo the
two programs run their k steps eagerly (the **eager** form).  The report
names the form (``multi_step_form``) and the backend.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from deeplearning_cfn_tpu_torch.analysis.collectives import (
    AUDIT_RULE_BUDGET,
    AUDIT_RULE_OVERLAP,
    AUDIT_RULE_UNPREDICTED,
)
from deeplearning_cfn_tpu_torch.analysis.core import Violation

REPO_ROOT = Path(__file__).resolve().parents[2]
AUDITED_FILE = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "train" / "trainer.py"
SERVE_AUDITED_FILE = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "serve" / "engine.py"
DEFAULT_BUDGET_PATH = Path(__file__).resolve().parent / "comms_budget.json"

RANKS = 2
RANK_TIMEOUT_S = 600

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
    "broadcast",
)
# c10d dispatcher op -> collective kind.
C10D_OPS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::broadcast_": "broadcast",
}
# Ops whose first argument is the (single) output tensor.
_OUTPUT_FIRST = ("c10d::_allgather_base_", "c10d::_reduce_scatter_base_", "c10d::alltoall_base_")
_BACKEND_PREFIXES = ("gloo:", "nccl:")
_DTYPE_BYTES = {
    "float": 4,
    "double": 8,
    "c10::BFloat16": 2,
    "c10::Half": 2,
    "long int": 8,
    "int": 4,
    "short int": 2,
    "signed char": 1,
    "unsigned char": 1,
    "bool": 1,
    "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1,
}


@dataclass(frozen=True)
class CollectiveOp:
    """One collective the trace shows."""

    op: str
    result_shapes: tuple[tuple[int, ...], ...]
    nbytes: int

    def to_dict(self) -> dict:
        return {
            "op": self.op,
            "result_shapes": [list(s) for s in self.result_shapes],
            "nbytes": self.nbytes,
        }


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def trace_records(prof) -> list[dict]:
    """A finished ``torch.profiler.profile``'s CPU events as plain records
    (name, thread, start/end ns, shapes, dtypes), the input of
    :func:`trace_collectives` and :func:`trace_overlap`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        out.append({
            "name": e.name(),
            "thread": int(e.start_thread_id()),
            "start": start,
            "end": start + int(e.duration_ns()),
            "shapes": [list(s) for s in e.shapes()],
            "dtypes": list(e.dtypes()),
        })
    out.sort(key=lambda r: (r["start"], -r["end"]))
    return out


def _result_bytes(c10d: dict, backend: dict | None, world: int) -> tuple[tuple, int]:
    """(result shape, bytes) of one collective from its c10d record and,
    where the c10d op takes a tensor list (no shapes recorded), its
    backend record."""
    if c10d["name"] in _OUTPUT_FIRST and c10d["shapes"] and c10d["shapes"][0]:
        shape = tuple(c10d["shapes"][0])
        return shape, _numel(shape) * _DTYPE_BYTES.get(c10d["dtypes"][0], 4)
    if backend is None or not backend["shapes"] or not backend["shapes"][0]:
        return (), 0
    shape = tuple(backend["shapes"][0])
    if C10D_OPS[c10d["name"]] == "all-gather":
        shape = (world * shape[0],) + shape[1:] if shape else shape
    return shape, _numel(shape) * _DTYPE_BYTES.get(backend["dtypes"][0], 4)


def trace_collectives(records: list[dict], world: int) -> tuple[list[CollectiveOp], int]:
    """The trace's collectives (c10d ops, in issue order, with result
    bytes) and the backend's own count of them (the second witness)."""
    c10d = [r for r in records if r["name"] in C10D_OPS]
    backend = [r for r in records if r["name"].startswith(_BACKEND_PREFIXES)]
    ops = []
    for i, r in enumerate(c10d):
        shape, nbytes = _result_bytes(r, backend[i] if i < len(backend) else None, world)
        ops.append(CollectiveOp(op=C10D_OPS[r["name"]], result_shapes=(shape,), nbytes=nbytes))
    return ops, len(backend)


def trace_slack(records: list[dict]) -> list[tuple[str, int]]:
    """Each collective's compute slack on its issuing thread, as
    ``(c10d op, slack)`` in issue order, thread by thread.

    The issuing thread's sequence is its collectives and its outermost
    ``aten::`` ops, in start order; a collective's slack is the count of
    compute ops strictly between it and the next collective (or the end
    of the step)."""
    by_thread: dict[int, list[tuple[str, int, int]]] = {}
    for r in records:
        name = r["name"]
        if name in C10D_OPS or name.startswith("aten::"):
            by_thread.setdefault(r["thread"], []).append((name, r["start"], r["end"]))
    slack = []
    for events in by_thread.values():
        seq: list[str] = []
        open_end = -1
        for name, start, end in events:
            if name in C10D_OPS:
                seq.append(name)
                open_end = max(open_end, end)
            elif start >= open_end:  # outermost: not inside the last op
                seq.append(name)
                open_end = end
        idxs = [i for i, n in enumerate(seq) if n in C10D_OPS]
        for j, i in enumerate(idxs):
            boundary = idxs[j + 1] if j + 1 < len(idxs) else len(seq)
            slack.append((seq[i], boundary - i - 1))
    return slack


def trace_overlap(records: list[dict]) -> dict:
    """Mean compute slack per collective on its issuing thread
    (:func:`trace_slack`).  A slack-0 collective is SERIALIZED: nothing runs
    for it to hide behind.  Returns ``{"overlap_score",
    "serialized_collectives", "scheduled_collectives"}``; the score is 0.0
    without collectives."""
    slack = [n for _, n in trace_slack(records)]
    return {
        "overlap_score": round(sum(slack) / max(len(slack), 1), 4),
        "serialized_collectives": sum(n == 0 for n in slack),
        "scheduled_collectives": len(slack),
    }


def trace_peak_bytes(prof) -> int:
    """Peak of the profiler's memory events over the profiled region: the
    bytes the step allocated above what it started with (CPU)."""
    level = peak = 0
    mem = [e for e in prof.profiler.kineto_results.events() if e.name() == "[memory]"]
    for e in sorted(mem, key=lambda e: e.start_ns()):
        level += int(e.nbytes())
        peak = max(peak, level)
    return peak


def program_comms(trace: dict) -> dict:
    """The full comms/memory readout of one profiled program: ``trace`` is
    ``{"records": [...], "world": n, "peak_hbm_bytes": b}``."""
    ops, witness = trace_collectives(trace["records"], trace["world"])
    by_op = {name: 0 for name in COLLECTIVE_OPS}
    bytes_by_op = {name: 0 for name in COLLECTIVE_OPS}
    for op in ops:
        by_op[op.op] += 1
        bytes_by_op[op.op] += op.nbytes
    overlap = trace_overlap(trace["records"])
    return {
        "collective_count": len(ops),
        "collective_bytes": sum(op.nbytes for op in ops),
        "peak_hbm_bytes": int(trace.get("peak_hbm_bytes", 0)),
        "overlap_score": overlap["overlap_score"],
        "serialized_collectives": overlap["serialized_collectives"],
        "by_op": {k: v for k, v in by_op.items() if v},
        "bytes_by_op": {k: v for k, v in bytes_by_op.items() if v},
        "flops": None,
        "bytes_accessed": None,
        "witness_count": witness,
        "ops": ops,
    }


# --- strategy prediction (DLC511) -------------------------------------------


@dataclass(frozen=True)
class StrategyPrediction:
    """The all-gathers an FSDP step is entitled to emit.

    FSDP2 gathers each parameter group (a ``fully_shard``-ed module's own
    parameters) as ONE flat buffer: every rank's padded shards, end to
    end, so a legitimate gather result is ``(world x sum of the group's
    padded shard numels,)``.  The parameters' own shapes are predicted
    too (a DTensor ``full_tensor`` of a leaf).  Anything else — a batch,
    an activation — means data that should stay sharded was gathered.
    """

    leaf_shapes: frozenset[tuple[int, ...]]

    @classmethod
    def from_state(cls, state: Any) -> "StrategyPrediction":
        return cls(leaf_shapes=frozenset(fsdp_gather_shapes(state.model)))

    def predicts(self, shape: tuple[int, ...]) -> bool:
        return tuple(shape) in self.leaf_shapes


def fsdp_gather_shapes(model) -> set[tuple[int, ...]]:
    """The flat all-gather result shape of each FSDP2 parameter group of
    ``model``, and every parameter's global shape."""
    shapes = {tuple(p.shape) for p in model.parameters()}
    for module in model.modules():
        get_state = getattr(module, "_get_fsdp_state", None)
        group = getattr(get_state(), "_fsdp_param_group", None) if get_state else None
        if group is None:
            continue
        world = group.mesh_info.shard_mesh_size
        local = sum(fp._sharded_param_data.numel() for fp in group.fsdp_params)
        shapes.add((world * local,))
    return shapes


def _dims(shape: tuple[int, ...]) -> str:
    return "x".join(str(d) for d in shape) if shape else "scalar"


# --- the watcher ------------------------------------------------------------


@dataclass
class ProgramComms:
    """One audited program's comms budget + DLC511 evidence."""

    name: str
    collective_count: int
    collective_bytes: int
    peak_hbm_bytes: int
    by_op: dict[str, int]
    bytes_by_op: dict[str, int]
    flops: float | None
    bytes_accessed: float | None
    overlap_score: float = 0.0
    serialized_collectives: int = 0
    unpredicted_gathers: tuple[tuple[int, ...], ...] = ()
    audited_file: str | None = None
    # The backend's own count of the collectives (the second witness).
    witness_count: int | None = None

    @property
    def budget(self) -> dict:
        return {
            "collective_count": self.collective_count,
            "collective_bytes": self.collective_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "overlap_score": self.overlap_score,
        }

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            **self.budget,
            "serialized_collectives": self.serialized_collectives,
            "by_op": dict(sorted(self.by_op.items())),
            "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "unpredicted_gathers": [list(s) for s in self.unpredicted_gathers],
            "witness_count": self.witness_count,
        }


class CommsWatcher:
    """Accumulates per-program comms budgets from profiled steps:
    ``watch()`` takes one program's trace and records its budget."""

    def __init__(self) -> None:
        self.programs: list[ProgramComms] = []

    def watch(
        self,
        name: str,
        trace: dict,
        prediction: StrategyPrediction | None = None,
        audited_file: str | None = None,
    ) -> ProgramComms:
        comms = program_comms(trace)
        unpredicted: list[tuple[int, ...]] = []
        if prediction is not None:
            seen: set[tuple[int, ...]] = set()
            for op in comms["ops"]:
                if op.op != "all-gather":
                    continue
                for shape in op.result_shapes:
                    if len(shape) == 0:
                        continue
                    if not prediction.predicts(shape) and shape not in seen:
                        seen.add(shape)
                        unpredicted.append(shape)
        program = ProgramComms(
            name=name,
            collective_count=comms["collective_count"],
            collective_bytes=comms["collective_bytes"],
            peak_hbm_bytes=comms["peak_hbm_bytes"],
            by_op=comms["by_op"],
            bytes_by_op=comms["bytes_by_op"],
            flops=comms["flops"],
            bytes_accessed=comms["bytes_accessed"],
            overlap_score=comms["overlap_score"],
            serialized_collectives=comms["serialized_collectives"],
            unpredicted_gathers=tuple(sorted(unpredicted)),
            audited_file=audited_file,
            witness_count=comms["witness_count"],
        )
        self.programs.append(program)
        return program

    def budgets(self) -> dict[str, dict]:
        return {p.name: p.budget for p in self.programs}


# --- committed budget (the ratchet's numbers) -------------------------------


def load_budget(path: Path | str = DEFAULT_BUDGET_PATH) -> dict | None:
    """The committed per-program budget, or None when not yet written."""
    p = Path(path)
    if not p.exists():
        return None
    data = json.loads(p.read_text())
    if not isinstance(data, dict) or "programs" not in data:
        return None
    return data


def write_budget(
    programs: list[ProgramComms],
    path: Path | str = DEFAULT_BUDGET_PATH,
    device_count: int | None = None,
    device: str = "cpu",
) -> dict:
    payload = {
        "device_count": device_count if device_count is not None else RANKS,
        "device": device,
        "programs": {p.name: p.budget for p in programs},
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return payload


def held_on(budget: dict | None, device: str) -> dict | None:
    """The part of ``budget`` a run on ``device`` is held to.  Counts and
    bytes hold on any device; ``overlap_score`` counts the ops on the
    issuing thread, which differ by device (on the card the autograd
    engine runs the backward on its own thread), so it holds only on the
    device type the budget was measured on."""
    import torch

    if budget is None or budget.get("device", "cpu") == torch.device(device).type:
        return budget
    return {**budget, "programs": {
        name: {k: v for k, v in b.items() if k != "overlap_score"}
        for name, b in budget["programs"].items()}}


# --- findings ---------------------------------------------------------------


def violations_for(
    programs: list[ProgramComms],
    budget: dict | None,
    device_count: int,
) -> list[Violation]:
    """Fold audited programs into baseline-ratchet findings (the JAX
    package's messages: count-free and shape-stable; DLC511 once per
    distinct unpredicted gather shape)."""
    out: list[Violation] = []
    budget_programs = {}
    if budget is not None and int(budget.get("device_count", -1)) == device_count:
        budget_programs = budget.get("programs", {})
    by_name = {p.name: p for p in programs}
    for p in programs:
        base = by_name.get(p.name[: -len("_overlap")]) if p.name.endswith(
            "_overlap"
        ) else None
        if base is not None and p.overlap_score <= base.overlap_score:
            out.append(
                Violation(
                    rule=AUDIT_RULE_OVERLAP,
                    path=p.audited_file or str(AUDITED_FILE),
                    line=1,
                    col=1,
                    message=(
                        f"serialized collective on the {p.name} path: the "
                        "bucketed program's overlap_score does not strictly "
                        f"exceed the monolithic {base.name} baseline's — the "
                        "explicit bucket schedule is buying no latency "
                        "hiding (parallel/overlap.py; comms-audit sentinel, "
                        "see docs/STATIC_ANALYSIS.md comms runbook)"
                    ),
                )
            )
    for p in programs:
        anchor = p.audited_file or str(AUDITED_FILE)
        for shape in p.unpredicted_gathers:
            out.append(
                Violation(
                    rule=AUDIT_RULE_UNPREDICTED,
                    path=anchor,
                    line=1,
                    col=1,
                    message=(
                        f"unpredicted all-gather on the {p.name} path: the "
                        f"compiled fsdp step gathers a {_dims(shape)} array "
                        "that matches no train-state leaf — fsdp predicts "
                        "parameter/optimizer gathers only, so a batch or "
                        "activation is being materialized replicated "
                        "(comms-audit sentinel; see docs/STATIC_ANALYSIS.md "
                        "comms runbook)"
                    ),
                )
            )
        committed = budget_programs.get(p.name)
        if committed is None:
            continue
        over_count = p.collective_count > int(committed["collective_count"])
        over_bytes = p.collective_bytes > int(committed["collective_bytes"])
        if over_count or over_bytes:
            grew = " and ".join(
                what
                for what, over in (
                    ("op count", over_count),
                    ("bytes", over_bytes),
                )
                if over
            )
            out.append(
                Violation(
                    rule=AUDIT_RULE_BUDGET,
                    path=anchor,
                    line=1,
                    col=1,
                    message=(
                        f"comms budget regression on the {p.name} path: "
                        f"collective {grew} exceed the committed budget "
                        "(scripts/comms_budget.json; re-measure with "
                        "scripts/comms_audit.py --write-budget if the "
                        "increase is intended — comms-audit sentinel, see "
                        "docs/STATIC_ANALYSIS.md comms runbook)"
                    ),
                )
            )
        committed_score = committed.get("overlap_score")
        if committed_score is not None and p.overlap_score < float(
            committed_score
        ):
            out.append(
                Violation(
                    rule=AUDIT_RULE_OVERLAP,
                    path=anchor,
                    line=1,
                    col=1,
                    message=(
                        f"overlap regression on the {p.name} path: the "
                        "compiled schedule's overlap_score fell below the "
                        "committed budget — a gradient-sync collective that "
                        "a bucket boundary could hide is now serialized "
                        "(scripts/comms_budget.json; re-measure with "
                        "scripts/comms_audit.py --write-budget if the drop "
                        "is intended — comms-audit sentinel, see "
                        "docs/STATIC_ANALYSIS.md comms runbook)"
                    ),
                )
            )
    return out


# --- the audit itself -------------------------------------------------------


@dataclass
class CommsAuditReport:
    programs: list[ProgramComms]
    violations: list[Violation]
    device_count: int
    budget_checked: bool
    measured: dict = field(default_factory=dict)
    backend: str = "gloo"
    # How multi_step and multi_step_dp_overlap ran: "captured" (one CUDA
    # graph over NCCL ranks) or "eager" (k steps, gloo ranks).
    multi_step_form: str = "eager"

    @property
    def replays_launch_nccl(self) -> bool:
        """Each captured program's replay launched one NCCL kernel a
        collective on every rank (True when nothing was captured)."""
        return all(m["replay_matches"] for m in self.measured.values() if m["form"] == "captured")

    def to_dict(self) -> dict:
        return {
            "programs": [p.to_dict() for p in self.programs],
            "budgets": {p.name: p.budget for p in self.programs},
            "violations": [v.to_dict() for v in self.violations],
            "device_count": self.device_count,
            "budget_checked": self.budget_checked,
            "clean": not self.violations,
            "backend": self.backend,
            "multi_step_form": self.multi_step_form,
            "replays_launch_nccl": self.replays_launch_nccl,
            "measured": self.measured,
        }


# The audit model is a fixed constant (the JAX audit's): changing any of
# these numbers changes the committed budget — regenerate it deliberately.
AUDIT_BATCH_SIZE = 16
AUDIT_HIDDEN = 256
AUDIT_CLASSES = 4
AUDIT_INPUT_SHAPE = (8, 8, 1)
PROGRAMS = ("train_step", "multi_step", "train_step_dp", "train_step_dp_overlap",
            "multi_step_dp_overlap", "serve_decode")
# Planted faults the tests use to prove the audit and its gates fire: an
# extra all-reduce, and an all-gather of the batch, in the train_step
# program (DLC510, DLC511); and, in train_step_dp_overlap, the last bucket's
# parameters left out of the bucketed sync (its bytes no longer the
# gradient tree's).  ``plant`` names one, or several joined by "+".
PLANTS = ("extra_allreduce", "batch_gather", "unsynced_bucket")
CAPTURE_RANGE = "CapturedSteps.capture"
# Set by run_ranks: seconds after which a rank writes its stacks (a stall's
# witness, ahead of the parent's timeout).
STACKS_ENV = "DLCFN_RANK_STACKS_S"


def default_backend(device: str) -> str:
    """The ranks' backend: NCCL, one card a rank, when ``device`` is the
    card and the host has a card for each of the ``RANKS`` ranks; gloo
    otherwise (the CPU, or every rank on cuda:0)."""
    import torch

    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= RANKS:
        return "nccl"
    return "gloo"


def multi_step_form(trainer) -> str:
    """How the audit runs ``trainer``'s multi-step program: "captured"
    (``multi_step_fn(k)`` as one CUDA graph, JAX's compiled program) when
    the trainer is on the card and its mesh's groups are NCCL's; "eager"
    (its k steps, one by one) otherwise: the CPU captures nothing, and a
    gloo group's collectives cannot be captured."""
    from deeplearning_cfn_tpu_torch.parallel.mesh import capture_refusal

    if trainer.device.type == "cuda" and capture_refusal(trainer.mesh, trainer.device) is None:
        return "captured"
    return "eager"


def _trainer(name: str, device: str):
    import torch

    from deeplearning_cfn_tpu_torch.analysis.compile_audit import audit_mlp
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    kwargs: dict[str, Any] = dict(learning_rate=0.05, optimizer="sgd",
                                  matmul_precision="float32")
    if name in ("train_step", "multi_step"):
        spec, kwargs["strategy"] = MeshSpec.fsdp_parallel(RANKS), "fsdp"
    else:
        spec, kwargs["strategy"] = MeshSpec.data_parallel(RANKS), "dp"
    if name.endswith("_overlap"):
        kwargs.update(comms_overlap=True, overlap_bucket_bytes=32 * 1024)
    if name == "multi_step_dp_overlap":
        kwargs["grad_accum_steps"] = 2
    inputs = AUDIT_INPUT_SHAPE[0] * AUDIT_INPUT_SHAPE[1] * AUDIT_INPUT_SHAPE[2]
    mesh = build_mesh(spec, device_type=torch.device(device).type)
    return Trainer(audit_mlp(AUDIT_HIDDEN, AUDIT_CLASSES, inputs),
                   TrainerConfig(**kwargs), device=device, mesh=mesh)


def _train_program(name: str, device: str, k: int, plant: str | None):
    """(state, run, form) of one train program: ``run()`` makes one call;
    ``form`` is :func:`multi_step_form`'s for the multi-step programs and
    "eager" for the single steps."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset, device_put_batch, Batch

    planted = set((plant or "").split("+"))
    trainer = _trainer(name, device)
    state = trainer.init(seed=0)
    if name == "train_step_dp_overlap" and "unsynced_bucket" in planted:
        sync = state.grad_sync
        sync.remove()
        state.grad_sync = overlap.BucketedGradSync(sync.members[:-1], sync.group, sync.nd)
    ds = SyntheticDataset(shape=AUDIT_INPUT_SHAPE, num_classes=AUDIT_CLASSES,
                          batch_size=AUDIT_BATCH_SIZE, seed=0)
    batches = list(ds.batches(k))
    if name.startswith("multi_step"):
        xs, ys = device_put_batch(Batch(x=np.stack([b.x for b in batches]),
                                        y=np.stack([b.y for b in batches])), trainer.device)
        form = multi_step_form(trainer)
        if form == "captured":
            kfn = trainer.multi_step_fn(k)

            def run():
                kfn(state, xs, ys)
        else:
            def run():
                # multi_step_fn's CPU form, on any device: its k steps.
                for i in range(k):
                    trainer.train_step(state, xs[i], ys[i])
        return state, run, form
    x, y = device_put_batch(batches[0], trainer.device)

    def run():
        trainer.train_step(state, x, y)
        if name != "train_step":
            return
        if "extra_allreduce" in planted:
            dist.all_reduce(torch.ones(4, device=trainer.device))
        if "batch_gather" in planted:
            out = torch.empty((RANKS * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous())
    return state, run, "eager"


def _serve_program(device: str):
    import numpy as np
    import torch

    from deeplearning_cfn_tpu_torch.models.llama import Llama, LlamaConfig
    from deeplearning_cfn_tpu_torch.serve.engine import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeRequest,
    )

    cfg = LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    model = Llama(cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    scfg = ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
    engine = ContinuousBatchingEngine(model, scfg, clock=lambda: 0.0, journal=False)
    engine.submit(ServeRequest("audit-0", np.arange(1, 9, dtype=np.int32), 16))
    engine.step()  # admits and prefills
    return None, engine.step, "eager"


def capture_records(records: list[dict]) -> list[dict]:
    """The records inside the ``CapturedSteps.capture`` range (on any
    thread: the backward runs on the autograd engine's): the ops the
    capture dispatched, which the graph holds."""
    spans = [r for r in records if r["name"] == CAPTURE_RANGE]
    if not spans:
        raise RuntimeError(f"the profiled call shows no {CAPTURE_RANGE} range: nothing captured")
    start, end = spans[0]["start"], spans[0]["end"]
    return [r for r in records
            if r["name"] != CAPTURE_RANGE and r["start"] >= start and r["end"] <= end]


def _profile_call(run, device: str, form: str = "eager") -> dict:
    """One program's trace.  Eager: a warm-up call (lazy init, the first
    step's one-off collectives), then one profiled call (CPU activity,
    shapes).  Captured: the first call, the capture, is the profiled one
    (its records cut to the capture's range), then one replay is profiled
    on the card for its NCCL kernels.  ``post_warmup_compiles`` counts the
    captures and builds after the warm-up (the capture)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.analysis.compile_audit import CompileWatcher

    cuda = torch.device(device).type == "cuda"
    captured = form == "captured"
    out: dict[str, Any] = {"form": form}
    with CompileWatcher() as watcher:
        if not captured:
            run()
            watcher.mark_steady()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                     profile_memory=not cuda) as prof:
            run()
            if cuda:
                torch.cuda.synchronize()
        records = trace_records(prof)
        if captured:
            watcher.mark_steady()
            records = capture_records(records)
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as replay:
                run()
                torch.cuda.synchronize()
            out["replay_nccl_kernels"] = {
                e.key[:100]: e.count for e in replay.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.key.startswith("nccl")}
        out["post_warmup_compiles"] = watcher.new_compiles_since_mark()
    out["records"] = records
    out["peak_hbm_bytes"] = int(torch.cuda.max_memory_allocated() if cuda
                                else trace_peak_bytes(prof))
    return out


def _grad_sync_report(state) -> dict | None:
    """The bucketed sync's coverage of the gradient tree: its buckets, the
    leaves and bytes they hold, beside the model's."""
    sync = getattr(state, "grad_sync", None)
    if sync is None:
        return None
    params = list(state.model.parameters())
    return {"buckets": len(sync.members),
            "bucket_leaves": sum(len(m) for m in sync.members),
            "bucket_bytes": sum(p.numel() * p.element_size() for m in sync.members for p in m),
            "tree_leaves": len(params),
            "tree_bytes": sum(p.numel() * p.element_size() for p in params)}


def _trace_program(name: str, device: str, k: int, plant: str | None) -> dict:
    """One program built and traced on this rank."""
    if name == "serve_decode":
        state, run, form = _serve_program(device)
    else:
        state, run, form = _train_program(name, device, k, plant)
    trace = _profile_call(run, device, form)
    gathers = None
    if state is not None and name in ("train_step", "multi_step"):
        gathers = sorted(list(s) for s in fsdp_gather_shapes(state.model))
    return {**trace, "predicted": gathers,
            "grad_sync": None if state is None else _grad_sync_report(state)}


def _rank_main(rank: int, port: int, out: str, device: str, k: int, plant: str | None,
               programs: tuple[str, ...] = PROGRAMS, backend: str = "gloo") -> None:
    """One rank of the audit: each of ``programs``, traced by
    :func:`_profile_call`.  ``serve_decode`` runs on rank 0 alone, before
    the rank joins the group (it needs none, and the other rank does not
    wait for it in a barrier).  Over NCCL, rank r runs on cuda:r.  Each
    program's trainer, state and captured graph live only inside
    :func:`_trace_program`: ``destroy_process_group`` blocks for good
    while a CUDA graph that holds the group's NCCL collectives is alive
    (both ranks, on four H100s), which is how an audit whose last
    program's graph outlived its loop never reported.  Writes
    ``<out>/rank<rank>.json``; a rank still running after
    ``$DLCFN_RANK_STACKS_S`` seconds writes its threads' stacks to its
    output."""
    import faulthandler
    import gc

    import torch
    import torch.distributed as dist

    stacks_after = float(os.environ.get(STACKS_ENV, "0"))
    if stacks_after > 0:
        faulthandler.dump_traceback_later(stacks_after)
    torch.set_num_threads(1)
    barrier: dict[str, Any] = {}
    if torch.device(device).type == "cuda":
        index = rank if backend == "nccl" else 0
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
        if backend == "nccl":
            barrier = {"device_ids": [index]}

    def traced(name: str) -> dict:
        trace = _trace_program(name, device, k, plant)
        print(f"comms-audit rank {rank}: {name} ({trace['form']}) traced", file=sys.stderr,
              flush=True)
        return trace

    result: dict[str, Any] = {}
    if rank == 0 and "serve_decode" in programs:
        result["serve_decode"] = traced("serve_decode")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=RANKS)
    try:
        for name in programs:
            if name != "serve_decode":
                result[name] = traced(name)
                dist.barrier(**barrier)
    finally:
        gc.collect()  # no captured graph may outlive its program (above)
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(result))


def run_ranks(out: str, device: str = "cuda", k: int = 2, plant: str | None = None,
              programs: tuple[str, ...] = PROGRAMS, backend: str = "gloo") -> list[dict]:
    """Run the audit's ranks as processes on this host, each one's output
    in ``<out>/rank<r>.log``; each rank's per-program traces.  The first
    rank that fails ends the run (the other would wait in a collective), as
    does ``RANK_TIMEOUT_S``; the error carries every rank's last output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO_ROOT), os.environ.get("PYTHONPATH")])),
        **{STACKS_ENV: str(RANK_TIMEOUT_S - 15)})
    logs = [Path(out, f"rank{r}.log") for r in range(RANKS)]
    procs = []
    errors = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for r in range(RANKS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "deeplearning_cfn_tpu_torch.analysis.comms_audit",
                     "--rank", str(r), str(port), out, device, str(k), plant or "-",
                     ",".join(programs), backend],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs) and not errors:
            errors = [f"comms-audit rank {r} exited {p.returncode}"
                      for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if not errors and time.monotonic() > deadline:
                errors = [f"comms-audit ranks still running after {RANK_TIMEOUT_S} s"]
            time.sleep(0.05)
        errors = errors or [f"comms-audit rank {r} exited {p.returncode}"
                            for r, p in enumerate(procs) if p.returncode]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    if errors:
        tails = "".join(f"\n--- rank {r}:\n{log.read_text()[-3000:]}" for r, log in enumerate(logs))
        raise RuntimeError("; ".join(errors) + tails)
    return [json.loads(Path(out, f"rank{r}.json").read_text()) for r in range(RANKS)]


def run_comms_audit(
    k: int = 2,
    journal: bool = True,
    budget_path: Path | str | None = DEFAULT_BUDGET_PATH,
    serve: bool = True,
    device: str = "cuda",
    plant: str | None = None,
    workdir: str | None = None,
    programs: tuple[str, ...] = PROGRAMS,
) -> CommsAuditReport:
    """Audit the real fsdp train step, the multi-step call, the serve
    decode step and the dp comms-overlap pair for collectives and memory,
    on 2 ranks (processes of this host) on ``device``: NCCL's or gloo's,
    as :func:`default_backend` picks.

    The dp pair is the overlap ratchet's proof surface: the SAME model,
    batch and ranks run at DDP's bucket size (``train_step_dp``) and
    through the bucketed sync (``train_step_dp_overlap``, and
    ``multi_step_dp_overlap`` with grad accumulation 2) — DLC512 requires
    the bucketed score to strictly exceed the monolithic one.  Both
    ranks' traces must show the same collectives, and each rank's
    backend must count as many as c10d issued (``measured`` holds the
    per-rank counts, each program's form, and for a captured program
    the NCCL kernels its replay launched on each rank).  ``plant`` (of
    ``PLANTS``, "+"-joined) adds faults; ``programs`` runs only some (the
    tests' plants)."""
    import tempfile

    backend = default_backend(device)
    with tempfile.TemporaryDirectory(dir=workdir) as out:
        ranks = run_ranks(out, device, k, plant, programs, backend)
    watcher = CommsWatcher()
    measured: dict[str, Any] = {}
    for name in programs:
        if name == "serve_decode" and not serve:
            continue
        traces = [r[name] for r in ranks if name in r]
        comms = [program_comms({"records": t["records"], "world": RANKS,
                                "peak_hbm_bytes": t["peak_hbm_bytes"]}) for t in traces]
        form = traces[0]["form"]
        nccl = [sum(t.get("replay_nccl_kernels", {}).values()) for t in traces]
        measured[name] = {
            "form": form,
            "rank_counts": [p["collective_count"] for p in comms],
            "rank_bytes": [p["collective_bytes"] for p in comms],
            "witness_counts": [p["witness_count"] for p in comms],
            "rank_peak_bytes": [p["peak_hbm_bytes"] for p in comms],
            "gathers": sorted({tuple(s) for op in comms[0]["ops"]
                               if op.op == "all-gather" for s in op.result_shapes if s}),
            "predicted": traces[0].get("predicted"),
            # What the overlap score averages: each collective's slack.
            "slack": trace_slack(traces[0]["records"]),
            "post_warmup_compiles": [t["post_warmup_compiles"] for t in traces],
            "grad_sync": traces[0]["grad_sync"],
            "replay_nccl_kernels": [t.get("replay_nccl_kernels") for t in traces],
            "replay_matches": form != "captured" or nccl == [p["collective_count"] for p in comms],
        }
        predicted = traces[0].get("predicted")
        prediction = (StrategyPrediction(frozenset(tuple(s) for s in predicted))
                      if predicted is not None else None)
        watcher.watch(
            name,
            {"records": traces[0]["records"], "world": RANKS,
             "peak_hbm_bytes": traces[0]["peak_hbm_bytes"]},
            prediction=prediction,
            audited_file=str(SERVE_AUDITED_FILE) if name == "serve_decode" else None,
        )
    budget = load_budget(budget_path) if budget_path is not None else None
    budget = held_on(budget, device)
    violations = violations_for(watcher.programs, budget, device_count=RANKS)
    forms = {m["form"] for n, m in measured.items() if n.startswith("multi_step")}
    report = CommsAuditReport(
        programs=watcher.programs,
        violations=violations,
        device_count=RANKS,
        budget_checked=bool(budget is not None and int(budget.get("device_count", -1)) == RANKS),
        measured=measured,
        backend=backend,
        multi_step_form="captured" if forms == {"captured"} else "eager",
    )
    if journal:
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

        get_recorder().record(
            "comms_audit",
            clean=not violations,
            device_count=RANKS,
            programs={p.name: p.to_dict() for p in watcher.programs},
        )
    return report


def main(argv: list[str] | None = None) -> int:
    """``python -m deeplearning_cfn_tpu_torch.analysis.comms_audit [--device
    cpu] [--write-budget]``: print the report; exit 1
    on findings the baseline does not hold (0 after ``--write-budget``),
    or when a captured program's replay did not launch its NCCL kernels."""
    import argparse

    import torch

    from deeplearning_cfn_tpu_torch.analysis.collectives import AUDIT_RULE_IDS
    from deeplearning_cfn_tpu_torch.analysis.runner import apply_audit_baseline

    ap = argparse.ArgumentParser(prog="comms_audit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--write-budget", action="store_true", dest="write_budget")
    args = ap.parse_args(argv)
    report = run_comms_audit(device=args.device)
    if args.write_budget:
        write_budget(report.programs, device=torch.device(args.device).type)
    fresh, stale = apply_audit_baseline(report.violations, None, AUDIT_RULE_IDS)
    print(json.dumps({**report.to_dict(), "fresh": [v.to_dict() for v in fresh],
                      "stale": [list(e) for e in stale]}, indent=2))
    if not report.replays_launch_nccl:
        return 1
    return 1 if fresh and not args.write_budget else 0


if __name__ == "__main__":
    if len(sys.argv) == 10 and sys.argv[1] == "--rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                   int(sys.argv[6]), None if sys.argv[7] == "-" else sys.argv[7],
                   tuple(sys.argv[8].split(",")), sys.argv[9])
    else:
        sys.exit(main())
