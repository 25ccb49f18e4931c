"""Perf-smoke gate of the port: twelve structural stages, in the order of
the JAX package's ``scripts/perf_smoke.py``, each over
``deeplearning_cfn_tpu_torch``.

1. ``pipeline``: the uint8 synthetic stream through
   ``DevicePrefetcher(workers=2)`` moves exactly its images' and labels'
   bytes, fewer than the float32 stream of the same shape; the batches land
   on the chosen device in their dtype, and ``dequantize_normalize``
   inverts the quantisation.
2. ``profiler``: ``Trainer.fit`` profiles nothing by default, a disabled
   profiler's ``wrap_source`` is the identity, and ``StepProfiler`` costs
   under 2% of a ~1 ms matmul step (the median over three passes of
   bare and profiled steps side by side; on the card each step
   synchronises, so the step's time is the device's), and its own
   bookkeeping, timed with no step, under 2% of the bare step; its step-time
   quantiles are ordered and under a loose ceiling, and its phases are
   present.
3. ``input_overlap``: stacked uint8 batches stay >= 2 deep on the device
   behind the one in hand, every consumed stack is freed by
   ``donate_buffers``, and the consumer, ``Trainer.multi_step_fn`` of a
   small MLP, holds one program after its warm-up: one CUDA-graph capture
   on the card and none on the CPU (where the k steps run eagerly), and
   none after the warm-up.
4. ``serve``: the continuous-batching engine on a virtual clock: no
   request lost, the slots never overfilled, no request starved past a
   step bound, no capture after the warm-up.
5. ``broker_failover``: the 1k-agent warm-standby soak: no lost
   ``INSTANCE_TERMINATE``, re-sends exactly once, bounded replay lag.
6. ``fleet_sim``: the 10k-agent sharded soak, twice at one seed: exactly
   once, no degraded pair, byte-equal runs, no sleep.
7. ``telemetry``: a TELEM snapshot is O(entries), its summaries cut at the
   wire cap, non-finite gauges null.
8. ``datastream``: per-host shard assignment is an exact partition, one
   epoch reads every record once, and the async checkpointer's ``save()``
   never blocks a step while its writer is parked on a gate.
9. ``sched``: placement is a pure function of its inputs under permuted
   submission, its quotas hold, and ``sched/`` reads no wall clock.
10. ``comms``: the audited fsdp train step's collective bytes on the comms
    audit's two ranks equal ``analysis/comms_budget.json``'s exactly.
11. ``comms_overlap``: the bucketed dp program's overlap score strictly
    beats the dp step's on the same ranks, its buckets hold exactly the
    gradient tree, and neither program captures or builds after its
    warm-up.
12. ``determinism``: a double run of the replay sentinel (one scenario and
    a small failover soak) is byte-equal, never sleeps, and stays inside a
    wall budget.

Wall clock is read only as the JAX script reads it: a ratio with a wide
margin (stage 2, over steps timed side by side), a loose ceiling (stages
2 and 12).

    python -m deeplearning_cfn_tpu_torch.scripts.perf_smoke [--device cpu]

runs on the card unless ``--device cpu`` is passed.  Exit 0 and one JSON
line (the JAX script's top-level keys) on success; exit 1 with every
violation named on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]

BATCH = 8
IMAGE = 32
STEPS = 6
WORKERS = 2


def _cuda(device: str) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def _sync(device: str) -> None:
    import torch

    if _cuda(device):
        torch.cuda.synchronize()


def run_pipeline(dtype: str, device: str) -> tuple[dict, Any, int]:
    """The synthetic stream of ``dtype`` through the prefetcher: its
    counters, the last batch's images, and the batches consumed."""
    from deeplearning_cfn_tpu_torch.train.data import DevicePrefetcher, SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.pipeline import PipelineStats

    ds = SyntheticDataset(shape=(IMAGE, IMAGE, 3), num_classes=10, batch_size=BATCH,
                          dtype=dtype, pool_batches=3)
    stats = PipelineStats(name=f"smoke-{dtype}")
    prefetcher = DevicePrefetcher(ds.batches(STEPS), device, size=2, workers=WORKERS,
                                  stats=stats)
    last_x = None
    n = 0
    try:
        for batch in prefetcher:
            last_x = batch.x
            n += 1
    finally:
        prefetcher.close()
    return stats.snapshot(), last_x, n


def pipeline(device: str) -> tuple[dict, list[str]]:
    """Stage 1: the compact-dtype input path (the JAX script's ``main``
    gate over ``run_pipeline``)."""
    import torch

    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.pipeline import dequantize_normalize

    u8_snap, u8_x, u8_n = run_pipeline("uint8", device)
    f32_snap, f32_x, f32_n = run_pipeline("float32", device)
    failures = []
    for dtype, n in (("uint8", u8_n), ("float32", f32_n)):
        if n != STEPS:
            failures.append(f"{dtype}: consumed {n} batches, expected {STEPS}")
    if u8_x.dtype != torch.uint8:
        failures.append(f"uint8 pipeline delivered {u8_x.dtype} to the device")
    if f32_x.dtype != torch.float32:
        failures.append(f"float32 baseline delivered {f32_x.dtype}")
    want = torch.device(device).type
    for x in (u8_x, f32_x):
        if x.device.type != want:
            failures.append(f"the prefetcher delivered a batch on {x.device}, not on {want}")
    if u8_snap["batches"] != STEPS or f32_snap["batches"] != STEPS:
        failures.append(
            f"batch counters diverged: u8={u8_snap['batches']} "
            f"f32={f32_snap['batches']} expected={STEPS}"
        )
    # THE gate: the compact path moves strictly fewer bytes than the float32
    # baseline at identical shapes (int32 labels are shared payload).
    if not u8_snap["bytes_transferred"] < f32_snap["bytes_transferred"]:
        failures.append(
            f"compact-dtype path not taken: uint8 moved {u8_snap['bytes_transferred']} "
            f"bytes vs float32 {f32_snap['bytes_transferred']}"
        )
    image_bytes_u8 = STEPS * BATCH * IMAGE * IMAGE * 3
    label_bytes = STEPS * BATCH * 4
    if u8_snap["bytes_transferred"] != image_bytes_u8 + label_bytes:
        failures.append(
            f"uint8 byte counter {u8_snap['bytes_transferred']} != expected "
            f"{image_bytes_u8 + label_bytes} (images + int32 labels)"
        )
    # The in-step dequantize inverts the quantization: the dequantized uint8
    # stream's mean tracks the float stream's.
    ds = SyntheticDataset(shape=(IMAGE, IMAGE, 3), num_classes=10, batch_size=BATCH,
                          dtype="uint8")
    mean, std = ds.input_stats
    dq = dequantize_normalize(u8_x, mean, std).float().cpu().numpy()
    if not np.isfinite(dq).all() or abs(float(dq.mean())) > 1.0:
        failures.append(f"dequantized stream off-distribution (mean {dq.mean():.3f})")
    return {
        "uint8": u8_snap,
        "float32": f32_snap,
        "bytes_ratio": round(u8_snap["bytes_transferred"] / f32_snap["bytes_transferred"], 4),
        "workers": WORKERS,
    }, failures


PROFILE_STEPS = 30
PROFILE_REPEATS = 3
OVERHEAD_BUDGET = 0.02  # enabling the profiler may cost <2% of step time
STEP_P99_CEILING_MS = 2000.0
# The square f32 matmul of one profiled step.  On the card it is sized as
# JAX sized its own, to ~1 ms (2816 on an H100, TF32 off), so that the
# budget is ~20 us against the profiler's microseconds of bookkeeping.  On
# the CPU it is JAX's 1024, on one thread whatever the host's cores (~20 ms):
# a ~1 ms step there moves by tens of microseconds between pairs.
PROFILE_MATMUL = {"cpu": 1024, "cuda": 2816}
BOOKKEEPING_STEPS = 1000  # profiler-only steps a pass of ``profiler_bookkeeping``


def profiler_bookkeeping() -> float:
    """StepProfiler's whole cost a step, in seconds, with no step to time:
    ``phase()`` around nothing and ``step_done()``, in a tight loop, then
    the read that folds what the loop queued (the median of three passes
    of ``BOOKKEEPING_STEPS``).  The pairs of ``profiler_overhead`` read
    what a step pays inside its loop; this reads the folding too, which
    the profiler does in batches, past most steps."""
    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler

    prof = StepProfiler(name="perf_smoke_bookkeeping")
    passes = []
    for _ in range(PROFILE_REPEATS):
        prof.start()
        t0 = time.perf_counter()
        for i in range(BOOKKEEPING_STEPS):
            with prof.phase("dispatch"):
                pass
            prof.step_done(step=i)
        prof.recent_step_ms()
        passes.append((time.perf_counter() - t0) / BOOKKEEPING_STEPS)
    return sorted(passes)[len(passes) // 2]


def profiler_overhead(device: str) -> dict:
    """StepProfiler's cost against the bare step.  The step (a square f32
    matmul, ``PROFILE_MATMUL``; on the card it synchronises) dwarfs the
    profiler's microseconds of bookkeeping, so the 2% budget is a wide
    structural margin.  Each of three passes runs
    ``PROFILE_STEPS`` pairs: the step bare and the step inside the
    profiler's calls, side by side, in alternating order, each timed; the
    overhead is the median over the pairs of the profiled step's time over
    the bare one's.  Side by side the two see the same host (its clock
    rate, its other load), which two loops run one after the other do not:
    the JAX script's median of three loops moves by several percent on a
    loaded host.  ``bookkeeping_us`` is ``profiler_bookkeeping``'s cost a
    step and ``pair_extra_us`` the median of the pairs' differences: the
    same cost, read without and with the step.  Also returns the
    profiler's snapshot for the step-time sentinel."""
    import torch

    n = PROFILE_MATMUL[torch.device(device).type]
    threads = torch.get_num_threads()
    if not _cuda(device):
        torch.set_num_threads(1)
    try:
        return _profiler_pairs(device, n)
    finally:
        torch.set_num_threads(threads)


def _profiler_pairs(device: str, n: int) -> dict:
    import statistics

    import torch

    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler

    a = torch.ones((n, n), dtype=torch.float32, device=device)

    def step(x):
        out = x @ x
        _sync(device)
        return out

    step(a)  # cuBLAS's handle and workspace outside every timed window
    prof = StepProfiler(name="perf_smoke")
    pairs: list[tuple[float, float]] = []
    out = a
    for _ in range(PROFILE_REPEATS):
        for i in range(PROFILE_STEPS):
            bare = profiled = 0.0
            for with_profiler in ((False, True) if i % 2 == 0 else (True, False)):
                if with_profiler:
                    prof.start()  # a loop's entry (once a loop): not a step's cost
                    t0 = time.perf_counter()
                    with prof.phase("dispatch"):
                        out = step(out)
                    prof.step_done(step=i)
                    profiled = time.perf_counter() - t0
                else:
                    t0 = time.perf_counter()
                    out = step(out)
                    bare = time.perf_counter() - t0
            pairs.append((bare, profiled))
        with prof.sync_boundary(PROFILE_STEPS):
            _sync(device)
    return {
        "matmul": n,
        "bare_s": round(sum(b for b, _ in pairs), 6),
        "profiled_s": round(sum(q for _, q in pairs), 6),
        "overhead_fraction": round(statistics.median(q / b for b, q in pairs) - 1.0, 6),
        "bare_step_ms": round(statistics.median(b for b, _ in pairs) * 1e3, 6),
        "bookkeeping_us": round(profiler_bookkeeping() * 1e6, 3),
        "pair_extra_us": round(statistics.median(q - b for b, q in pairs) * 1e6, 3),
        "snapshot": prof.snapshot(),
    }


def profiler(device: str) -> tuple[dict, list[str]]:
    """Stage 2: profiling is off by default, costs <2% when on, and its
    step-time quantiles are sane."""
    import inspect

    from deeplearning_cfn_tpu_torch.obs.profiler import NULL_PROFILER
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    failures = []
    if inspect.signature(Trainer.fit).parameters["profiler"].default is not None:
        failures.append("Trainer.fit profiles by default (profiler default != None)")
    probe = iter(())
    if NULL_PROFILER.wrap_source(probe) is not probe:
        failures.append("disabled profiler wraps the batch source (overhead when off)")
    overhead = profiler_overhead(device)
    if overhead["overhead_fraction"] >= OVERHEAD_BUDGET:
        failures.append(
            f"StepProfiler overhead {overhead['overhead_fraction']:.2%} "
            f">= {OVERHEAD_BUDGET:.0%} budget "
            f"(bare {overhead['bare_s']}s vs profiled {overhead['profiled_s']}s)"
        )
    # The same budget over the profiler's own cost, read with no step.
    if overhead["bookkeeping_us"] >= OVERHEAD_BUDGET * overhead["bare_step_ms"] * 1e3:
        failures.append(
            f"StepProfiler bookkeeping {overhead['bookkeeping_us']}us a step "
            f">= {OVERHEAD_BUDGET:.0%} of the bare {overhead['bare_step_ms']}ms step"
        )
    # Distribution shape, not raw speed: the quantiles are ordered and p99
    # of a millisecond-scale step stays under a deliberately loose ceiling.
    snap = overhead["snapshot"]
    p50, p99 = snap["step_ms"].get("p50"), snap["step_ms"].get("p99")
    if p50 is None or p99 is None or not (0 < p50 <= p99):
        failures.append(f"step-time quantiles malformed: p50={p50} p99={p99}")
    elif p99 > STEP_P99_CEILING_MS:
        failures.append(f"step-time p99 {p99}ms blew the {STEP_P99_CEILING_MS:.0f}ms "
                        "sentinel bound")
    for phase in ("dispatch", "compute", "host"):
        if phase not in snap["phases"]:
            failures.append(f"profiler snapshot missing phase {phase!r}")
    return {
        "profiler_overhead": {k: v for k, v in overhead.items() if k != "snapshot"},
        "step_ms": snap["step_ms"],
    }, failures


OVERLAP_K = 2        # batches per stacked multi-step call
OVERLAP_CALLS = 5    # stacks consumed by the stage
OVERLAP_BUFFER = 2   # DevicePrefetcher depth: the double buffer
OVERLAP_HIDDEN = 32  # the consumer MLP's width


def input_overlap(device: str) -> tuple[dict, list[str]]:
    """Stage 3: stacked uint8 batches through ``DevicePrefetcher`` into
    ``Trainer.multi_step_fn(OVERLAP_K)``, as ``Trainer.fit`` feeds a
    stacked call: (1) the prefetcher keeps >= 2 stacks on the device while
    one is consumed (``buffered()``); (2) every consumed stack's storage is
    freed by ``donate_buffers``; (3) the consumer builds one program at its
    warm-up, a ``CapturedSteps`` capture on the card (the CPU captures
    nothing), and none after it."""
    from deeplearning_cfn_tpu_torch.analysis.compile_audit import CompileWatcher, audit_mlp
    from deeplearning_cfn_tpu_torch.train.data import (
        DevicePrefetcher,
        SyntheticDataset,
        donate_buffers,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import CapturedSteps, Trainer, TrainerConfig

    failures: list[str] = []
    ds = SyntheticDataset(shape=(IMAGE, IMAGE, 3), num_classes=10, batch_size=BATCH,
                          dtype="uint8")
    trainer = Trainer(audit_mlp(OVERLAP_HIDDEN, 10, IMAGE * IMAGE * 3),
                      TrainerConfig(learning_rate=0.05, optimizer="sgd",
                                    input_stats=ds.input_stats), device=device)
    state = trainer.init(seed=0)
    consume = trainer.multi_step_fn(OVERLAP_K)
    stacks = stack_batches(ds.batches(OVERLAP_CALLS * OVERLAP_K), OVERLAP_K)
    prefetcher = DevicePrefetcher(stacks, device, size=OVERLAP_BUFFER, workers=WORKERS)
    peak_resident = 0
    donated_bytes = 0
    calls = 0
    warmup: dict[str, int] = {}
    losses = None
    try:
        with CompileWatcher(owners=[CapturedSteps]) as watcher:
            for i, stack in enumerate(prefetcher):
                if i == 0:
                    # Let the producers refill behind the stack in hand so the
                    # double buffer is observable.
                    deadline = time.monotonic() + 10.0
                    while (len(prefetcher.buffered()) < OVERLAP_BUFFER
                           and time.monotonic() < deadline):
                        time.sleep(0.001)
                peak_resident = max(peak_resident, 1 + len(prefetcher.buffered()))
                state, losses = consume(state, stack.x, stack.y)
                if i == 0:
                    losses.tolist()
                    warmup = dict(watcher.compiles)
                    watcher.mark_steady()
                # Free the consumed stack once its call is issued (the
                # prefetcher marked it used on the compute stream, so its
                # memory is not handed out before the call has read it).
                donated_bytes += donate_buffers((stack.x, stack.y))
                if stack.x.untyped_storage().nbytes() or stack.y.untyped_storage().nbytes():
                    failures.append("consumed stack leaves survive donate_buffers "
                                    "(storage not freed) — stacks would accumulate on the device")
                calls += 1
            if losses is not None:
                losses.tolist()
            retraces = watcher.new_compiles_since_mark()
    finally:
        prefetcher.close()
    if calls != OVERLAP_CALLS:
        failures.append(f"overlap stage consumed {calls} stacks, expected {OVERLAP_CALLS}")
    if peak_resident < 2:
        failures.append(
            f"prefetcher never held 2 device-resident stacks (peak {peak_resident}) "
            "— no overlap to hide transfers behind"
        )
    expected_warmup = 1 if _cuda(device) else 0
    if sum(warmup.values()) != expected_warmup:
        failures.append(f"the consumer's warm-up built {warmup}, expected "
                        f"{expected_warmup} capture(s) on {device}")
    if retraces:
        failures.append(f"overlap consumer recompiled after warmup: {sorted(retraces)}")
    expected_stack_bytes = OVERLAP_CALLS * OVERLAP_K * BATCH * (IMAGE * IMAGE * 3 + 4)
    if donated_bytes != expected_stack_bytes:
        failures.append(
            f"donated bytes {donated_bytes} != expected {expected_stack_bytes} "
            "(uint8 images + int32 labels across every consumed stack)"
        )
    return {
        "steps_per_call": OVERLAP_K,
        "calls": calls,
        "device_resident_stacks_peak": peak_resident,
        "donated_bytes": donated_bytes,
        "warmup_captures": sum(warmup.values()),
        "post_warmup_compiles": len(retraces),
    }, failures


SERVE_REQUESTS = 40
SERVE_STARVATION_BOUND = 80  # scheduler steps a queued request may wait


def serve_scheduler(device: str) -> tuple[dict, list[str]]:
    """Stage 4: seeded mixed-length traffic through one continuous-batching
    engine on a virtual clock: occupancy never exceeds the slot count,
    FIFO admission starves no request past the step bound, every accepted
    request completes, and the decode path captures nothing after its
    warm-up (on the card the engine captures its decode step once, at
    construction)."""
    import torch

    from deeplearning_cfn_tpu_torch.analysis.compile_audit import CompileWatcher
    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.models.llama import Llama, LlamaConfig
    from deeplearning_cfn_tpu_torch.serve.engine import (
        CapturedDecode,
        ContinuousBatchingEngine,
        ServeConfig,
        ServeRequest,
    )
    from deeplearning_cfn_tpu_torch.serve.loadgen import TrafficConfig, run_load

    failures: list[str] = []
    cfg = LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    model = Llama(cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    scfg = ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
    clock = VirtualClock()
    engine = ContinuousBatchingEngine(model, scfg, clock=clock, journal=False)
    # Warm-up: one request runs the prefill and decode paths once.
    engine.submit(ServeRequest("warm", np.array([1, 2, 3], np.int32), 4))
    while engine.pending():
        engine.step()

    occupancy_ok = True

    def watch_occupancy(_step: int) -> None:
        nonlocal occupancy_ok
        occupancy_ok = occupancy_ok and engine.active_slots <= scfg.num_slots

    with CompileWatcher(owners=[CapturedDecode]) as watcher:
        watcher.mark_steady()
        report = run_load(engine, TrafficConfig(requests=SERVE_REQUESTS, seed=0), clock,
                          on_step=watch_occupancy)
        retraces = watcher.new_compiles_since_mark()
    snap = engine.snapshot()
    if report.completed != SERVE_REQUESTS:
        failures.append(f"serve scheduler lost requests: {report.completed}/{SERVE_REQUESTS}")
    if not occupancy_ok:
        failures.append(f"serve scheduler overfilled its {scfg.num_slots} slots")
    if snap["max_wait_steps"] > SERVE_STARVATION_BOUND:
        failures.append(
            f"serve scheduler starved a request for {snap['max_wait_steps']} "
            f"steps (bound {SERVE_STARVATION_BOUND})"
        )
    if retraces:
        failures.append(f"serve decode retraced after warmup: {sorted(retraces)}")
    return {
        "requests": SERVE_REQUESTS,
        "completed": report.completed,
        "steps": report.steps,
        "max_wait_steps": snap["max_wait_steps"],
        "recycled_blocks": snap["recycled_blocks"],
        "post_warmup_compiles": len(retraces),
    }, failures


BROKER_SOAK_AGENTS = 1000
BROKER_SOAK_SENDERS = 100


def broker_soak(device: str) -> tuple[dict, list[str]]:
    """Stage 5: the 1k-agent warm-standby soak on a virtual clock (primary
    killed mid-term, standby promoted, clients blind-re-send): every killed
    agent's INSTANCE_TERMINATE fires exactly once across the failover, the
    re-send storm lands exactly once, the promoted standby replays every
    shipped journal entry, and a clean failover fences no write."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import soak_failover

    failures: list[str] = []
    soak = soak_failover(agents=BROKER_SOAK_AGENTS, seed=0)
    if soak["lost_terminates"]:
        failures.append(f"broker failover lost {soak['lost_terminates']} "
                        "INSTANCE_TERMINATE events")
    for kind in ("spurious", "duplicate", "premature"):
        if soak[f"{kind}_terminates"]:
            failures.append(f"broker failover produced {soak[f'{kind}_terminates']} "
                            f"{kind} terminates")
    if soak["duplicate_sends"] or soak["work_depth"] != BROKER_SOAK_SENDERS:
        failures.append(
            f"idempotent re-send not exactly-once: depth {soak['work_depth']}/"
            f"{BROKER_SOAK_SENDERS}, {soak['duplicate_sends']} duplicates"
        )
    # Bounded replay lag: journaled minus replayed is exactly the tail the
    # kill left unshipped, never more.
    if soak["replayed_seq"] != soak["journaled_seq"] - soak["unshipped_at_kill"]:
        failures.append(
            f"standby replay lag unbounded: replayed {soak['replayed_seq']} of "
            f"{soak['journaled_seq']} journaled ({soak['unshipped_at_kill']} unshipped at kill)"
        )
    if soak["fenced_writes"]:
        failures.append(f"clean failover fenced {soak['fenced_writes']} writes")
    if soak["client_failovers"] != BROKER_SOAK_SENDERS:
        failures.append(f"client failover count {soak['client_failovers']} != "
                        f"{BROKER_SOAK_SENDERS} senders")
    return soak, failures


FLEET_SIM_AGENTS = 10_000
FLEET_SIM_SHARDS = 8


class _CountingSleep:
    """``time.sleep`` replaced by one that counts its calls, for a block."""

    def __init__(self) -> None:
        self.calls = 0
        self._real: Callable[[float], None] = time.sleep

    def _sleep(self, seconds: float) -> None:
        self.calls += 1
        self._real(seconds)

    def __enter__(self) -> "_CountingSleep":
        time.sleep = self._sleep
        return self

    def __exit__(self, *exc: Any) -> None:
        time.sleep = self._real


def fleet_sim(device: str) -> tuple[dict, list[str]]:
    """Stage 6: :func:`soak_fleet` twice at one seed on a VirtualClock
    (concurrent multi-shard failovers, a split brain, re-provision races):
    (1) exactly-once delivery and no lost or spurious INSTANCE_TERMINATE at
    10k agents, (2) no shard pair left degraded, (3) both runs serialize to
    identical JSON, and (4) the hot loop never sleeps."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import soak_fleet

    failures: list[str] = []
    with _CountingSleep() as sleeps:
        first = soak_fleet(agents=FLEET_SIM_AGENTS, shards=FLEET_SIM_SHARDS, seed=0)
        second = soak_fleet(agents=FLEET_SIM_AGENTS, shards=FLEET_SIM_SHARDS, seed=0)
    if sleeps.calls:
        failures.append(f"fleet sim hot loop slept {sleeps.calls} time(s) — the soak "
                        "must wait on the VirtualClock only")
    serialized = json.dumps(first, sort_keys=True, allow_nan=False)
    if serialized != json.dumps(second, sort_keys=True, allow_nan=False):
        diff = {k for k in set(first) | set(second) if first.get(k) != second.get(k)}
        failures.append(f"fleet sim not byte-deterministic at seed 0: fields {sorted(diff)}")
    if first["lost_terminates"] or first["terminated"] != first["killed"]:
        failures.append(
            f"fleet sim lost terminates: {first['terminated']} of {first['killed']} killed "
            f"agents terminated ({first['lost_terminates']} lost)"
        )
    for kind in ("spurious", "duplicate", "premature"):
        if first[f"{kind}_terminates"]:
            failures.append(f"fleet sim produced {first[f'{kind}_terminates']} "
                            f"{kind} terminates")
    expected = first["senders"] + first["stale_writes"]
    if first["duplicate_sends"] or first["delivered"] != expected:
        failures.append(
            f"fleet sim delivery not exactly-once: {first['delivered']} delivered of "
            f"{expected} sent, {first['duplicate_sends']} duplicates"
        )
    if first["degraded_pairs"]:
        failures.append(f"fleet sim left {first['degraded_pairs']} shard pair(s) "
                        "degraded after auto-heal")
    if first["diverged_entries"]:
        failures.append(f"split-brain shard diverged by {first['diverged_entries']} "
                        "entries past the fence")
    if first["unaffected_shard_failovers"]:
        failures.append(f"failovers leaked across shards: "
                        f"{first['unaffected_shard_failovers']} client failovers on healthy "
                        "shards")
    return first, failures


TELEM_GAUGES = 12
TELEM_OVERSIZE_SAMPLES = 4096


def telemetry_overhead(device: str) -> tuple[dict, list[str]]:
    """Stage 7: the TELEM payload rides the heartbeat path, so its cost
    model holds by construction: exactly the gauges handed in, summaries
    cut to MAX_SUMMARY_SAMPLES, non-finite values null, and a size bounded
    per entry, not by run length."""
    from deeplearning_cfn_tpu_torch.obs.aggregator import (
        MAX_SUMMARY_SAMPLES,
        FleetAggregator,
        agent_snapshot,
        decode_snapshot,
        encode_snapshot,
    )

    failures: list[str] = []
    gauges = {f"dlcfn_fleet_gauge_probe_{i}": float(i) for i in range(TELEM_GAUGES)}
    gauges["dlcfn_serve_tokens_per_s"] = float("nan")
    payload = encode_snapshot(agent_snapshot(
        gauges=gauges,
        summaries={"dlcfn_step_ms": [float(i) for i in range(TELEM_OVERSIZE_SAMPLES)]},
    ))
    body = decode_snapshot(payload)
    if body is None:
        failures.append("telemetry snapshot failed to round-trip")
        return {}, failures
    if len(body["gauges"]) != len(gauges):
        failures.append(f"telemetry gauge count amplified: {len(body['gauges'])} != "
                        f"{len(gauges)}")
    if body["gauges"]["dlcfn_serve_tokens_per_s"] is not None:
        failures.append("non-finite gauge escaped json_safe onto the wire")
    shipped = len(body["summaries"]["dlcfn_step_ms"])
    if shipped != MAX_SUMMARY_SAMPLES:
        failures.append(f"summary samples not truncated: shipped {shipped}, "
                        f"cap {MAX_SUMMARY_SAMPLES}")
    # O(entries): a generous per-entry byte budget (name + float + JSON
    # punctuation), independent of the 4096 samples accumulated.
    entries = len(gauges) + MAX_SUMMARY_SAMPLES
    budget = 64 * entries + 256
    if len(payload) > budget:
        failures.append(f"telemetry payload {len(payload)}B over the structural budget "
                        f"{budget}B for {entries} entries")
    # The controller-side merge stays a pure fold of its input table.
    agg = FleetAggregator().merge({"g/0": (1.0, 1, payload), "g/1": (1.0, 1, payload)})
    if agg["hosts"] != 2 or agg["summaries"]["dlcfn_step_ms"]["count"] != 2 * MAX_SUMMARY_SAMPLES:
        failures.append("fleet merge dropped or duplicated snapshot samples")
    return {
        "gauges": len(gauges),
        "samples_shipped": shipped,
        "samples_accumulated": TELEM_OVERSIZE_SAMPLES,
        "payload_bytes": len(payload),
        "payload_budget_bytes": budget,
    }, failures


DATASTREAM_SHARDS = 4
DATASTREAM_HOSTS = ("host-a", "host-b")
GATE_TIMEOUT_S = 30.0


def datastream(device: str) -> tuple[dict, list[str]]:
    """Stage 8: (1) the per-host shard assignment is an exact partition of
    the shards for every epoch probed; (2) draining one epoch across the
    hosts reads every record exactly once (record ids are baked into the
    shards: ``sorted(seen) == range(total)``); (3) the async sharded
    checkpointer never blocks a step, by construction: its writer parks on
    a gate while the step path keeps saving, so nothing lands while the
    gate is closed, latest-wins supersedes the middle save, and releasing
    the gate commits exactly the first-picked and last-saved steps."""
    import os
    import shutil
    import tempfile
    import threading

    from deeplearning_cfn_tpu_torch.train.datastream import (
        AsyncShardedCheckpointer,
        HostShardStream,
        assign_shards,
    )
    from deeplearning_cfn_tpu_torch.train.records import Field, RecordSpec, write_records

    failures: list[str] = []
    for epoch in range(3):
        assigned = assign_shards(DATASTREAM_HOSTS, DATASTREAM_SHARDS, seed=7, epoch=epoch)
        flat = sorted(s for w in assigned.values() for s in w)
        if flat != list(range(DATASTREAM_SHARDS)):
            failures.append(f"epoch {epoch}: shard assignment is not an exact partition: "
                            f"{assigned}")

    spec = RecordSpec((Field("x", "uint8", (1,)), Field("y", "int32", ())))
    root = Path(tempfile.mkdtemp(prefix="dlcfn-perf-datastream-"))
    try:
        gid = 0
        paths = []
        for sid in range(DATASTREAM_SHARDS):
            recs = []
            for _ in range(11 + sid):  # uneven on purpose
                recs.append(spec.encode(x=np.array([gid % 251], np.uint8), y=np.int32(gid)))
                gid += 1
            p = root / f"shard-{sid}.dlc"
            write_records(p, spec, recs)
            paths.append(p)
        seen: list[int] = []
        for host in DATASTREAM_HOSTS:
            stream = HostShardStream(paths, spec, batch_size=4, host=host,
                                     hosts=DATASTREAM_HOSTS, seed=7, loop=False)
            for b in stream.batches():
                seen.extend(int(v) for v in b.y)
        if sorted(seen) != list(range(gid)):
            failures.append(f"epoch drain not exactly-once: {len(seen)} reads of {gid} records")

        class _GatedDisk:
            """CheckpointIO-compatible; every write parks on a gate, so the
            step path demonstrably runs ahead of the writer."""

            def __init__(self):
                self.entered = threading.Event()
                self.release = threading.Event()

            def write_bytes(self, path, data):
                self.entered.set()
                if not self.release.wait(timeout=GATE_TIMEOUT_S):
                    raise OSError("gate never released")
                Path(path).write_bytes(data)

            def replace(self, src, dst):
                os.replace(src, dst)

            def read_bytes(self, path):
                return Path(path).read_bytes()

        disk = _GatedDisk()
        state = {"w": np.arange(8, dtype=np.float32)}
        ck = AsyncShardedCheckpointer(root / "ckpt", every_steps=1, n_shards=2, io=disk)
        ck.save(1, state, stream_state={"host": "host-a", "cursor": 1})
        if not disk.entered.wait(timeout=GATE_TIMEOUT_S):
            failures.append("async writer never started after save()")
        # The step path is HERE, running, while the writer is parked on the
        # gate: save() returned with zero bytes on disk.
        if list((root / "ckpt").glob("ckpt-*.manifest.json")):
            failures.append("a manifest landed while the writer was gated — save() blocked on IO")
        ck.save(2, {"w": state["w"] + 1})
        ck.save(3, {"w": state["w"] + 2})
        if ck.superseded_total != 1:
            failures.append(f"latest-wins supersede count {ck.superseded_total} != 1 "
                            "(step 2 should yield to step 3)")
        disk.release.set()
        ck.wait(timeout_s=60)
        steps = ck.steps()
        if steps != [1, 3]:
            failures.append(f"committed steps {steps} != [1, 3] (first-picked + last-enqueued)")
        restored = ck.restore_latest()
        if restored is None or restored[1] != 3:
            failures.append("restore_latest did not return the last committed step")
        ck.close()
        return {
            "shards": DATASTREAM_SHARDS,
            "hosts": len(DATASTREAM_HOSTS),
            "records": gid,
            "epoch_reads": len(seen),
            "superseded": ck.superseded_total,
            "committed_steps": steps,
        }, failures
    finally:
        shutil.rmtree(root, ignore_errors=True)


SCHED_JOBS = 6
SCHED_SLICES = 5
SCHED_PERMUTATIONS = 24
WALL_CLOCK_PROBES = ("time.time(", "time.monotonic(", "time.sleep(")


def sched_placer(device: str) -> tuple[dict, list[str]]:
    """Stage 9: (1) placement is a deterministic pure function: repeated
    calls and permuted submission orders give identical placements;
    (2) the quota invariants hold (``verify_placement``); (3) the sched
    package never reads the wall clock, so its decisions replay from the
    ledger alone."""
    import itertools

    from deeplearning_cfn_tpu_torch.sched import JobSpec, place, verify_placement

    failures: list[str] = []
    inventory = {f"s{i}": 4 for i in range(SCHED_SLICES)}
    jobs = [
        JobSpec(name="chat", kind="serve", priority="prod-serve"),
        JobSpec(name="train-a", kind="train", priority="prod-train", min_slices=1,
                max_slices=2),
        JobSpec(name="train-b", kind="train", priority="prod-train", min_slices=2,
                max_slices=2),
        JobSpec(name="nightly", kind="train", priority="batch", min_slices=1, max_slices=3),
        JobSpec(name="eval", kind="serve", priority="batch"),
        JobSpec(name="hopeless", kind="train", priority="batch",
                min_slices=SCHED_SLICES + 1, max_slices=SCHED_SLICES + 1),
    ]
    baseline = place(jobs, inventory)
    orders = itertools.islice(itertools.permutations(jobs, len(jobs)), SCHED_PERMUTATIONS)
    for trial, ordering in enumerate(orders):
        if place(list(ordering), inventory).to_dict() != baseline.to_dict():
            failures.append(f"placement depends on submission order (permutation {trial})")
            break
    quota_errors = verify_placement(baseline, jobs, inventory)
    failures.extend(f"quota invariant: {e}" for e in quota_errors)
    if "hopeless" not in baseline.unplaced:
        failures.append("over-quota job was placed instead of explained in unplaced")
    if baseline.assignments.get("chat") != ("s0",):
        failures.append(f"prod-serve did not get the first slice: {baseline.assignments}")
    clocked = [p.name for p in sorted((PACKAGE / "sched").glob("*.py"))
               if any(probe in p.read_text() for probe in WALL_CLOCK_PROBES)]
    if clocked:
        failures.append(f"sched package touches the wall clock in {clocked} — decisions must "
                        "be replayable from the ledger alone")
    return {
        "jobs": len(jobs),
        "slices": SCHED_SLICES,
        "assignments": {j: list(s) for j, s in sorted(baseline.assignments.items())},
        "unplaced": dict(sorted(baseline.unplaced.items())),
        "permutations_checked": SCHED_PERMUTATIONS,
        "quota_errors": len(quota_errors),
    }, failures


def comms_budget(device: str) -> tuple[dict, list[str]]:
    """Stage 10: the audited fsdp train step's collective bytes, on the
    comms audit's two ranks, equal ``analysis/comms_budget.json``'s
    EXACTLY, not within a ceiling: any drift means the step's collectives
    changed and the budget must be re-measured deliberately
    (``python -m deeplearning_cfn_tpu_torch.analysis.comms_audit
    --write-budget``)."""
    from deeplearning_cfn_tpu_torch.analysis import comms_audit

    failures: list[str] = []
    budget = comms_audit.load_budget()
    if budget is None:
        return {"skipped": "no committed budget"}, failures
    if comms_audit.RANKS != int(budget.get("device_count", -1)):
        return {"skipped": f"the audit's {comms_audit.RANKS} ranks != the budget's "
                           f"{budget.get('device_count')}"}, failures
    report = comms_audit.run_comms_audit(journal=False, budget_path=None, serve=False,
                                         device=device, programs=("train_step",))
    committed = budget.get("programs", {}).get("train_step", {})
    measured = next((p for p in report.programs if p.name == "train_step"), None)
    if measured is None:
        failures.append("comms audit produced no train_step program")
        return {}, failures
    if measured.collective_bytes != int(committed.get("collective_bytes", -1)):
        failures.append(
            f"train_step collective_bytes {measured.collective_bytes} != committed "
            f"{committed.get('collective_bytes')} (analysis/comms_budget.json; re-measure "
            "deliberately with python -m deeplearning_cfn_tpu_torch.analysis.comms_audit "
            "--write-budget)"
        )
    return {"train_step": measured.budget, "committed": committed,
            "backend": report.backend}, failures


def comms_overlap(device: str) -> tuple[dict, list[str]]:
    """Stage 11: the bucketed gradient sync (``parallel/overlap.py``) buys
    what it promises, on the comms audit's two ranks: (1) the bucketed dp
    program's overlap score is STRICTLY greater than the dp step's on the
    same model, ranks and batch (the DLC512 pair invariant, without the
    committed budget); (2) its buckets hold exactly the gradient tree,
    every leaf in one bucket; (3) neither program captures or builds after
    its warm-up."""
    from deeplearning_cfn_tpu_torch.analysis import comms_audit

    failures: list[str] = []
    report = comms_audit.run_comms_audit(
        journal=False, budget_path=None, serve=False, device=device,
        programs=("train_step_dp", "train_step_dp_overlap"))
    scores = {p.name: p.overlap_score for p in report.programs}
    mono_score, bucket_score = scores["train_step_dp"], scores["train_step_dp_overlap"]
    if bucket_score <= mono_score:
        failures.append(
            f"bucketed overlap_score {bucket_score} does not strictly exceed the monolithic "
            f"baseline's {mono_score} — the bucket schedule is buying no latency hiding"
        )
    sync = report.measured["train_step_dp_overlap"]["grad_sync"] or {}
    if sync.get("bucket_bytes") != sync.get("tree_bytes"):
        failures.append(f"bucket byte accounting {sync.get('bucket_bytes')} != grad tree "
                        f"{sync.get('tree_bytes')} — a leaf was dropped or double-bucketed")
    if sync.get("bucket_leaves") != sync.get("tree_leaves"):
        failures.append(f"bucket plan covers {sync.get('bucket_leaves')} leaves of "
                        f"{sync.get('tree_leaves')}")
    retraces = {name: [c for c in m["post_warmup_compiles"] if c]
                for name, m in report.measured.items()}
    retraces = {name: c for name, c in retraces.items() if c}
    if retraces:
        failures.append(f"overlap step recompiled after warmup: {retraces}")
    return {
        "monolithic_overlap_score": mono_score,
        "bucketed_overlap_score": bucket_score,
        "buckets": sync.get("buckets"),
        "bucket_bytes": sync.get("bucket_bytes"),
        "post_warmup_compiles": sum(len(c) for c in retraces.values()),
        "backend": report.backend,
    }, failures


DETERMINISM_SCENARIO = "silent-death"
DETERMINISM_SOAK_AGENTS = 200
DETERMINISM_WALL_BUDGET_S = 120.0


def determinism(device: str) -> tuple[dict, list[str]]:
    """Stage 12: the DLC610 sentinel's mechanics, smoke-sized: one chaos
    scenario and a scaled-down ``soak_failover`` double-run through
    ``analysis/replay_audit``: (1) both double runs are byte-identical,
    (2) the double run never sleeps (virtual clocks only), and (3) it stays
    inside DETERMINISM_WALL_BUDGET_S.  The full sweep is
    ``python -m deeplearning_cfn_tpu_torch.analysis.replay_audit``."""
    from deeplearning_cfn_tpu_torch.analysis.replay_audit import (
        ReplayCase,
        default_cases,
        run_replay_audit,
    )
    from deeplearning_cfn_tpu_torch.analysis.schedules import soak_failover

    failures: list[str] = []
    cases = default_cases(scenarios=[DETERMINISM_SCENARIO], soaks=False, device=device)
    cases.append(ReplayCase(
        name="soak_failover_smoke",
        kind="soak",
        run=lambda seed: soak_failover(agents=DETERMINISM_SOAK_AGENTS, seed=seed, kill_count=10,
                                       senders=20, unshipped_tail=5),
        audited_file="deeplearning_cfn_tpu_torch/scripts/perf_smoke.py",
    ))
    start = time.monotonic()
    with _CountingSleep() as sleeps:
        report = run_replay_audit(cases=cases, journal=False)
    wall_s = round(time.monotonic() - start, 3)
    for replay in report.replays:
        if not replay.identical:
            failures.append(
                f"determinism stage: {replay.kind} '{replay.name}' diverged across a same-seed "
                f"double run (first divergence at {replay.divergence})"
            )
    if sleeps.calls:
        failures.append(f"determinism stage slept {sleeps.calls} time(s) — the double run must "
                        "wait on virtual clocks only")
    if wall_s > DETERMINISM_WALL_BUDGET_S:
        failures.append(f"determinism stage took {wall_s}s, over the "
                        f"{DETERMINISM_WALL_BUDGET_S}s wall budget")
    return {
        "replays": [r.to_dict() for r in report.replays],
        "sleep_calls": sleeps.calls,
        "wall_s": wall_s,
    }, failures


# The stages in the JAX script's order, each under the key its snapshot
# takes in the output line (stages 1 and 2 spread theirs over several).
STAGES: tuple[tuple[str, Callable[[str], tuple[dict, list[str]]]], ...] = (
    ("pipeline", pipeline),
    ("profiler", profiler),
    ("overlap", input_overlap),
    ("serve", serve_scheduler),
    ("broker_failover", broker_soak),
    ("fleet_sim", fleet_sim),
    ("telemetry", telemetry_overhead),
    ("datastream", datastream),
    ("sched", sched_placer),
    ("comms", comms_budget),
    ("comms_overlap", comms_overlap),
    ("determinism", determinism),
)
# The stages that put work on the device (the rest run on virtual clocks
# and host data).
DEVICE_STAGES = ("pipeline", "profiler", "overlap", "comms", "comms_overlap")
SPREAD = ("pipeline", "profiler")


def main(argv: list[str] | None = None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="perf_smoke", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if _cuda(args.device) and not torch.cuda.is_available():
        print("perf-smoke: no CUDA card; pass --device cpu", file=sys.stderr)
        return 1
    out: dict[str, Any] = {}
    failures: list[str] = []
    for name, stage in STAGES:
        snap, found = stage(args.device)
        failures.extend(found)
        if name in SPREAD:
            out.update(snap)
        else:
            out[name] = snap
    if failures:
        for f in failures:
            print(f"perf-smoke: {f}", file=sys.stderr)
        return 1
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
