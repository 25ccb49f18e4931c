"""Step-time profiler: the training step loop split into phases — the
port's own copy of ``deeplearning_cfn_tpu/obs/profiler.py`` (its
``RollingQuantiles``, ``PhaseStats``, ``StepProfiler``, ``NULL_PROFILER``,
``PHASES`` and the per-program cost attribution, whose ``program_cost``
counts with PyTorch's flop counter where JAX reads XLA's cost analysis).

- ``data_wait``: the host blocked pulling the next batch from the source
  (``wrap_source`` times each ``next()``).
- ``h2d``: the host-to-device copy.  In ``Trainer.fit`` the consumer's copy
  (or the prefetcher's hand-off of a batch already on the card) is on the
  critical path; the ``DevicePrefetcher`` producers' copies overlap the
  step and fold with ``critical=False``: they show in the phase's stats
  and are not taken from the host residual.
- ``dispatch``: issuing the step.  PyTorch's eager dispatch runs the Python
  of the step and queues its kernels, so this is host time; the card may
  still be busy when it ends.
- ``compute``: the wait at the sync boundary, the loss readback ``fit``
  already does: a *lower bound* of the device time, spread over the steps
  drained there (``sync_boundary(steps=n)`` adds ``seconds / n`` a step).
- ``host``: the residual, the step's wall time less the critical phases:
  the loop's Python, logging, checkpoint hooks.

Each phase keeps count, total and max, and rolling p50/p95/p99 over a
bounded window.  ``snapshot()`` gives the per-step ``*_ms`` means;
``journal()`` records one ``step_profile`` event; ``per_step_events=True``
records a ``step_time`` event a step.  ``Trainer.fit(profiler=None)`` uses
``NULL_PROFILER``, whose every method returns at once (``wrap_source``
returns its argument), so an unprofiled loop pays an attribute check a call.

A profiled step's calls (``phase``, ``fold``, ``step_done``) each append one
record to a queue and return; the records are folded, in the order they
came, when the profiler is read (``snapshot``, ``journal``,
``recent_step_ms``), when ``start()`` opens a loop, and whenever the queue
holds ``PENDING_CAP`` records.  The results are those of folding at each
call, as JAX's copy does, but a step pays an append: ~7-23 us of folding
after a step had left the host's caches cold (an H100 host, 1 ms steps)
was 1-2.7% of the step.  With ``per_step_events`` each ``step_done``
folds at once, to journal its event.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator

from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder, get_recorder

#: Canonical phase order for snapshots and docs.
PHASES = ("data_wait", "h2d", "dispatch", "compute", "host")
#: Records a profiler queues before it folds them.
PENDING_CAP = 256
_STEP = object()  # a queued record's tag for ``step_done``


class RollingQuantiles:
    """p50/p95/p99 over a bounded window of recent samples.

    A sorted copy per query (not per sample) keeps the hot-path cost at
    one deque append; queries happen at snapshot/export time only.  Not
    thread-safe on its own — callers hold their own lock.
    """

    __slots__ = ("_window",)

    def __init__(self, window: int = 512) -> None:
        self._window: deque[float] = deque(maxlen=max(2, int(window)))

    def add(self, value: float) -> None:
        self._window.append(float(value))

    def __len__(self) -> int:
        return len(self._window)

    def samples(self) -> list[float]:
        """The current window, oldest first — the mergeable raw form the
        fleet aggregator ships instead of pre-reduced quantiles (per-host
        p99s cannot be merged; samples can)."""
        return list(self._window)

    def quantiles(self) -> dict[str, float]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` — empty dict if no samples."""
        if not self._window:
            return {}
        ordered = sorted(self._window)
        n = len(ordered)
        out = {}
        for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[key] = ordered[min(n - 1, round(q * (n - 1)))]
        return out


class PhaseStats:
    """Aggregate for one phase: count / total / max / rolling quantiles."""

    __slots__ = ("count", "total_s", "max_s", "_quantiles")

    def __init__(self, window: int = 512) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._quantiles = RollingQuantiles(window)

    def fold(self, seconds: float, samples: int = 1) -> None:
        # ``samples`` amortizes one observation over n steps (a sync
        # boundary draining n steps of pending metrics observes the
        # device time of all n at once).
        samples = max(1, int(samples))
        per_step = seconds / samples
        self.count += samples
        self.total_s += seconds
        self.max_s = max(self.max_s, per_step)
        self._quantiles.add(per_step)

    def as_dict(self) -> dict[str, Any]:
        out = {
            "count": self.count,
            "total_ms": round(self.total_s * 1e3, 3),
            "mean_ms": round(self.total_s * 1e3 / self.count, 3)
            if self.count
            else 0.0,
            "max_ms": round(self.max_s * 1e3, 3),
        }
        for key, value in self._quantiles.quantiles().items():
            out[f"{key}_ms"] = round(value * 1e3, 3)
        return out


class _PhaseTimer:
    """Context manager timing one block into one phase."""

    __slots__ = ("_profiler", "_name", "_t0")

    def __init__(self, profiler: "StepProfiler", name: str) -> None:
        self._profiler = profiler
        self._name = name

    def __enter__(self) -> None:
        self._t0 = self._profiler._clock()

    def __exit__(self, *exc: Any) -> None:
        profiler = self._profiler
        pending = profiler._pending
        pending.append((self._name, profiler._clock() - self._t0, True, 1))
        if len(pending) >= PENDING_CAP:
            profiler._drain()


class _SyncTimer:
    """Times a blocking readback into ``compute``, amortized over steps."""

    __slots__ = ("_profiler", "_steps", "_t0")

    def __init__(self, profiler: "StepProfiler", steps: int) -> None:
        self._profiler = profiler
        self._steps = max(1, int(steps))

    def __enter__(self) -> None:
        self._t0 = self._profiler._clock()

    def __exit__(self, *exc: Any) -> None:
        self._profiler.fold(
            "compute",
            self._profiler._clock() - self._t0,
            samples=self._steps,
        )


class _NullContext:
    """Reusable, reentrant no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL_CTX = _NullContext()


class StepProfiler:
    """Splits a step loop into phases with rolling distributions.

    Thread-safe: producer threads (``DevicePrefetcher``) fold overlapped
    transfer time concurrently with the consumer loop.  ``clock`` is
    injectable so tests never depend on wall time.
    """

    def __init__(
        self,
        name: str = "train",
        enabled: bool = True,
        window: int = 512,
        clock: Callable[[], float] = time.perf_counter,
        recorder: FlightRecorder | None = None,
        per_step_events: bool = False,
    ) -> None:
        self.name = name
        self.enabled = enabled
        self._clock = clock
        self._recorder = recorder
        self._per_step_events = per_step_events
        self._window = max(2, int(window))
        self._lock = threading.Lock()
        self._phases: dict[str, PhaseStats] = {}
        self._step_ms = RollingQuantiles(self._window)
        self._steps = 0
        self._step_total_s = 0.0
        self._step_max_s = 0.0
        self._step_start: float | None = None
        self._critical_s = 0.0
        self._interval: dict[str, float] = {}
        self._labels: dict[str, Any] = {}
        # (phase, seconds, critical, samples) or (_STEP, now, step, steps):
        # appended by any thread, folded in order under the lock.
        self._pending: deque[tuple] = deque()

    # -- marking ---------------------------------------------------------

    def start(self) -> None:
        """Anchor the first step interval at 'now' (call at loop entry)."""
        if not self.enabled:
            return
        with self._lock:
            self._drain_locked()
            self._step_start = self._clock()
            self._critical_s = 0.0
            self._interval = {}

    def phase(self, name: str) -> Any:
        """``with profiler.phase("dispatch"): ...`` times a block."""
        if not self.enabled:
            return _NULL_CTX
        return _PhaseTimer(self, name)

    def sync_boundary(self, steps: int = 1) -> Any:
        """Time a blocking readback into ``compute``, amortized over ``steps``."""
        if not self.enabled:
            return _NULL_CTX
        return _SyncTimer(self, steps)

    def fold(
        self, name: str, seconds: float, critical: bool = True, samples: int = 1
    ) -> None:
        """Fold ``seconds`` into phase ``name``.

        ``critical=False`` marks time that overlapped the step (producer-
        side transfer): it lands in the phase stats but is not counted
        against the step's host residual.
        """
        if not self.enabled:
            return
        pending = self._pending
        pending.append((name, seconds, critical, samples))
        if len(pending) >= PENDING_CAP:
            self._drain()

    def _fold_locked(self, name: str, seconds: float, critical: bool, samples: int) -> None:
        stats = self._phases.get(name)
        if stats is None:
            stats = self._phases[name] = PhaseStats(self._window)
        stats.fold(seconds, samples=samples)
        if critical:
            self._critical_s += seconds
            self._interval[name] = self._interval.get(name, 0.0) + seconds

    def _drain(self) -> None:
        with self._lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        """Fold the queued records in order (the caller holds the lock, so
        one thread drains at a time; others may append meanwhile)."""
        pending = self._pending
        while pending:
            tag, a, b, c = pending.popleft()
            if tag is _STEP:
                self._close_step(a, b, c)
            else:
                self._fold_locked(tag, a, b, c)

    def wrap_source(self, batches: Iterable[Any]) -> Iterable[Any]:
        """Time each ``next()`` on the batch source into ``data_wait``.

        Disabled profilers return ``batches`` unchanged — zero iterator
        indirection on the un-profiled path.
        """
        if not self.enabled:
            return batches

        def timed() -> Iterator[Any]:
            it = iter(batches)
            while True:
                t0 = self._clock()
                try:
                    item = next(it)
                except StopIteration:
                    return
                self.fold("data_wait", self._clock() - t0)
                yield item

        return timed()

    def step_done(self, step: int | None = None, steps: int = 1) -> None:
        """Close the current step interval; compute the host residual."""
        if not self.enabled:
            return
        now = self._clock()
        if not self._per_step_events:
            pending = self._pending
            pending.append((_STEP, now, step, steps))
            if len(pending) >= PENDING_CAP:
                self._drain()
            return
        with self._lock:
            self._drain_locked()
            event = self._close_step(now, step, steps)
        if event is not None:
            # Journal outside the lock (DLC203: no I/O under a lock).
            (self._recorder or get_recorder()).record("step_time", **event)

    def _close_step(self, now: float, step: int | None, steps: int) -> dict[str, Any] | None:
        """``step_done``'s fold at ``now`` (the lock held); returns the
        ``step_time`` event with ``per_step_events``."""
        event: dict[str, Any] | None = None
        if self._step_start is None:
            # No anchor: the interval began at an unknown time, so
            # only set one for the next step.
            self._step_start = now
            self._critical_s = 0.0
            self._interval = {}
            return None
        n = max(1, int(steps))
        total = max(0.0, now - self._step_start)
        host = max(0.0, total - self._critical_s)
        per_step = total / n
        stats = self._phases.get("host")
        if stats is None:
            stats = self._phases["host"] = PhaseStats(self._window)
        stats.fold(host, samples=n)
        self._step_ms.add(per_step * 1e3)
        self._steps += n
        self._step_total_s += total
        self._step_max_s = max(self._step_max_s, per_step)
        if self._per_step_events:
            event = {
                "profiler": self.name,
                "steps": n,
                "total_ms": round(per_step * 1e3, 3),
                "host_ms": round(host * 1e3 / n, 3),
            }
            if step is not None:
                event["step"] = step
            for phase, seconds in sorted(self._interval.items()):
                event[f"{phase}_ms"] = round(seconds * 1e3 / n, 3)
        self._step_start = now
        self._critical_s = 0.0
        self._interval = {}
        return event

    def set_label(self, key: str, value: Any) -> None:
        """Attach an annotation carried by every later ``snapshot()``/
        ``journal()`` under ``labels`` — e.g. the bench tags each phase
        profiler with its dispatch ``mode``, so the journaled
        ``step_profile`` events say which loop produced the timings."""
        if not self.enabled:
            return
        with self._lock:
            self._labels[str(key)] = value

    # -- reporting -------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Aggregate view: flat per-step phase means + full distributions."""
        with self._lock:
            self._drain_locked()
            phases = {name: st.as_dict() for name, st in self._phases.items()}
            steps = self._steps
            step_ms: dict[str, Any] = {
                key: round(value, 3)
                for key, value in self._step_ms.quantiles().items()
            }
            if steps:
                step_ms["mean"] = round(self._step_total_s * 1e3 / steps, 3)
                step_ms["max"] = round(self._step_max_s * 1e3, 3)
        out: dict[str, Any] = {"name": self.name, "steps": steps}
        for phase in PHASES:
            total_ms = phases.get(phase, {}).get("total_ms", 0.0)
            # Per-STEP mean (not per-sample): phases with more samples
            # than steps (producer folds) still average over steps.
            out[f"{phase}_ms"] = round(total_ms / steps, 3) if steps else 0.0
        out["step_ms"] = step_ms
        out["phases"] = dict(sorted(phases.items()))
        with self._lock:
            if self._labels:
                out["labels"] = dict(self._labels)
        return out

    def recent_step_ms(self) -> list[float]:
        """Raw step-time samples (ms) in the rolling window, oldest
        first — what ``obs.aggregator.agent_snapshot`` ships as a
        mergeable sketch."""
        with self._lock:
            self._drain_locked()
            return self._step_ms.samples()

    def journal(self, recorder: FlightRecorder | None = None) -> dict[str, Any]:
        """Record one ``step_profile`` event with the current snapshot."""
        snap = self.snapshot()
        if self.enabled:
            (recorder or self._recorder or get_recorder()).record(
                "step_profile", **snap
            )
        return snap


#: Shared disabled instance: ``Trainer.fit``'s default profiler.
NULL_PROFILER = StepProfiler(name="null", enabled=False)


# -- per-program cost attribution ---------------------------------------


def program_cost(model: Any, x: Any, *, flops: float | None = None) -> dict[str, float | None]:
    """FLOPs and bytes of one training step of ``model`` on the batch ``x``,
    under JAX's keys (``flops``, ``bytes_accessed``).

    JAX reads them from XLA's cost model of the compiled program; PyTorch
    compiles no program to ask, so one forward of ``model(x)`` is run (on a
    ``meta`` twin it takes no memory and no compute).  ``flops`` is the
    caller's analytic count when given (``models.llama.train_flops_per_token
    (cfg, S) * tokens``), else what ``torch.utils.flop_counter
    .FlopCounterMode`` counts over that forward and one backward, taken with
    ``torch.autograd.grad``: the caller's ``.grad`` are left as they were,
    and with ``flops`` given no backward runs.  ``bytes_accessed`` counts
    the parameters read and their gradients written, ``x`` read, the output
    written, and every other tensor the forward saves for the backward
    (``saved_tensors_hooks``, one count a storage) written and read back.
    A step's optimizer traffic, re-reads and recomputation have no count
    here, and no value stands in for them.  ``None`` values when the forward
    cannot run (the backend reports no cost model, in JAX's words)."""
    import contextlib

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    def storage(t) -> int:
        return t.untyped_storage()._cdata

    params = list(model.parameters())
    counted = {storage(p) for p in params} | {storage(x)}
    saved: dict[int, int] = {}

    def pack(t):
        key = storage(t)
        if key not in counted:
            saved[key] = max(saved.get(key, 0), nbytes(t))
        return t

    trainable = [p for p in params if p.requires_grad]
    try:
        with contextlib.ExitStack() as stack:
            counter = None if flops is not None else stack.enter_context(
                FlopCounterMode(display=False))
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = model(x)
            logits = out[0] if isinstance(out, (tuple, list)) else out
            if counter is not None and trainable:
                torch.autograd.grad(logits.float().sum(), trainable, allow_unused=True)
    except (RuntimeError, TypeError, ValueError):
        return {"flops": flops, "bytes_accessed": None}
    counted_flops = float(flops) if counter is None else float(counter.get_total_flops())
    if not isinstance(logits, torch.Tensor):
        return {"flops": counted_flops, "bytes_accessed": None}
    # The output is written once; saved for the backward, it is read back too.
    written = sum(v for k, v in saved.items() if k != storage(logits))
    moved = (2 * sum(nbytes(p) for p in params) + nbytes(x) + nbytes(logits)
             + 2 * written + saved.get(storage(logits), 0))
    return {"flops": counted_flops, "bytes_accessed": float(moved)}


def program_attribution(
    *,
    flops: float | None,
    bytes_accessed: float | None,
    seconds_per_call: float,
    steps_per_call: int = 1,
    peak_flops: float | None = None,
) -> dict[str, Any]:
    """Per-program MFU/MBU from a cost count and the measured call time.

    ``flops``/``bytes_accessed`` are per *call* (a k-step program's cost
    covers all k iterations) and per rank, so
    ``mfu = flops / (seconds_per_call * peak_flops)`` is the per-device
    utilization of that one program.  The JAX package's function, copied."""
    steps_per_call = max(1, int(steps_per_call))
    out: dict[str, Any] = {
        "steps_per_call": steps_per_call,
        "seconds_per_call": round(seconds_per_call, 6),
    }
    if flops is not None:
        out["flops_per_step"] = flops / steps_per_call
        if peak_flops and seconds_per_call > 0:
            out["mfu"] = round(flops / (seconds_per_call * peak_flops), 4)
    if bytes_accessed is not None:
        out["bytes_per_step"] = bytes_accessed / steps_per_call
        if seconds_per_call > 0:
            out["bytes_per_sec"] = round(bytes_accessed / seconds_per_call, 1)
    return out
