"""Training metrics and throughput logging — counterpart of
``deeplearning_cfn_tpu/train/metrics.py``, with the port's own peak tables.

MFU and MBU are measured against the published dense peaks of the card the
run is on, found by ``torch.cuda.get_device_name()``.  The table holds GPU
rows only; a CPU run has no peak, and its utilization is ``None``.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from deeplearning_cfn_tpu_torch.obs.recorder import json_safe
from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, MonotonicClock

log = logging.getLogger("dlcfn.train")

# (substring of the device name, dense bf16 FLOP/s, HBM bytes/s, f32 FLOP/s on
# the CUDA cores), from NVIDIA's data sheets.  First match wins, so the PCIe
# and NVL parts come before the SXM part, whose name is "NVIDIA H100 80GB HBM3".
_GPU_PEAKS: tuple[tuple[str, float, float, float], ...] = (
    ("H100 PCIe", 756e12, 2.0e12, 51e12),
    ("H100 NVL", 835e12, 3.9e12, 60e12),
    ("H100", 989e12, 3.35e12, 67e12),
    ("H200", 989e12, 4.8e12, 67e12),
)


def _peaks(device_name: str | None) -> tuple[float, float, float] | None:
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    for key, *peaks in _GPU_PEAKS:
        if key in device_name:
            return tuple(peaks)
    return None


def peak_flops_per_chip(device_name: str | None = None) -> float | None:
    """Dense bf16 FLOP/s of the named card (default: the current CUDA card),
    or None when unknown or when there is no card."""
    peaks = _peaks(device_name)
    return peaks[0] if peaks else None


def peak_hbm_bytes_per_chip(device_name: str | None = None) -> float | None:
    """Device-memory bytes/s of the named card, or None."""
    peaks = _peaks(device_name)
    return peaks[1] if peaks else None


def peak_f32_flops_per_chip(device_name: str | None = None) -> float | None:
    """f32 FLOP/s of the named card's CUDA cores (no TF32), or None."""
    peaks = _peaks(device_name)
    return peaks[2] if peaks else None


def utilization(
    numerator: float | None, denominator: float | None, ndigits: int = 4
) -> float | None:
    """``round(numerator / denominator, ndigits)`` with None propagation, and
    None (never NaN) for a non-finite ratio."""
    if numerator is None or denominator is None or denominator == 0:
        return None
    value = numerator / denominator
    if value != value or value in (float("inf"), float("-inf")):
        return None
    return round(value, ndigits)


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


@dataclass
class JsonlMetricsSink:
    """One JSONL metrics file per process; every record carries the
    wallclock and the process index."""

    path: str | Path
    _fh: object = field(default=None, repr=False)

    def __post_init__(self) -> None:
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(p, "a", buffering=1)  # line-buffered

    def write(self, record: dict) -> None:
        self._fh.write(
            json.dumps(
                json_safe({"ts": time.time(), "process": _process_index(), **record}),
                allow_nan=False,
            )
            + "\n"
        )

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @classmethod
    def for_run(cls, base_dir: str | Path, run_name: str) -> "JsonlMetricsSink":
        """<base>/<run>/worker<pid>.jsonl."""
        return cls(Path(base_dir) / run_name / f"worker{_process_index()}.jsonl")


class MetricsOutage(RuntimeError):
    """The metrics sink stayed down past the configured grace window."""

    def __init__(self, grace_s: float, buffered: int):
        super().__init__(
            f"metrics sink down for more than {grace_s:.0f}s "
            f"({buffered} records buffered)"
        )
        self.grace_s = grace_s
        self.buffered = buffered


@dataclass
class ResilientSink:
    """Keep training through a metrics-plane outage (graceful degradation).

    Wraps any sink with ``write``/``close``.  When the inner sink starts
    raising OSError (broker gone, shared storage unmounted), records are
    buffered — bounded in memory and mirrored to the flight recorder ring
    as ``metric_buffered`` events so nothing is silently dropped — and the
    trainer keeps stepping.  The first successful write flushes the buffer
    in order.  Only after ``grace_s`` of continuous outage (measured on
    the injected clock, so chaos soaks run in virtual time) does the
    typed :class:`MetricsOutage` escape to the caller.
    """

    inner: Any
    grace_s: float = 120.0
    clock: Clock = field(default_factory=MonotonicClock)
    max_buffered: int = 10_000

    def __post_init__(self) -> None:
        self._buffer: deque[dict] = deque(maxlen=self.max_buffered)
        self._outage_start: float | None = None

    @property
    def degraded(self) -> bool:
        return self._outage_start is not None

    @property
    def buffered(self) -> int:
        return len(self._buffer)

    def write(self, record: dict) -> None:
        try:
            while self._buffer:
                self.inner.write(self._buffer[0])
                self._buffer.popleft()
            self.inner.write(record)
        except OSError as exc:
            self._on_failure(record, exc)
            return
        if self._outage_start is not None:
            self._outage_start = None
            self._record("metrics_recovered", buffered=0)

    def _on_failure(self, record: dict, exc: OSError) -> None:
        now = self.clock.now()
        if self._outage_start is None:
            self._outage_start = now
            log.warning("metrics sink down, buffering (%s)", exc)
        self._buffer.append(record)
        self._record(
            "metric_buffered",
            buffered=len(self._buffer),
            record=json_safe(record),
        )
        if now - self._outage_start > self.grace_s:
            raise MetricsOutage(self.grace_s, len(self._buffer)) from exc

    def _record(self, kind: str, **fields) -> None:
        try:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record(kind, **fields)
        except Exception:  # pragma: no cover - journaling is best-effort
            pass

    def close(self) -> None:
        self.inner.close()


@dataclass
class ThroughputLogger:
    """Per-N-steps throughput/loss logger.  ``loss`` may be a device tensor:
    it is read back (a host sync) only on log steps.  With
    ``flops_per_step`` and ``peak_flops`` each record also carries MFU.

    ``Trainer.fit`` calls ``resume(state.step)`` before its first step: a
    logger not yet driven to that step (a restored run) re-anchors its count
    there and its clock then, so each rate counts only the steps this
    process ran.  (Deliberate difference: the JAX logger counts from step
    0, so a run resumed at step s reports its first interval about s + 1
    times too fast.)  A new run at step 0, or a later ``fit`` of the same
    run, keeps its count and its clock, as JAX's does."""

    global_batch_size: int
    log_every: int = 10
    name: str = "train"
    sink: JsonlMetricsSink | None = None
    flops_per_step: float | None = None
    peak_flops: float | None = None
    history: list[dict] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._t0 = time.perf_counter()
        self._last_step = 0  # the last step logged
        self._seen_step = 0  # the last step passed to step()

    def resume(self, step: int) -> None:
        """The run goes on from ``step``; re-anchor unless this logger was
        driven there."""
        if step != self._seen_step:
            self._t0 = time.perf_counter()
            self._last_step = self._seen_step = int(step)

    def step(self, step: int, loss) -> None:
        self._seen_step = step
        if step % self.log_every:
            return
        loss = float(loss)  # the sync: the steps logged are done on the device
        now = time.perf_counter()
        dsteps = step - self._last_step
        dt = now - self._t0
        examples_per_sec = self.global_batch_size * dsteps / dt if dsteps else 0.0
        record = {"step": step, "loss": loss, "examples_per_sec": examples_per_sec}
        if self.flops_per_step and self.peak_flops and dsteps and dt > 0:
            record["mfu"] = self.flops_per_step * dsteps / dt / self.peak_flops
        self.history.append(record)
        if self.sink is not None:
            self.sink.write({"event": "train_step", "run": self.name, **record})
        log.info(
            "%s step=%d loss=%.4f examples/sec=%.1f%s",
            self.name, step, record["loss"], examples_per_sec,
            f" mfu={record['mfu']:.3f}" if "mfu" in record else "",
        )
        self._t0 = now
        self._last_step = step
