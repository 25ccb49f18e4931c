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
from dataclasses import dataclass, field
from pathlib import Path

import torch

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


def json_safe(obj):
    """Recursively map non-finite floats to None so the result serializes
    under ``json.dumps(..., allow_nan=False)``; 0-d tensors and numpy
    scalars unwrap to Python numbers first."""
    if isinstance(obj, float):
        if obj != obj or obj in (float("inf"), float("-inf")):
            return None
        return obj
    if getattr(obj, "shape", None) == () and hasattr(obj, "item"):
        return json_safe(obj.item())
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


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


@dataclass
class ThroughputLogger:
    """Per-N-steps throughput/loss logger.  ``loss`` may be a device tensor:
    it is read back (a host sync) only on log steps.  With
    ``flops_per_step`` and ``peak_flops`` each record also carries MFU."""

    global_batch_size: int
    log_every: int = 10
    name: str = "train"
    sink: JsonlMetricsSink | None = None
    flops_per_step: float | None = None
    peak_flops: float | None = None
    _t0: float = field(default_factory=time.perf_counter)
    _last_step: int = 0
    history: list[dict] = field(default_factory=list)

    def step(self, step: int, loss) -> None:
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
