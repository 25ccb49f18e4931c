"""Device-resident input pipeline: counters and the dtype policy — the
port's copy of ``deeplearning_cfn_tpu/train/pipeline.py``.

- :func:`dequantize_normalize`: uint8 ``[B, H, W, C]`` images to
  ``(x/255 - mean)/std`` in f32 per channel, then the optional compute
  dtype.  The trainer applies it on the device in front of every loss
  (``TrainerConfig.input_stats``), so images cross to the card as uint8,
  4x fewer bytes than f32.
- :class:`PipelineStats`: per-run counters of the prefetch pipeline (bytes
  handed to the card, host time producing batches, producer stalls,
  consumer waits), with the JAX package's counter names and ``snapshot()``
  keys, journaled as one ``input_pipeline`` event through the port's
  ``obs/recorder``.
- :func:`fold_pipeline_events`: the per-pipeline fold of those events.

Counter semantics (all wall-clock, ``perf_counter``):

- ``bytes_transferred``: host bytes copied to the device, the PCIe payload.
- ``host_input_seconds``: time inside the source iterator, over all workers.
- ``producer_stall_seconds``: time producers waited because the reorder
  buffer was full (the pipeline ahead of the device).
- ``consumer_wait_seconds``: time the training loop waited for the next
  batch (the device ahead of the pipeline).
- ``overlap_fraction``: ``1 - consumer_wait / elapsed``.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch


def dequantize_normalize(x: torch.Tensor, mean, std, compute_dtype=None) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> ``(x/255 - mean)/std`` per channel in f32,
    op by op as the JAX package computes it; other dtypes pass through.
    ``compute_dtype`` casts the result (the one conversion lands in the
    model's compute dtype)."""
    if x.dtype == torch.uint8:
        mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
        std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
        x = (x.to(torch.float32) / 255.0 - mean) / std
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return x


def nbytes_of(tree: Any) -> int:
    """Total payload bytes of a batch tree (numpy arrays or tensors)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            n = getattr(leaf, "nbytes", None)
            total += int(n if n is not None else np.asarray(leaf).nbytes)
    return total


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class PipelineStats:
    """Thread-safe counters for one prefetch pipeline run.

    Producers fold in host-input time, transfer bytes and stall time; the
    consumer folds in wait time.  ``journal()`` records ONE
    ``input_pipeline`` event (idempotent, and a no-op when no batch flowed)."""

    def __init__(self, name: str = "input", source: str = "synthetic"):
        self.name = name
        self.source = source  # what fed the pipeline: "synthetic" or "records"
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.batches = 0
        self.bytes_transferred = 0
        self.host_input_seconds = 0.0
        self.producer_stall_seconds = 0.0
        self.consumer_wait_seconds = 0.0
        self._journaled = False

    def add_host_input(self, seconds: float) -> None:
        with self._lock:
            self.host_input_seconds += seconds

    def add_transfer(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_transferred += int(nbytes)
            self.batches += 1

    def add_producer_stall(self, seconds: float) -> None:
        with self._lock:
            self.producer_stall_seconds += seconds

    def add_consumer_wait(self, seconds: float) -> None:
        with self._lock:
            self.consumer_wait_seconds += seconds

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            overlap = 1.0 - min(self.consumer_wait_seconds / elapsed, 1.0)
            return {
                "name": self.name,
                "source": self.source,
                "batches": self.batches,
                "bytes_transferred": self.bytes_transferred,
                "host_input_seconds": round(self.host_input_seconds, 6),
                "producer_stall_seconds": round(self.producer_stall_seconds, 6),
                "consumer_wait_seconds": round(self.consumer_wait_seconds, 6),
                "elapsed_seconds": round(elapsed, 6),
                "overlap_fraction": round(overlap, 4),
            }

    def journal(self, recorder=None) -> dict[str, Any] | None:
        """Record the counters as one ``input_pipeline`` event; returns the
        snapshot, or None when already journaled or no batch flowed."""
        with self._lock:
            if self._journaled or self.batches == 0:
                return None
            self._journaled = True
        snap = self.snapshot()
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

        (recorder or get_recorder()).record("input_pipeline", **snap)
        return snap


_SUMMED = (
    "batches",
    "bytes_transferred",
    "host_input_seconds",
    "producer_stall_seconds",
    "consumer_wait_seconds",
    "elapsed_seconds",
)
_SECONDS = ("host_input_seconds", "producer_stall_seconds", "consumer_wait_seconds",
            "elapsed_seconds")


def fold_pipeline_events(events) -> dict[str, dict[str, Any]]:
    """Aggregate journaled ``input_pipeline`` events per pipeline name: sums
    of the counters, and the overlap fraction of the summed times."""
    out: dict[str, dict[str, Any]] = {}
    for event in events:
        name = event.get("name")
        if not isinstance(name, str):
            continue
        agg = out.setdefault(name, {"source": None, "runs": 0,
                                    **{k: 0.0 if k in _SECONDS else 0 for k in _SUMMED}})
        agg["runs"] += 1
        if isinstance(event.get("source"), str):
            agg["source"] = event["source"]
        for key in _SUMMED:
            value = event.get(key)
            if isinstance(value, (int, float)):
                agg[key] += value
    for agg in out.values():
        elapsed = agg["elapsed_seconds"]
        agg["overlap_fraction"] = (
            round(1.0 - min(agg["consumer_wait_seconds"] / elapsed, 1.0), 4)
            if elapsed > 0
            else None
        )
        for key in _SECONDS:
            agg[key] = round(agg[key], 6)
    return out
