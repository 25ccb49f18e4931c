"""Prefill/decode placement — counterpart of ``deeplearning_cfn_tpu/serve/placement.py``.

Prefill is compute-bound (one large forward per admission); decode is
memory-bound (one token a slot a step over the resident pool).  With two
devices or more the engine runs them apart: prompts prefill on a dedicated
device through :func:`engine.prefill_kv` (local causal attention, no pool),
the K/V moves once, and :func:`engine.scatter_prompt_kv` lands it in the
decode device's pool, so decode never waits behind a long prompt.

``plan_placement`` disaggregates only with two devices or more; one device
(one H100, or the CPU) is colocated, the path held token for token to
``llama_decode.generate``.  The disaggregated path is numerically
equivalent but not bit-identical (its prefill attention reduces over
``prefill_len`` instead of the gathered context).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class ServePlacement:
    """Which devices run which phase of serving."""

    prefill_devices: tuple = field(default_factory=tuple)
    decode_devices: tuple = field(default_factory=tuple)
    disaggregated: bool = False

    def describe(self) -> dict:
        return {
            "disaggregated": self.disaggregated,
            "prefill_devices": [str(d) for d in self.prefill_devices],
            "decode_devices": [str(d) for d in self.decode_devices],
        }


def plan_placement(devices: list | None = None) -> ServePlacement:
    """A placement for one replica over ``devices`` (default: every CUDA
    device; raises when there is none).

    Two devices or more: the first prefills, the rest decode
    (disaggregated).  One device: both phases share it (colocated).
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("CUDA is not available; pass devices to plan for the CPU")
    devices = [torch.device(d) for d in devices]
    if len(devices) >= 2:
        return ServePlacement(
            prefill_devices=(devices[0],),
            decode_devices=tuple(devices[1:]),
            disaggregated=True,
        )
    return ServePlacement(
        prefill_devices=tuple(devices), decode_devices=tuple(devices), disaggregated=False
    )
