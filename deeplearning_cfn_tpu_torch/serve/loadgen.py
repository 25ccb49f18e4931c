"""Deterministic synthetic traffic for the serving plane — counterpart of
``deeplearning_cfn_tpu/serve/loadgen.py``.

Poisson arrivals (exponential gaps) with seeded prompt and output lengths,
drawn up front from one ``np.random.default_rng(seed)`` in the JAX
package's order, so one :class:`TrafficConfig` gives the same requests in
both packages.  The traffic drives a real scheduler (an engine, replica or
front-end: anything with ``submit``/``step`` verbs) on a
:class:`~deeplearning_cfn_tpu_torch.analysis.schedules.VirtualClock`: wall
time never enters the loop, so the soak and failover tests measure the same
latencies everywhere.

Virtual service time is modeled, not measured: each engine step costs
``step_time_s`` and each prefill ``prefill_time_s`` of virtual time, so
TTFT and p99 characterise the scheduler (queueing, admission, failover),
not the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
from deeplearning_cfn_tpu_torch.serve.engine import Completion, ServeRequest


@dataclass(frozen=True)
class TrafficConfig:
    requests: int = 200
    seed: int = 0
    arrival_rate_rps: float = 40.0  # Poisson arrival rate
    prompt_len_range: tuple[int, int] = (1, 16)  # inclusive
    output_len_range: tuple[int, int] = (1, 16)  # inclusive
    vocab_size: int = 64
    step_time_s: float = 0.01  # virtual cost of one decode step
    prefill_time_s: float = 0.004  # virtual cost of each prefill


def generate_traffic(cfg: TrafficConfig) -> list[ServeRequest]:
    """The full arrival schedule, materialized: [ServeRequest] with
    ``arrival_s`` set from cumulative exponential gaps."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.arrival_rate_rps, size=cfg.requests)
    arrivals = np.cumsum(gaps)
    p_lo, p_hi = cfg.prompt_len_range
    o_lo, o_hi = cfg.output_len_range
    prompt_lens = rng.integers(p_lo, p_hi + 1, size=cfg.requests)
    out_lens = rng.integers(o_lo, o_hi + 1, size=cfg.requests)
    requests = []
    for i in range(cfg.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(prompt_lens[i]))
        requests.append(
            ServeRequest(
                request_id=f"req-{i:04d}",
                prompt=prompt.astype(np.int32),
                max_new_tokens=int(out_lens[i]),
                arrival_s=round(float(arrivals[i]), 6),
            )
        )
    return requests


@dataclass
class LoadReport:
    """Deterministic per-seed summary (floats rounded for byte-stability)."""

    requests: int
    completed: int
    steps: int
    duration_s: float
    throughput_rps: float
    tokens_out: int
    tokens_per_s: float
    max_queue_depth: int
    ttft_ms: dict = field(default_factory=dict)
    latency_per_token_ms: dict = field(default_factory=dict)
    completions: dict[str, list[int]] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d.pop("completions")
        return d


def _quantiles_ms(samples: list[float]) -> dict:
    if not samples:
        return {}
    arr = np.asarray(samples, np.float64) * 1e3
    return {
        "p50": round(float(np.quantile(arr, 0.50)), 3),
        "p95": round(float(np.quantile(arr, 0.95)), 3),
        "p99": round(float(np.quantile(arr, 0.99)), 3),
        "max": round(float(arr.max()), 3),
    }


def run_load(
    target,
    traffic: TrafficConfig | list[ServeRequest],
    clock: VirtualClock,
    cfg: TrafficConfig | None = None,
    max_steps: int = 100_000,
    on_step: Callable[[int], None] | None = None,
    journal: bool = False,
) -> LoadReport:
    """Drive ``target`` (engine / replica / front-end) with the traffic.

    Loop: deliver every request whose arrival is due, take one scheduler
    step, advance virtual time by the step's modeled cost.  ``on_step``
    is the chaos scenario's injection point (kill a replica mid-run).
    """
    if isinstance(traffic, TrafficConfig):
        cfg = traffic
        requests = generate_traffic(traffic)
    else:
        requests = traffic
        cfg = cfg or TrafficConfig()
    submit = target.submit
    step = target.step_all if hasattr(target, "step_all") else target.step
    is_pending = target.pending

    done: dict[str, Completion] = {}
    i = 0
    steps = 0
    max_queue = 0
    prev_prefills = _prefill_count(target)
    while i < len(requests) or is_pending():
        if steps >= max_steps:
            raise RuntimeError(
                f"load did not drain in {max_steps} steps "
                f"({len(done)}/{len(requests)} complete)"
            )
        now = clock()
        while i < len(requests) and requests[i].arrival_s <= now:
            submit(requests[i], arrival_s=requests[i].arrival_s)
            i += 1
        max_queue = max(max_queue, _queue_depth(target))
        for c in step():
            done[c.request_id] = c
        if on_step is not None:
            on_step(steps)
        # max(0, ...): a failed replica's prefill counter leaves the sum,
        # so the delta can go negative across a failover step.
        prefills = _prefill_count(target)
        clock.advance(
            cfg.step_time_s
            + cfg.prefill_time_s * max(0, prefills - prev_prefills)
        )
        prev_prefills = prefills
        steps += 1
        # Idle-before-first-arrival: jump straight to the next arrival so
        # sparse traffic doesn't spin empty steps.
        if i < len(requests) and not is_pending() and requests[i].arrival_s > clock():
            clock.advance(requests[i].arrival_s - clock())

    duration = clock()
    ttft = [c.first_token_s - c.arrival_s for c in done.values()]
    per_token = [
        (c.finish_s - c.arrival_s) / max(1, len(c.tokens)) for c in done.values()
    ]
    report = LoadReport(
        requests=len(requests),
        completed=len(done),
        steps=steps,
        duration_s=round(duration, 6),
        throughput_rps=round(len(done) / duration, 3) if duration > 0 else 0.0,
        tokens_out=sum(len(c.tokens) for c in done.values()),
        tokens_per_s=round(
            sum(len(c.tokens) for c in done.values()) / duration, 3
        )
        if duration > 0
        else 0.0,
        max_queue_depth=max_queue,
        ttft_ms=_quantiles_ms(ttft),
        latency_per_token_ms=_quantiles_ms(per_token),
        completions={rid: list(c.tokens) for rid, c in sorted(done.items())},
    )
    if journal:
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

        get_recorder().record("serve_load", seed=cfg.seed, **report.to_dict())
    return report


def _queue_depth(target) -> int:
    if hasattr(target, "replicas"):
        return sum(r.engine.queue_depth for r in target.replicas.values())
    engine = getattr(target, "engine", target)
    return engine.queue_depth


def _prefill_count(target) -> int:
    if hasattr(target, "replicas"):
        return sum(r.engine.prefills for r in target.replicas.values())
    engine = getattr(target, "engine", target)
    return engine.prefills
