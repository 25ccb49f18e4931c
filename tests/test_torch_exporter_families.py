"""The port's exporter (``obs/exporter.py``, a copy) against the JAX
package's, family by family.

Seeded journals of every kind the folds read — ``serve_metrics``,
``comms_audit``, ``replay_audit``, ``gauntlet`` runs and sweeps,
``datastream`` progress/reshard/checkpoint/fallback events, ``sched_*``
decisions, preemptions and restores, interleaved with noise — go through
each ``fold_*`` of both packages: equal dicts.  ``render_prometheus`` with
all fifteen inputs given (and with each one alone) gives the same text, byte
for byte, and its families are the registry's.  The folds count, copy and
round; the text prints the same Python floats on both sides.
"""

import json

import numpy as np
import pytest

try:
    from deeplearning_cfn_tpu.obs import exporter as jexporter
except ImportError:  # the card's host
    jexporter = None

from deeplearning_cfn_tpu_torch.obs import exporter  # noqa: E402

pytestmark = pytest.mark.skipif(jexporter is None, reason="needs JAX, the reference")

FOLDS = ["fold_reshard_events", "fold_broker_events", "fold_serve_events",
         "fold_comms_events", "fold_replay_events", "fold_gauntlet_events",
         "fold_datastream_events", "fold_sched_events"]


def _journal(seed: int, n: int = 80) -> list[dict]:
    rng = np.random.default_rng(seed)

    def f(lo=0.0, hi=100.0):
        return round(float(rng.uniform(lo, hi)), int(rng.integers(0, 7)))

    def i(hi=50):
        return int(rng.integers(0, hi))

    makers = [
        lambda: {"kind": "serve_metrics", "replica": f"pool-{'abc'[i(3)]}", "steps": i(),
                 "admitted": i(), "completed": i(), "rejected": i(3), "active_slots": i(8),
                 "queue_depth": i(20), "tokens_out": i(500), "tokens_per_s": f(0, 4000),
                 "ttft_ms": {"p50": f(), "p95": f(), "p99": f()},
                 "itl_ms": {"p50": f(0, 5), "p95": f(0, 9), "p99": f(0, 20)},
                 "free_blocks": i(64), "recycled_blocks": i(64), "max_wait_steps": i(9),
                 "kv_transfer_bytes": i(1 << 20), "disaggregated": bool(i(2))},
        lambda: {"kind": "comms_audit", "programs": {
            f"prog{j}": {"collective_count": i(40), "collective_bytes": i(1 << 30),
                         "peak_hbm_bytes": i(1 << 34), "overlap_score": f(0, 1),
                         "by_op": {"all-reduce": i(9), "all-gather": i(9)},
                         "unpredicted_gathers": i(3)} for j in range(i(3) + 1)}},
        lambda: {"kind": "replay_audit", "clean": bool(i(2)), "cases": i(30),
                 "seeds": [i(9) for _ in range(i(4))],
                 "divergent": [f"case-{i(9)}" for _ in range(i(3))]},
        lambda: {"kind": "gauntlet", "event": "run", "seed": i(), "passed": bool(i(2)),
                 "faults": i(5), "violations": i(3)},
        lambda: {"kind": "gauntlet", "event": "sweep", "seeds": i(64), "base_seed": i(),
                 "failures": i(4)},
        lambda: {"kind": "datastream", "event": "progress", "hosts": i(8), "shards": i(64),
                 "records_total": i(10 ** 6), "records_per_s": f(0, 1e5), "shard_lag": i(99),
                 "reshards": i(3), "epoch": i(4)},
        lambda: {"kind": "datastream", "event": "host_progress", "host": f"h{i(4)}",
                 "records": i(999), "remaining": i(999), "epoch": i(3)},
        lambda: {"kind": "datastream", "event": "reshard", "epoch": i(3),
                 "lost_hosts": [f"h{i(4)}"], "survivors": i(4), "work_units": i(30),
                 "records_remaining": i(999)},
        lambda: {"kind": "datastream", "event": "checkpoint_write", "seconds": f(0, 3),
                 "step": i(100)},
        lambda: {"kind": "datastream", "event": ["checkpoint_write_failed",
                                                 "checkpoint_superseded",
                                                 "native_fallback"][i(3)]},
        lambda: {"kind": "sched_decision", "action": ["submit", "page-absorbed"][i(2)],
                 "jobs": i(5), "free_slices": i(4), "loans_outstanding": i(2)},
        lambda: {"kind": ["sched_preempt", "sched_restore"][i(2)], "seq": i(9),
                 "rule": "serve-queue-depth", "slice": f"s{i(3)}", "from_job": "train",
                 "to_job": "chat", "loans_outstanding": i(2)},
        lambda: {"kind": "reshard", "step": i(), "seconds": f(0, 2),
                 "old_topology": {"devices": 8}, "new_topology": {"devices": 4},
                 "grad_accum_before": 1, "grad_accum_after": 2},
        lambda: {"kind": ["reshard_fallback", "broker_promoted", "standby_reprovisioned"][i(3)],
                 "cluster": "c", "epoch": i(5), "replayed": i(9), "ts": f(0, 1e6)},
        lambda: {"kind": "step", "noise": i()},
    ]
    return [makers[int(rng.integers(0, len(makers)))]() for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fold", FOLDS)
def test_fold_equals_jax(fold, seed):
    events = _journal(seed)
    got = getattr(exporter, fold)(iter(events))
    assert got == getattr(jexporter, fold)(iter(events))
    assert getattr(exporter, fold)([]) == getattr(jexporter, fold)([]) == {}


def _profile() -> dict:
    """``status --profile``'s dict over a journal the port's ``StepProfiler``
    wrote on a virtual clock (two hosts' step times for the straggler table)."""
    import argparse
    import tempfile
    from pathlib import Path

    from deeplearning_cfn_tpu_torch import cli
    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler
    from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "j.jsonl"
        rec = FlightRecorder(path=path)
        ticks = iter(np.cumsum(np.random.default_rng(0).uniform(0.001, 0.01, 400)).tolist())
        prof = StepProfiler(name="train", clock=ticks.__next__, recorder=rec)
        prof.start()
        for step in range(6):
            with prof.phase("dispatch"):
                pass
            with prof.sync_boundary():
                pass
            prof.step_done(step=step)
            for host, ms in (("a", 50.0 + step), ("b", 60.5)):
                rec.record("step_time", worker=host, step=step, total_ms=ms)
        prof.journal()
        rec.close()
        return cli._status_profile(argparse.Namespace(profile=True, journal=str(path)))


def _inputs(seed: int) -> dict:
    events = _journal(seed, 200)
    fold = {k: getattr(jexporter, f"fold_{k}_events")(events)
            for k in ("reshard", "serve", "comms", "replay", "gauntlet", "datastream", "sched")}
    return {
        "liveness": {"w0": {"state": "alive", "age_s": 1.5, "beats": 9},
                     "w1": {"state": "dead", "age_s": 91.25, "beats": 3}},
        "spans": {"train_step": {"count": 4, "total_s": 0.5, "max_s": 0.25, "p50_s": 0.1,
                                 "p95_s": 0.2, "p99_s": 0.25}},
        "cluster": "c\"1",
        "pipeline": {"fit": {"source": "synthetic", "runs": 2, "bytes_transferred": 4096,
                             "host_input_seconds": 0.5, "producer_stall_seconds": 0.0,
                             "consumer_wait_seconds": 0.125, "elapsed_seconds": 2.0,
                             "overlap_fraction": 0.9375, "batches": 8}},
        "reshard": fold["reshard"],
        "mesh": {"slices": 2, "workers": 4, "chips_total": 8},
        "profile": _profile(),
        "serve": fold["serve"],
        "broker": {"primary": {"host": "h", "port": 1, "role": "primary", "epoch": 3,
                               "alive": True},
                   "standby": {"host": "h", "port": 2, "role": "standby", "epoch": 3,
                               "alive": False},
                   "lag_seconds": 0.5, "lag_entries": 12,
                   "shards": [{"shard": 0, "status": {"primary": {
                       "host": "h", "port": 3, "role": "primary", "epoch": 1, "alive": True},
                       "lag_seconds": 0.25, "lag_entries": 2}}]},
        "comms": fold["comms"],
        "fleet": {"hosts": 2, "workers": {"w0": {"age_s": 1.0}},
                  "gauges": {"tokens": {"sum": 3.0, "max": 2.0, "last": {"w0": 2.0}}},
                  "summaries": {"step_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0, "sum": 9.0,
                                            "count": 5}},
                  "dead_fraction": 0.5},
        "datastream": fold["datastream"],
        "sched": fold["sched"],
        "replay": fold["replay"],
        "gauntlet": fold["gauntlet"],
    }


@pytest.mark.parametrize("seed", range(4))
def test_render_prometheus_with_every_input_equals_jax(seed):
    kw = _inputs(seed)
    assert len(kw) == 15
    text = exporter.render_prometheus(**kw)
    assert text == jexporter.render_prometheus(**kw)
    families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
    assert families <= exporter.METRIC_REGISTRY.keys()
    assert len(families) == len(
        [line for line in text.splitlines() if line.startswith("# TYPE")])  # one header each
    for name in ("dlcfn_step_phase_ms", "dlcfn_input_pipeline_overlap_fraction",
                 "dlcfn_worker_up", "dlcfn_broker_role"):
        assert name in families


def test_each_input_alone_equals_jax():
    kw = _inputs(9)
    for key, value in kw.items():
        if key == "cluster":
            continue
        one = {key: value, "cluster": "c"}
        assert exporter.render_prometheus(**one) == jexporter.render_prometheus(**one), key


def test_registry_and_signature_equal_jax():
    import inspect

    assert exporter.METRIC_REGISTRY == jexporter.METRIC_REGISTRY
    assert list(inspect.signature(exporter.render_prometheus).parameters) == list(
        inspect.signature(jexporter.render_prometheus).parameters)
    assert json.dumps(exporter.render_prometheus()) == json.dumps("")
