"""The port's obs commands against the JAX package's, on the same files.

``status`` with ``--metrics-dir``, ``--profile`` and ``--serve`` (and the
journal's other folds: the input pipeline, comms, replay, data plane,
gauntlet, the scheduler), in json and in Prometheus text; ``trace`` over
per-host journals with planted clock skews; ``postmortem`` over black-box
bundles of skewed hosts.  The fixtures are the JAX tests' own
(``test_trace_export``, ``test_fleet_telemetry``) and journals written here;
each command's stdout (and ``trace``'s file and stderr summary) must equal
JAX's byte for byte: the folds compute no floating point beyond what both
sides read from the same JSON.
"""

import json
import sys
from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu import cli as jcli
except ImportError:  # the card's host
    jcli = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

pytestmark = pytest.mark.skipif(jcli is None, reason="needs JAX, the reference")


def _same(argv, capsys, rc=0, err=False):
    """The port's and JAX's ``main(argv)``: equal exit codes and stdout (and
    stderr with ``err``); the port's stdout."""
    outs = []
    for main in (cli.main, jcli.main):
        assert main(argv) == rc
        got = capsys.readouterr()
        outs.append((got.out, got.err if err else ""))
    assert outs[0] == outs[1]
    return outs[0][0]


def _everything_journal(path: Path) -> str:
    """A journal holding an event of every kind ``status`` folds: step
    profiles and two hosts' step times (``test_trace_export``'s fixture),
    two replicas' serving snapshots, and input-pipeline, comms-audit,
    replay-audit, data-plane, gauntlet, reshard and scheduler events."""
    from test_trace_export import _virtual_profiled_journal

    _virtual_profiled_journal(path)
    rec = FlightRecorder(path=path)
    for step, (replica, ttft) in enumerate((("pool-a", 12.5), ("pool-b", 40.25),
                                             ("pool-a", 14.0))):
        rec.record("serve_metrics", replica=replica, steps=10 + step, admitted=8, completed=6,
                   rejected=0, active_slots=2, queue_depth=3 - step, tokens_out=48,
                   tokens_per_s=512.5, ttft_ms={"p50": ttft, "p95": ttft * 2, "p99": ttft * 3},
                   itl_ms={"p50": 1.5, "p95": 2.0, "p99": 2.5}, free_blocks=20,
                   recycled_blocks=4, max_wait_steps=2, kv_transfer_bytes=0,
                   disaggregated=False)
    rec.record("input_pipeline", name="fit", bytes_transferred=4096, host_input_seconds=0.25,
               producer_stall_seconds=0.0, consumer_wait_seconds=0.125, overlap_fraction=0.75,
               batches=4)
    rec.record("comms_audit", programs={"train_step": {
        "collective_count": 6, "collective_bytes": 1 << 20, "peak_hbm_bytes": 3 << 20,
        "overlap_score": 0.5, "by_op": {"all-reduce": 6}, "unpredicted_gathers": 0}})
    rec.record("replay_audit", cases=5, divergent=["a"], clean=False)
    rec.record("datastream", records_per_s=1200.0, records_total=4800, shard_lag=3,
               reshard_total=1, ckpt_write_seconds=0.5, native_fallbacks=0)
    rec.record("gauntlet", mode="run", passed=True, faults=3, violations=0)
    rec.record("reshard", step=3, old_topology={"devices": 2, "axes": {"dp": 2}},
               new_topology={"devices": 1, "axes": {}}, grad_accum_before=1,
               grad_accum_after=2, seconds=0.4)
    rec.close()
    return str(path)


def _sched_events(path: Path) -> list[dict]:
    rec = FlightRecorder(path=path)
    events = [
        dict(kind="sched_decision", action="submit", jobs=2, free_slices=0,
             loans_outstanding=0, job="train-fsdp"),
        dict(kind="sched_preempt", seq=1, rule="serve-queue-depth", slice="s2",
             from_job="train-fsdp", to_job="serve-chat", loans_outstanding=1),
        dict(kind="sched_restore", seq=1, rule="serve-queue-depth", slice="s2",
             from_job="train-fsdp", to_job="serve-chat", loans_outstanding=0),
    ]
    for e in events:
        rec.record(**e)
    rec.close()
    return events


def _metrics_dir(base: Path) -> str:
    for run, workers in (("run-a", 2), ("run-b", 1)):
        (base / run).mkdir(parents=True)
        for w in range(workers):
            lines = [{"event": "train_step", "step": s, "loss": 2.0 - 0.25 * s,
                      "examples_per_sec": 100.0 + 7.25 * w + s, "mfu": 0.41234 + 0.01 * w,
                      "ts": 1.0, "process": w, "run": run} for s in range(3)]
            lines.append({"event": "eval", "step": 2, "accuracy": 0.5, "ts": 2.0,
                          "process": w, "run": run})
            text = "\n".join(json.dumps(x) for x in lines) + "\n{\"torn"
            (base / run / f"worker{w}.jsonl").write_text(text)
    return str(base)


@pytest.mark.parametrize("fmt", ["json", "prom"])
@pytest.mark.parametrize("flags", [["--profile"], ["--serve"], ["--profile", "--serve"], []])
def test_status_journal_sections_equal_jax(flags, fmt, tmp_path, capsys):
    journal = _everything_journal(tmp_path / "j.jsonl")
    out = _same(["status", "--journal", journal, *flags, "--format", fmt], capsys)
    if fmt == "prom":
        assert ("dlcfn_step_phase_ms" in out) == ("--profile" in flags)
        assert ("dlcfn_serve_ttft_ms" in out) == ("--serve" in flags)
        assert "dlcfn_input_pipeline_overlap_fraction" in out
    else:
        body = json.loads(out)
        assert ("profile" in body) == ("--profile" in flags)
        assert ("serve" in body) == ("--serve" in flags)
        assert {"input_pipeline", "comms", "replay", "datastream", "gauntlet",
                "reshard"} <= body.keys()


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_status_renders_the_scheduler_family(fmt, tmp_path, capsys):
    """The port's ``status`` folds the scheduler's events as well (JAX's
    renders the family only through ``render_prometheus(sched=)``): the
    section is JAX's fold, the text JAX's family, the rest JAX's status."""
    from deeplearning_cfn_tpu.obs import exporter as jexporter

    plain = _everything_journal(tmp_path / "plain.jsonl")
    both = _everything_journal(tmp_path / "both.jsonl")
    events = _sched_events(Path(both))
    assert cli.main(["status", "--journal", both, "--format", fmt]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["status", "--journal", plain, "--format", fmt]) == 0
    ref = capsys.readouterr().out
    folded = jexporter.fold_sched_events(events)
    if fmt == "json":
        body = json.loads(port)
        assert body.pop("sched") == folded and folded["preemptions"] == 1
        assert body == json.loads(ref)
    else:
        family = jexporter.render_prometheus(sched=folded)
        assert "dlcfn_sched_restores_total 1" in family
        assert port == ref + family


@pytest.mark.parametrize("with_journal", [False, True])
def test_status_metrics_dir_equals_jax(with_journal, tmp_path, capsys):
    argv = ["status", "--metrics-dir", _metrics_dir(tmp_path / "m")]
    if with_journal:
        argv += ["--journal", _everything_journal(tmp_path / "j.jsonl")]
    out = json.loads(_same(argv, capsys))
    workers = out["workers"] if with_journal else out
    assert [(w["run"], w["worker"], w["step"]) for w in workers] == [
        ("run-a", "worker0", 2), ("run-a", "worker1", 2), ("run-b", "worker0", 2)]
    assert workers[0]["eval"] == {"step": 2, "accuracy": 0.5}


def test_status_metrics_dir_empty_exits_1(tmp_path, capsys):
    _same(["status", "--metrics-dir", str(tmp_path)], capsys, rc=1, err=True)


def test_trace_equals_jax(tmp_path, capsys):
    from test_trace_export import _write_fixture

    paths = _write_fixture(tmp_path)
    files = []
    for main in (cli.main, jcli.main):
        out = tmp_path / f"trace-{len(files)}.json"
        argv = ["trace", "--out", str(out)]
        for p in paths:
            argv += ["--journal", p]
        assert main(argv) == 0
        err = capsys.readouterr().err
        files.append((out.read_text(), json.loads(err[err.index("{"):])))
    assert files[0] == files[1]
    assert files[0][1]["stragglers"]["top_straggler"] == "host-b"
    argv = ["trace", "--no-align"]
    for p in paths:
        argv += ["--journal", p]
    assert "traceEvents" in json.loads(_same(argv, capsys, err=False))
    _same(["trace", "--journal", str(tmp_path / "nope.jsonl")], capsys, rc=1, err=True)
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="needs --journal"):
            main(["trace"])


@pytest.mark.parametrize("argv", [[], ["--format", "json"], ["-n", "3"]])
def test_postmortem_equals_jax(argv, tmp_path, capsys):
    from test_fleet_telemetry import _skewed_bundles

    from deeplearning_cfn_tpu_torch.obs.blackbox import write_bundle

    ctl, w0 = _skewed_bundles()
    write_bundle(ctl, tmp_path / "blackbox-ctl.json")
    write_bundle(w0, tmp_path / "blackbox-w0.json")
    out = _same(["postmortem", str(tmp_path), *argv], capsys)
    assert "queue" in out
    files = [str(tmp_path / "blackbox-ctl.json"), str(tmp_path / "blackbox-w0.json")]
    assert _same(["postmortem", *files, *argv], capsys) == out
    _same(["postmortem", str(tmp_path / "blackbox-gone.json")], capsys, rc=1, err=True)
    empty = tmp_path / "empty"
    empty.mkdir()
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="needs bundle"):
            main(["postmortem", str(empty)])
