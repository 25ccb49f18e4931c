"""The port's liveness and fleet-telemetry plane against the JAX package's,
on the CPU, no card.

The copies (``obs/liveness``, ``obs/aggregator``, ``obs/blackbox``,
``obs/trace_export``, the heartbeater with its telemetry piggyback, the
liveness watcher of ``cluster/broker_service``, the liveness, broker and
fleet families of ``obs/exporter``) are driven beside the originals on the
same inputs, each side on its own ``FakeClock`` and recorder, and held
equal: transitions, snapshots, merged aggregates, bundle bytes, recovered
clock offsets, the merged timeline and the Prometheus text.  None of them
computes a float that could differ (rounding is the same ``round``).
"""

import json

import pytest

from deeplearning_cfn_tpu_torch.cluster import broker_service
from deeplearning_cfn_tpu_torch.obs import (
    aggregator,
    blackbox,
    exporter,
    heartbeat,
    liveness,
    recorder,
    trace_export,
)
from deeplearning_cfn_tpu_torch.provision import events
from deeplearning_cfn_tpu_torch.utils import timeouts

try:
    from deeplearning_cfn_tpu.cluster import broker_service as jbroker_service
    from deeplearning_cfn_tpu.obs import aggregator as jaggregator
    from deeplearning_cfn_tpu.obs import blackbox as jblackbox
    from deeplearning_cfn_tpu.obs import exporter as jexporter
    from deeplearning_cfn_tpu.obs import heartbeat as jheartbeat
    from deeplearning_cfn_tpu.obs import liveness as jliveness
    from deeplearning_cfn_tpu.obs import recorder as jrecorder
    from deeplearning_cfn_tpu.obs import trace_export as jtrace_export
    from deeplearning_cfn_tpu.provision import events as jevents
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host has no JAX package to compare with
    jaggregator = None

pytestmark = pytest.mark.skipif(jaggregator is None, reason="needs the JAX package")


def _side(side: str):
    if side == "port":
        return dict(agg=aggregator, bb=blackbox, exp=exporter, hb=heartbeat, live=liveness,
                    rec=recorder, tx=trace_export, ev=events, tm=timeouts, svc=broker_service)
    return dict(agg=jaggregator, bb=jblackbox, exp=jexporter, hb=jheartbeat, live=jliveness,
                rec=jrecorder, tx=jtrace_export, ev=jevents, tm=jtimeouts, svc=jbroker_service)


def _snap(gauges, summaries=None):
    return aggregator.encode_snapshot(aggregator.agent_snapshot(gauges, summaries))


# --- aggregator ----------------------------------------------------------------------

TABLES = {
    "two-hosts": {
        "g/0": (1.0, 3, _snap({"dlcfn_serve_queue_depth": 2.0}, {"dlcfn_step_ms": [10.0, 12.0]})),
        "g/1": (2.5, 1, _snap({"dlcfn_serve_queue_depth": 4.0, "dlcfn_mesh_workers": 1.0},
                              {"dlcfn_step_ms": [20.0]})),
    },
    "stale-and-corrupt": {
        "a": (500.0, 9, _snap({"x": 1.0})),
        "b": (0.5, 2, b"\xff not json"),
        "c": (0.25, 1, b"[1, 2]"),
        "d": (3.0, 4, _snap({"x": float("nan"), "y": 7.0}, {"s": [1.0, float("inf")]})),
    },
    "empty-summary": {"z": (0.0, 1, _snap({}, {"dlcfn_step_ms": []}))},
}
LIVENESS = {"g/0": {"state": "alive"}, "g/1": {"state": "dead"}, "g/2": {"state": "suspect"}}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("with_liveness", [False, True])
def test_fleet_merge_and_metric_values_equal_jax(table, with_liveness):
    out = []
    for side in ("port", "jax"):
        agg = _side(side)["agg"]
        merged = agg.FleetAggregator(stale_after_s=120.0).merge(
            TABLES[table], liveness=LIVENESS if with_liveness else None)
        out.append((merged, agg.fleet_metric_values(merged)))
    assert out[0] == out[1]
    # Insertion order of the table does not matter (sorted worker order).
    reordered = dict(reversed(list(TABLES[table].items())))
    assert aggregator.FleetAggregator().merge(reordered) == aggregator.FleetAggregator().merge(
        TABLES[table])


def test_snapshot_decode_and_telemetry_source_equal_jax():
    class Prof:
        def recent_step_ms(self):
            return [float(i) for i in range(100)]

    for payload in (b"", b"\xff", b"null", b"[]", b'{"v": 1}', _snap({"a": 1.0})):
        assert aggregator.decode_snapshot(payload) == jaggregator.decode_snapshot(payload)
    port = aggregator.telemetry_source("w/0", profiler=Prof(), gauges=lambda: {"g": 2.0})
    ref = jaggregator.telemetry_source("w/0", profiler=Prof(), gauges=lambda: {"g": 2.0})
    assert port() == ref() and port.__name__ == ref.__name__
    assert aggregator.encode_snapshot(port()) == jaggregator.encode_snapshot(ref())
    assert len(port()["summaries"]["dlcfn_step_ms"]) == aggregator.MAX_SUMMARY_SAMPLES


# --- liveness --------------------------------------------------------------------------

LIVENESS_SCRIPT = [
    ("expect", "w2"), ("beat", "w0"), ("observe", "w1", 3.0), ("sweep",), ("advance", 16.0),
    ("sweep",), ("beat", "w0"), ("advance", 50.0), ("sweep",), ("observe", "w1", 0.0, 7),
    ("sweep",), ("advance", 100.0), ("sweep",), ("beat", "w2"), ("sweep",),
]


def _liveness_trace(side: str, script) -> list:
    m = _side(side)
    clock = m["tm"].FakeClock()
    rec = m["rec"].FlightRecorder()
    seen = []
    table = m["live"].LivenessTable(config=m["live"].LivenessConfig(suspect_after_s=15.0,
                                                                   dead_after_s=60.0),
                                    clock=clock.now, recorder=rec,
                                    on_transition=lambda t: seen.append((t[0], t[1].value,
                                                                         t[2].value)))
    out = []
    for op, *args in script:
        if op == "advance":
            clock.advance(args[0])
        elif op == "sweep":
            out.append([(w, a.value, b.value) for w, a, b in table.sweep()])
            out.append(table.snapshot())
        else:
            getattr(table, op)(*args)
    out.append(seen)
    out.append([{k: v for k, v in e.items() if k not in ("ts", "host", "pid")}
                for e in rec.tail(100)])
    return out


def test_liveness_table_equals_jax():
    assert _liveness_trace("port", LIVENESS_SCRIPT) == _liveness_trace("jax", LIVENESS_SCRIPT)
    with pytest.raises(ValueError):
        liveness.LivenessConfig(suspect_after_s=10.0, dead_after_s=5.0)


def _watcher_trace(side: str, monkeypatch) -> list:
    """BrokerLivenessWatcher over a scripted heartbeat table: its polls, the
    INSTANCE_TERMINATE it publishes for a DEAD worker, and the
    heartbeat_observed events it journals for each new beat."""
    m = _side(side)
    monkeypatch.setattr(m["rec"], "_default", m["rec"].FlightRecorder())
    clock = m["tm"].FakeClock()
    bus = m["ev"].EventBus()
    published = []
    bus.subscribe(lambda e: published.append((e.kind.value, e.group, e.instance_id, e.detail)))
    tables = iter([  # polled 30 s apart: g/1 falls silent, then beats again
        {"g/0": (0.5, 1), "g/1": (1.0, 1)},
        {"g/0": (0.2, 2), "g/1": (31.0, 1)},
        {"g/0": (0.1, 3), "g/1": (61.0, 1)},
        {"g/0": (0.1, 3), "g/1": (0.0, 2)},
    ])
    watcher = m["svc"].BrokerLivenessWatcher("c", group="c-workers", bus=bus, clock=clock.now,
                                              fetch=lambda: next(tables))
    out = []
    for _ in range(4):
        out.append([(w, a.value, b.value) for w, a, b in watcher.poll()])
        out.append(watcher.snapshot())
        clock.advance(30.0)
    out.append(published)
    out.append([{k: v for k, v in e.items() if k not in ("ts", "host", "pid")}
                for e in m["rec"].get_recorder().tail(100)
                if e["kind"] in ("heartbeat_observed", "liveness")])
    return out


def test_liveness_watcher_equals_jax(monkeypatch):
    port = _watcher_trace("port", monkeypatch)
    assert port == _watcher_trace("jax", monkeypatch)
    assert port[-2][0][:3] == ("instance-terminate", "c-workers", "g/1")


# --- the heartbeater's telemetry piggyback --------------------------------------------


class _Conn:
    """The connection seam: records beats and TELEM frames, fails on cue."""

    def __init__(self, log, fail):
        self.log, self.fail = log, fail

    def heartbeat(self, worker_id):
        if self.fail.pop(0) if self.fail else False:
            raise ConnectionError("closed connection")
        self.log.append(("beat", worker_id))
        return len(self.log)

    def telem(self, worker_id, payload):
        self.log.append(("telem", worker_id, payload))
        return 1

    def close(self):
        self.log.append(("close",))


def _heartbeat_trace(side: str, monkeypatch) -> list:
    m = _side(side)
    monkeypatch.setattr(m["rec"], "_default", m["rec"].FlightRecorder())
    log, fail, dials = [], [False, True, False, False], []
    snaps = iter([{"gauges": {"a": 1.0}}, None, {"gauges": {"a": float("nan")}},
                  RuntimeError("snapshot failed")])

    def source():
        snap = next(snaps)
        if isinstance(snap, Exception):
            raise snap
        return snap

    def factory():
        dials.append(1)
        return _Conn(log, fail)

    hb = m["hb"].Heartbeater("h", 1, worker_id="g/0", interval_s=1.0,
                             connection_factory=factory, telemetry_source=source)
    landed = [hb.beat_step() for _ in range(5)]
    return [landed, log, len(dials), hb.beats_sent, hb.snapshots_sent,
            [{k: v for k, v in e.items() if k not in ("ts", "host", "pid")}
             for e in m["rec"].get_recorder().tail(100)]]


def test_heartbeater_telemetry_equals_jax(monkeypatch):
    """A beat that fails redials on the next; a telemetry failure is
    contained (the beat landed); the TELEM bytes are JAX's."""
    port = _heartbeat_trace("port", monkeypatch)
    assert port == _heartbeat_trace("jax", monkeypatch)
    landed, log, dials, beats, snaps, _ = port
    assert landed == [True, False, True, True, True] and dials == 2
    assert (beats, snaps) == (4, 2)
    assert ("telem", "g/0", b'{"gauges":{"a":null},"summaries":{},"v":1}') in log


def test_heartbeater_dials_a_broker_connection(monkeypatch):
    """With no connection factory the heartbeater dials BrokerConnection
    with its token and connect timeout, as JAX's does."""
    from deeplearning_cfn_tpu_torch.cluster import broker_client

    seen = []

    class Dialed:
        def __init__(self, host, port, timeout_s=10.0, token=None):
            seen.append((host, port, timeout_s, token))

        def heartbeat(self, worker_id):
            return 1

        def close(self):
            pass

    monkeypatch.setattr(broker_client, "BrokerConnection", Dialed)
    hb = heartbeat.Heartbeater("10.0.0.2", 8477, "g/3", token="tok", connect_timeout_s=2.5)
    assert hb.beat_step() and seen == [("10.0.0.2", 8477, 2.5, "tok")]


# --- trace export and the black box --------------------------------------------------

SKEWS = {"host-a": 3.0, "host-b": -2.0}
BASE = 1000.0


def _journals(tmp_path):
    """A supervisor and two skewed workers on one true timeline, written
    with the port's recorder (the JAX functions read the same files)."""
    paths = {name: tmp_path / f"{name}.jsonl" for name in ("sup", *SKEWS)}
    sup = recorder.FlightRecorder(path=paths["sup"])
    workers = {name: recorder.FlightRecorder(path=paths[name]) for name in SKEWS}
    for worker, skew in sorted(SKEWS.items()):
        for seq in (1, 2, 3):
            send = BASE + 10.0 * seq
            workers[worker].record("heartbeat_sent", worker=worker, seq=seq, ts=send + skew)
            sup.record("heartbeat_observed", worker=worker, seq=seq, age_s=1.0,
                       ts=send + 1.0, host="sup")
    for step in range(4):
        for worker, skew in sorted(SKEWS.items()):
            total = (60.0 if worker == "host-b" else 50.0) + step
            workers[worker].record("step_time", worker=worker, step=step, total_ms=total,
                                   dispatch_ms=total - 5.0, host_ms=5.0,
                                   ts=BASE + 100.0 + step + skew)
    workers["host-a"].record("span", worker="host-a", span="train_step", seconds=0.05,
                             step=1, ok=True, ts=BASE + 101.0 + SKEWS["host-a"])
    sup.record("alert", rule="r", state="firing", ts=BASE + 102.0, host="sup")
    for rec in (sup, *workers.values()):
        rec.close()
    return [str(paths[name]) for name in ("sup", "host-a", "host-b")]


@pytest.mark.parametrize("align", [True, False])
def test_trace_export_equals_jax(tmp_path, align):
    paths = _journals(tmp_path)
    out = []
    for side in ("port", "jax"):
        tx, rec = _side(side)["tx"], _side(side)["rec"]
        journals = {p: list(rec.read_journal(p)) for p in paths}
        merged, meta = tx.merge_journals(paths, align=align)
        out.append((tx.heartbeat_offsets(journals), merged, meta, tx.chrome_trace(merged),
                    tx.straggler_table(merged)))
    assert out[0] == out[1]
    offsets, reference = out[0][0]
    if align:
        assert reference == paths[0]
        assert offsets[paths[1]] == pytest.approx(-SKEWS["host-a"])


CONFIG = {"cluster": "c", "nan": float("nan")}  # one object: nan == itself only


def _bundles(side: str, tmp_path, paths) -> list:
    m = _side(side)
    out = []
    for p in paths:
        rec = m["rec"].FlightRecorder()
        for e in m["rec"].read_journal(p):
            rec.record(e.pop("kind"), **{k: v for k, v in e.items() if k != "pid"})
        host = p.rsplit("/", 1)[1].split(".")[0]
        out.append(m["bb"].capture_bundle("crash", host=host, worker=host, recorder=rec,
                                          config=CONFIG,
                                          clock=lambda: 1234.5))
    return out


def test_blackbox_bundles_and_timeline_equal_jax(tmp_path):
    paths = _journals(tmp_path)
    port, ref = _bundles("port", tmp_path, paths), _bundles("jax", tmp_path, paths)
    assert port == ref
    for name, (bb, bundles) in {"port": (blackbox, port), "jax": (jblackbox, ref)}.items():
        bb.write_bundle(bundles[1], tmp_path / name / "bundle.json")
    raw = (tmp_path / "port" / "bundle.json").read_bytes()
    assert raw == (tmp_path / "jax" / "bundle.json").read_bytes()
    assert blackbox.read_bundle(tmp_path / "port" / "bundle.json")["config"]["nan"] is None
    merged = blackbox.merge_bundles(port)
    assert merged == jblackbox.merge_bundles(ref)
    assert blackbox.render_timeline(merged) == jblackbox.render_timeline(merged)
    assert blackbox.render_timeline(merged, last_n=3) == jblackbox.render_timeline(merged,
                                                                                    last_n=3)


def test_blackbox_captures_on_terminate_as_jax(tmp_path):
    out = []
    for side in ("port", "jax"):
        m = _side(side)
        bus = m["ev"].EventBus()
        box = m["bb"].BlackBox(tmp_path / side, host="h0", worker="g/0", instance_id="i-0",
                               recorder=m["rec"].FlightRecorder(), clock=lambda: 5.0)
        box.attach(bus)
        box.attach(bus)  # idempotent
        for instance in ("i-9", "i-0"):
            bus.publish(m["ev"].LifecycleEvent(kind=m["ev"].EventKind.INSTANCE_TERMINATE,
                                               group="g", instance_id=instance))
        box.detach(bus)
        bus.publish(m["ev"].LifecycleEvent(kind=m["ev"].EventKind.INSTANCE_TERMINATE,
                                           group="g", instance_id="i-0"))
        out.append((box.captures, json.loads(box.path.read_text())))
    assert out[0] == out[1] and out[0][0] == 1
    assert out[0][1]["reason"] == "instance-terminate:i-0"


# --- exporter ---------------------------------------------------------------------------

BROKER_VIEWS = {
    "pair": {"primary": {"host": "h", "port": 1, "alive": True, "role": "primary", "epoch": 2},
             "standby": {"host": "h", "port": 2, "alive": False, "role": "standby", "epoch": 2},
             "lag_entries": 3, "lag_seconds": 0.5, "events": {"promotions": 1}},
    "single": {"primary": {"host": "h", "port": 1, "alive": True, "role": "primary",
                           "epoch": 0}, "standby": None, "lag_entries": None,
               "lag_seconds": None},
    "sharded": {"cluster": "c", "n_shards": 2, "degraded_shards": 1, "shards": [
        {"shard": 0, "status": {"primary": {"host": "h", "port": 1, "alive": True,
                                            "role": "primary", "epoch": 1},
                                "standby": None, "lag_entries": 0, "lag_seconds": 0.0}},
        {"shard": 1, "status": None}]},
}


@pytest.mark.parametrize("view", sorted(BROKER_VIEWS))
def test_render_liveness_broker_fleet_equals_jax(view):
    live = {"g/0": {"state": "alive", "age_s": 1.0, "beats": 3},
            "g/1": {"state": "dead", "age_s": 99.0, "beats": 1}}
    fleet = aggregator.FleetAggregator().merge(TABLES["two-hosts"], liveness=live)
    spans = {"rpc.ping": {"count": 2, "total_s": 0.5, "max_s": 0.3, "p50_s": 0.2,
                          "p95_s": 0.3, "p99_s": 0.3}}
    kw = dict(cluster="c", broker=BROKER_VIEWS[view], fleet=fleet)
    text = exporter.render_prometheus(live, spans, **kw)
    assert text == jexporter.render_prometheus(live, spans, **kw)
    assert text.count("# TYPE dlcfn_worker_dead_fraction") == 1
    assert set(exporter.METRIC_REGISTRY) <= set(jexporter.METRIC_REGISTRY)
    for name, entry in exporter.METRIC_REGISTRY.items():
        assert entry == jexporter.METRIC_REGISTRY[name]


def test_fold_broker_events_equals_jax():
    evs = [{"kind": "broker_promoted", "ts": 1.0, "cluster": "c", "epoch": 2},
           {"kind": "span", "span": "x"},
           {"kind": "standby_reprovisioned", "ts": 2.0, "cluster": "c", "epoch": 2,
            "replayed": 7}]
    for case in (evs, evs[:1], evs[1:2], []):
        assert exporter.fold_broker_events(case) == jexporter.fold_broker_events(case)
