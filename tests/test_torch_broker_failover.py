"""Client-side broker failover in the port (``FailoverBrokerConnection``):
the cases of ``tests/test_broker_failover.py`` — endpoint walking, outage
classification, idempotent re-send, endpoint refresh from a rewritten
record — all through the ``dial`` seam, no native broker, no wall clock;
then the same scripted failovers driven through the port's and the JAX
package's connections side by side, their traces held equal.
"""

import pytest

from deeplearning_cfn_tpu_torch.cluster import broker_client
from deeplearning_cfn_tpu_torch.cluster.broker_client import (
    BrokerError,
    FailoverBrokerConnection,
    endpoints_from_record,
)
from deeplearning_cfn_tpu_torch.obs import recorder as recorder_mod
from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder
from deeplearning_cfn_tpu_torch.utils import timeouts
from deeplearning_cfn_tpu_torch.utils.timeouts import FakeClock

try:
    from deeplearning_cfn_tpu.cluster import broker_client as jbroker_client
    from deeplearning_cfn_tpu.obs import recorder as jrecorder_mod
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host has no JAX package to compare with
    jbroker_client = None


class FakeBroker:
    """One in-memory endpoint behind the dial seam."""

    def __init__(self, primary: bool = True):
        self.up = True
        self.primary = primary
        self.sent: list[tuple[str, str, bytes]] = []
        self.rids: set[str] = set()
        self.dials = 0
        self.die_after_apply = 0  # applies, then drops the connection

    def apply(self, queue: str, body: bytes, rid: str) -> None:
        if rid not in self.rids:
            self.rids.add(rid)
            self.sent.append((queue, rid, body))


class FakeConn:
    def __init__(self, broker: FakeBroker):
        self.broker = broker

    def ping(self) -> bool:
        if not self.broker.up:
            raise ConnectionError("closed connection")
        return True

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        if not self.broker.up:
            raise ConnectionError("closed connection")
        if not self.broker.primary:
            raise BrokerError("SENDID failed: ERR not primary")
        self.broker.apply(queue, body, rid)
        if self.broker.die_after_apply:
            self.broker.die_after_apply -= 1
            raise ConnectionError("peer closed connection mid-RPC")
        return rid

    def close(self) -> None:
        pass


def make_pair():
    """A primary at ('a', 1) and a standby at ('b', 2), plus a dial."""
    a, b = FakeBroker(primary=True), FakeBroker(primary=False)
    table = {("a", 1): a, ("b", 2): b}

    def dial(host, port):
        broker = table[(host, port)]
        broker.dials += 1
        if not broker.up:
            raise ConnectionError("connection refused")
        return FakeConn(broker)

    return a, b, dial


def make_conn(dial, clock=None):
    return FailoverBrokerConnection(
        [("a", 1), ("b", 2)], dial=dial, clock=clock or FakeClock()
    )


def test_send_fails_over_to_promoted_standby():
    a, b, dial = make_pair()
    conn = make_conn(dial)
    assert conn.ping()  # established on the primary
    a.up = False
    b.primary = True  # the service's _adopt_standby ran
    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    assert conn.failovers == 1
    assert conn.active_endpoint == ("b", 2)
    assert b.sent == [("work", "r1", b"job")]


def test_failover_is_not_an_outage_breaker_regression(monkeypatch):
    """Satellite #2: after a successful failover the adopted endpoint's
    breaker is CLOSED with zero failures (the switch consumed none of its
    budget), the dead endpoint's breaker holds exactly its own failures,
    and the switch is journaled as broker_failover — not as an outage."""
    # A private process-wide recorder: the shared ring buffer may already
    # hold thousands of events from earlier tests, so index math on its
    # tail is not a stable way to isolate this test's own journal.
    monkeypatch.setattr(recorder_mod, "_default", FlightRecorder())
    a, b, dial = make_pair()
    conn = make_conn(dial)
    assert conn.ping()
    a.up = False
    b.primary = True
    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    new = conn.breaker(("b", 2))
    assert new.state == "closed"
    assert new.consecutive_failures == 0
    old = conn.breaker(("a", 1))
    assert old.consecutive_failures == 1  # the dead endpoint's own dial failure, kept
    events = [
        e for e in recorder_mod.get_recorder().tail(500)
        if e.get("kind") == "broker_failover"
    ]
    assert len(events) == 1
    assert events[0]["from_host"] == "a" and events[0]["to_host"] == "b"


def test_resend_after_mid_rpc_death_does_not_double_enqueue():
    """The at-least-once wire contract: the primary applies the SENDID
    but dies before the OK — the client's retry (same rid) walks the
    endpoints, comes back, and the idempotency key dedups the re-apply."""
    a, b, dial = make_pair()
    conn = make_conn(dial)
    a.die_after_apply = 1
    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    assert a.sent == [("work", "r1", b"job")]  # applied exactly once
    assert len(a.rids) == 1


def test_not_primary_advances_instead_of_raising():
    a, b, dial = make_pair()
    a.primary, b.primary = False, True  # client's record file is stale
    conn = make_conn(dial)
    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    assert b.sent and not a.sent
    assert conn.breaker(("a", 1)).consecutive_failures == 1


def test_open_breaker_skips_endpoint_without_dialing():
    a, b, dial = make_pair()
    b.primary = True
    conn = make_conn(dial)
    for _ in range(3):  # trip ('a', 1)'s breaker (threshold 3)
        conn.breaker(("a", 1)).record_failure()
    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    assert a.dials == 0  # open breaker = skip, not a dead end
    assert b.sent == [("work", "r1", b"job")]


def test_every_endpoint_down_raises_broker_error():
    a, b, dial = make_pair()
    a.up = b.up = False
    conn = make_conn(dial)
    with pytest.raises(BrokerError, match="no broker endpoint available"):
        conn.ping()


def test_non_endpoint_errors_propagate():
    """Application-level rejections (bad arguments, AUTH) are NOT
    failover triggers — walking endpoints cannot fix them."""
    a, b, dial = make_pair()
    conn = make_conn(dial)

    def bad_rpc(c):
        raise BrokerError("SENDID failed: ERR bad idempotency key")

    with pytest.raises(BrokerError, match="bad idempotency key"):
        conn._call("send_idempotent", bad_rpc)
    assert conn.breaker(("a", 1)).consecutive_failures == 0


def test_refreshes_endpoints_from_rewritten_record():
    """Satellite #1 of the sharded control plane: adoption +
    auto-re-provision REWRITES the broker record (promoted standby first,
    fresh standby appended), so a client built from the stale endpoint
    list must re-read it once the walk exhausts — and reach the
    re-provisioned pair instead of erroring out on addresses that no
    longer serve."""
    a = FakeBroker(primary=True)
    b = FakeBroker(primary=False)
    c = FakeBroker(primary=False)
    table = {("a", 1): a, ("b", 2): b, ("c", 3): c}

    def dial(host, port):
        broker = table[(host, port)]
        broker.dials += 1
        if not broker.up:
            raise ConnectionError("connection refused")
        return FakeConn(broker)

    record_endpoints = [[("a", 1), ("b", 2)]]  # mutable "record file"
    conn = FailoverBrokerConnection(
        record_endpoints[0],
        dial=dial,
        clock=FakeClock(),
        endpoints_source=lambda: record_endpoints[0],
    )
    assert conn.ping()
    survivor_breaker = conn.breaker(("b", 2))

    # Primary dies; the standby is adopted, re-provisions a fresh standby
    # at ('c', 3), and the record is rewritten with the new pair.
    a.up = False
    b.primary = True
    record_endpoints[0] = [("b", 2), ("c", 3)]

    assert conn.send_idempotent("work", b"job", "r1") == "r1"
    assert b.sent == [("work", "r1", b"job")]

    # Now the promoted node dies too: only the REFRESHED list knows about
    # ('c', 3) — the stale list would dead-end.
    b.up = False
    c.primary = True
    record_endpoints[0] = [("c", 3), ("b", 2)]
    assert conn.send_idempotent("work", b"job2", "r2") == "r2"
    assert c.sent == [("work", "r2", b"job2")]
    assert conn.endpoint_refreshes == 1
    assert conn.active_endpoint == ("c", 3)
    # The surviving endpoint kept its breaker (its failure history is its
    # own); the vanished endpoint's breaker was dropped with it.
    assert conn.breaker(("b", 2)) is survivor_breaker
    assert ("a", 1) not in conn._breakers


def test_refresh_unchanged_list_still_raises():
    """When the record has NOT been rewritten, the refresh pass is a
    no-op and the walk's BrokerError propagates — no infinite retry."""
    a, b, dial = make_pair()
    a.up = b.up = False
    conn = FailoverBrokerConnection(
        [("a", 1), ("b", 2)],
        dial=dial,
        clock=FakeClock(),
        endpoints_source=lambda: [("a", 1), ("b", 2)],
    )
    with pytest.raises(BrokerError, match="no broker endpoint available"):
        conn.ping()
    assert conn.endpoint_refreshes == 0


def test_endpoints_from_record_shapes():
    replicated = {
        "host": "10.0.0.1",
        "port": 8477,
        "endpoints": [["10.0.0.1", 8477], ["10.0.0.2", 9001]],
    }
    assert endpoints_from_record(replicated) == [
        ("10.0.0.1", 8477),
        ("10.0.0.2", 9001),
    ]
    legacy = {"host": "10.0.0.1", "port": 8477}
    assert endpoints_from_record(legacy) == [("10.0.0.1", 8477)]


# --- the port's failover held to the JAX package's ---------------------------------


def _failover_trace(side: str, script: str, monkeypatch) -> list:
    """Drive ``script`` through one side's FailoverBrokerConnection over the
    same fakes (raising that side's BrokerError) on that side's FakeClock;
    the trace holds every answer, error, breaker and journaled failover."""
    bc, rec_mod, tm = ((broker_client, recorder_mod, timeouts) if side == "port"
                       else (jbroker_client, jrecorder_mod, jtimeouts))
    monkeypatch.setattr(rec_mod, "_default", rec_mod.FlightRecorder())
    brokers = {("a", 1): FakeBroker(True), ("b", 2): FakeBroker(False),
               ("c", 3): FakeBroker(False)}
    record = [[("a", 1), ("b", 2)]]

    class Conn(FakeConn):
        def send_idempotent(self, queue, body, rid):
            if self.broker.up and not self.broker.primary:
                raise bc.BrokerError("SENDID failed: ERR not primary")
            return super().send_idempotent(queue, body, rid)

    def dial(host, port):
        broker = brokers[(host, port)]
        broker.dials += 1
        if not broker.up:
            raise ConnectionError("connection refused")
        return Conn(broker)

    clock = tm.FakeClock()
    conn = bc.FailoverBrokerConnection(record[0], dial=dial, clock=clock,
                                       endpoints_source=lambda: record[0])
    trace = []

    def call(fn):
        try:
            trace.append(("ok", fn()))
        except bc.BrokerError as e:
            trace.append(("BrokerError", str(e).split(" (endpoints")[0]))

    for step in script.split(","):
        if step == "ping":
            call(conn.ping)
        elif step.startswith("send"):
            call(lambda rid=step: conn.send_idempotent("work", b"job", rid))
        elif step.startswith("down-") or step.startswith("up-") or step.startswith("promote-"):
            what, name = step.split("-")
            broker = brokers[{"a": ("a", 1), "b": ("b", 2), "c": ("c", 3)}[name]]
            if what == "promote":
                broker.primary = True
            else:
                broker.up = what == "up"
        elif step == "rewrite":
            record[0] = [("b", 2), ("c", 3)]
        elif step == "wait":
            clock.advance(6.0)  # past the breakers' reset_after_s
        elif step == "die-after-apply":
            brokers[("a", 1)].die_after_apply = 1
        trace.append((conn.active_endpoint, conn.failovers, conn.endpoint_refreshes))
    trace.append({ep: (conn.breaker(ep).state, conn.breaker(ep).consecutive_failures)
                  for ep in conn._breakers})
    trace.append({ep: (b.sent, b.dials) for ep, b in brokers.items()})
    trace.append([{k: v for k, v in e.items() if k not in ("ts", "host", "pid")}
                  for e in rec_mod.get_recorder().tail(100) if e["kind"] == "broker_failover"])
    return trace


@pytest.mark.skipif(jbroker_client is None, reason="needs the JAX package")
@pytest.mark.parametrize("script", [
    "ping,down-a,promote-b,send-r1,send-r2",
    "die-after-apply,send-r1,send-r1",
    "down-a,down-b,ping,wait,up-a,ping",
    "ping,down-a,promote-b,rewrite,send-r1,down-b,promote-c,send-r2,send-r3",
    "ping,ping,ping,down-a,down-b,send-r1,wait,up-b,promote-b,send-r2",
], ids=["failover", "resend", "all-down-then-back", "refresh", "breaker-reset"])
def test_failover_traces_equal_jax(script, monkeypatch):
    port = _failover_trace("port", script, monkeypatch)
    assert port == _failover_trace("jax", script, monkeypatch)
