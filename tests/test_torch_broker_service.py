"""The port's broker as a stack resource (``cluster/broker_service.py``).

The cases of ``tests/test_broker_service.py`` on the port's service and its
build of the broker: ensure, reuse, teardown, stale records and logs, the
advertise rewrite and the bind union, the AUTH token kept across restarts,
the spawn lock and its recycled-pid handling, the warm standby and its
adoption, the sharded pairs.  Every test that starts a broker tears it down
in a ``finally`` and checks the pid is gone.  Then the records the port
writes are held equal to the JAX package's for the same inputs, with the
pid, port, token and start time normalised (each side under its own root).
``detect_host_ip`` is pinned to a local address so no test opens a socket
toward an outside host.
"""

import json
import os
import re
import shutil
from pathlib import Path

import pytest

from deeplearning_cfn_tpu_torch.cluster import broker_client, broker_service
from deeplearning_cfn_tpu_torch.cluster.broker_service import (
    broker_status,
    ensure_broker,
    teardown_broker,
)

try:
    from deeplearning_cfn_tpu.cluster import broker_service as jbroker_service
except ImportError:  # the card's host has no JAX package to compare with
    jbroker_service = None

pytestmark = [
    pytest.mark.smoke,
    pytest.mark.skipif(
        shutil.which("g++") is None,
        reason="native toolchain unavailable",
    ),
]

# A documentation address (RFC 5737): never a local interface, so the
# broker skips it as it skips a NAT address.
HOST_IP = "192.0.2.10"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    # No ambient token (BrokerConnection reads $DLCFN_BROKER_TOKEN), and this
    # host's "outbound address" pinned: the real probe opens a UDP socket.
    monkeypatch.delenv("DLCFN_BROKER_TOKEN", raising=False)
    monkeypatch.setattr(broker_service, "detect_host_ip", lambda: HOST_IP)
    if jbroker_service is not None:
        monkeypatch.setattr(jbroker_service, "detect_host_ip", lambda: HOST_IP)


def test_ensure_reuse_teardown_cycle(tmp_path):
    host, port, started = ensure_broker("svc", root=tmp_path)
    try:
        assert started is True
        assert host == "127.0.0.1"
        status = broker_status("svc", root=tmp_path)
        assert status is not None and status["alive"] is True

        # Idempotent: a second ensure reuses the live broker.
        host2, port2, started2 = ensure_broker("svc", root=tmp_path)
        assert (host2, port2, started2) == (host, port, False)
    finally:
        out = teardown_broker("svc", root=tmp_path)
    assert out["broker"] == "stopped"
    assert broker_status("svc", root=tmp_path) is None
    # The pid is really gone.
    with pytest.raises(ProcessLookupError):
        os.kill(int(out["pid"]), 0)


def test_stale_record_is_replaced(tmp_path):
    rec = tmp_path / "broker" / "svc.json"
    rec.parent.mkdir(parents=True)
    # A dead broker: valid record shape, nothing listening.
    rec.write_text(
        json.dumps({"cluster": "svc", "host": "127.0.0.1", "port": 1, "pid": 1})
    )
    host, port, started = ensure_broker("svc", root=tmp_path)
    try:
        assert started is True
        assert port != 1
    finally:
        teardown_broker("svc", root=tmp_path)


def test_restart_after_crash_ignores_stale_log(tmp_path):
    """A crashed broker leaves a log whose 'listening on <port>' line must
    not be mistaken for the NEW broker's port on restart (the log is
    truncated on spawn, not appended)."""
    rec = tmp_path / "broker" / "svc.json"
    rec.parent.mkdir(parents=True)
    rec.write_text(
        json.dumps({"cluster": "svc", "host": "127.0.0.1", "port": 1, "pid": 1})
    )
    rec.with_suffix(".log").write_text("dlcfn-broker listening on 1\n")
    host, port, started = ensure_broker("svc", root=tmp_path)
    try:
        assert started is True
        assert port != 1
        assert broker_status("svc", root=tmp_path)["alive"] is True
    finally:
        teardown_broker("svc", root=tmp_path)


def test_reuse_rewrites_advertise_address(tmp_path):
    """Re-running with a different --broker-advertise must take effect —
    and because the original broker bound loopback only, the service must
    RESTART it with the wider bind set rather than hand VMs an address
    nothing listens on."""
    _, port, _ = ensure_broker("svc", root=tmp_path, advertise="127.0.0.1")
    try:
        host2, port2, started2 = ensure_broker(
            "svc", root=tmp_path, advertise="10.9.9.9"
        )
        assert (host2, started2) == ("10.9.9.9", True)
        rec = json.loads((tmp_path / "broker" / "svc.json").read_text())
        assert rec["host"] == "10.9.9.9"
        # The unroutable test address cannot actually bind here: it is
        # recorded as ATTEMPTED (so reuse does not restart-loop on it)
        # but never as an actual bind; the host's own interface is what
        # serves the forwarded traffic.
        assert "10.9.9.9" in rec["binds_requested"].split(",")
        assert "10.9.9.9" not in rec["binds"].split(",")
        assert broker_status("svc", root=tmp_path)["alive"] is True

        # A third ensure with the SAME advertise reuses — no restart loop
        # on a permanently-unbindable advertise address.
        host3, port3, started3 = ensure_broker(
            "svc", root=tmp_path, advertise="10.9.9.9"
        )
        assert (host3, port3, started3) == ("10.9.9.9", port2, False)
    finally:
        teardown_broker("svc", root=tmp_path)


def test_ensure_broker_spawns_with_auth_token(tmp_path):
    """--broker auto provisions an AUTH-required broker: the token is
    generated at spawn, recorded operator-only (0600), honored by
    token-bearing clients, and a wrong/missing token cannot register or
    read rendezvous state (VERDICT r4 weak #5)."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import (
        BrokerConnection,
        BrokerError,
        BrokerQueue,
    )
    from deeplearning_cfn_tpu_torch.cluster.broker_service import broker_token

    _, port, _ = ensure_broker("svc", root=tmp_path)
    try:
        token = broker_token("svc", root=tmp_path)
        assert token
        rec_file = tmp_path / "broker" / "svc.json"
        assert (rec_file.stat().st_mode & 0o777) == 0o600
        # Right token: register + read state.
        q = BrokerQueue("reg", "127.0.0.1", port, token=token)
        q.send({"event": "worker-ready"})
        assert q.approximate_depth() == 1
        q.close()
        # No token: every state verb rejected.
        bare = BrokerConnection("127.0.0.1", port, token="")
        assert bare.ping()  # liveness stays open
        with pytest.raises(BrokerError):
            bare.receive("reg", 10, 0)
        # Wrong token: handshake itself fails.
        with pytest.raises(BrokerError, match="AUTH rejected"):
            BrokerConnection("127.0.0.1", port, token="not-the-token")
    finally:
        teardown_broker("svc", root=tmp_path)


def test_dead_broker_restart_preserves_token(tmp_path):
    """A crashed broker (or rebooted operator host) must come back with
    the SAME AUTH token: live VMs hold it in instance metadata, and a
    regenerated secret would permanently lock them out of their own
    control plane."""
    import os
    import signal
    import time

    from deeplearning_cfn_tpu_torch.cluster.broker_service import broker_token

    _, port, _ = ensure_broker("svc", root=tmp_path)
    try:
        token = broker_token("svc", root=tmp_path)
        rec = json.loads((tmp_path / "broker" / "svc.json").read_text())
        os.kill(int(rec["pid"]), signal.SIGKILL)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if not broker_status("svc", root=tmp_path)["alive"]:
                break
            time.sleep(0.05)
        _, port2, started2 = ensure_broker("svc", root=tmp_path)
        assert started2 is True
        assert broker_token("svc", root=tmp_path) == token
    finally:
        teardown_broker("svc", root=tmp_path)


def test_restart_unions_previous_binds(tmp_path):
    """A bind-widening restart must serve the UNION of the old broker's
    interfaces and the new advertise (ADVICE r4): otherwise two CLIs
    passing different advertise addresses ping-pong — each restart binds
    only its own, re-failing the other's reuse check forever."""
    from deeplearning_cfn_tpu_torch.cluster.broker_service import broker_token

    ensure_broker("svc", root=tmp_path, advertise="10.1.1.1")
    first_token = broker_token("svc", root=tmp_path)
    try:
        host2, port2, started2 = ensure_broker(
            "svc", root=tmp_path, advertise="10.2.2.2"
        )
        assert started2 is True  # widening restart happened
        rec = json.loads((tmp_path / "broker" / "svc.json").read_text())
        attempted = set(rec["binds_requested"].split(","))
        assert {"10.1.1.1", "10.2.2.2"} <= attempted
        # The AUTH token survives the restart: agents provisioned by the
        # FIRST CLI hold the old token in VM metadata — a regenerated
        # token would permanently lock them out.
        assert first_token and rec["token"] == first_token
        # The first CLI's advertise now reuses instead of restarting back:
        # the ping-pong is broken after exactly one restart.
        host3, port3, started3 = ensure_broker(
            "svc", root=tmp_path, advertise="10.1.1.1"
        )
        assert (port3, started3) == (port2, False)
    finally:
        teardown_broker("svc", root=tmp_path)


def test_teardown_leaves_live_holders_lock(tmp_path):
    """teardown must not unlink a spawn lock held by a LIVE process
    (ADVICE r4): yanking the winner's exclusive-create lock would let a
    third caller spawn a second broker concurrently.  Dead holders' locks
    are still cleaned."""
    import subprocess
    import sys

    ensure_broker("svc", root=tmp_path)
    lock = tmp_path / "broker" / "svc.lock"
    holder = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        lock.write_text(str(holder.pid))
        teardown_broker("svc", root=tmp_path)
        assert lock.exists(), "live holder's lock was removed"
    finally:
        holder.kill()
        holder.wait()
    # Same teardown with the holder dead: the lock is cleaned up.
    ensure_broker("svc", root=tmp_path)
    lock.write_text(str(holder.pid))
    teardown_broker("svc", root=tmp_path)
    assert not lock.exists()


def test_reuse_without_advertise_change_keeps_broker(tmp_path):
    """A same-advertise reuse (the common run-after-create path) must not
    restart anything."""
    _, port, _ = ensure_broker("svc", root=tmp_path, advertise="127.0.0.1")
    try:
        host2, port2, started2 = ensure_broker(
            "svc", root=tmp_path, advertise="127.0.0.1"
        )
        assert (host2, port2, started2) == ("127.0.0.1", port, False)
    finally:
        teardown_broker("svc", root=tmp_path)


def test_concurrent_ensure_waits_on_lock(tmp_path):
    """A held lock makes the second caller wait for the first's record
    instead of spawning a duplicate (leaked) broker."""
    import threading
    import time as _time

    lock = tmp_path / "broker" / "svc.lock"
    lock.parent.mkdir(parents=True)
    # Holder = THIS (live) process; a dead holder pid would trigger the
    # stale-reclaim path instead (tested separately below).
    lock.write_text(str(os.getpid()))
    results = {}

    def second():
        results["out"] = ensure_broker("svc", root=tmp_path, timeout_s=10)

    t = threading.Thread(target=second)
    t.start()
    _time.sleep(0.3)
    # First caller publishes its record and releases the lock.
    host, port, _ = ensure_broker("first", root=tmp_path)
    try:
        rec = tmp_path / "broker" / "svc.json"
        rec.write_text(
            json.dumps(
                {"cluster": "svc", "host": "127.0.0.1", "port": port,
                 "pid": json.loads((tmp_path / "broker" / "first.json").read_text())["pid"]}
            )
        )
        lock.unlink()
        t.join(timeout=15)
        assert not t.is_alive()
        assert results["out"] == ("127.0.0.1", port, False)
    finally:
        teardown_broker("first", root=tmp_path)
        (tmp_path / "broker" / "svc.json").unlink(missing_ok=True)


def test_lock_wait_path_applies_advertise_rewrite(tmp_path):
    """A caller that loses the spawn race but passes its own advertise
    address must get that address back (and recorded) — not the winner's.
    Same contract as the uncontended reuse path."""
    import threading
    import time as _time

    lock = tmp_path / "broker" / "svc.lock"
    lock.parent.mkdir(parents=True)
    lock.write_text(str(os.getpid()))
    results = {}

    def second():
        results["out"] = ensure_broker(
            "svc", root=tmp_path, advertise="10.7.7.7", timeout_s=10
        )

    t = threading.Thread(target=second)
    t.start()
    _time.sleep(0.3)
    host, port, _ = ensure_broker("first", root=tmp_path)
    try:
        rec = tmp_path / "broker" / "svc.json"
        rec.write_text(
            json.dumps(
                {"cluster": "svc", "host": "127.0.0.1", "port": port,
                 "pid": json.loads((tmp_path / "broker" / "first.json").read_text())["pid"]}
            )
        )
        lock.unlink()
        t.join(timeout=15)
        assert not t.is_alive()
        assert results["out"] == ("10.7.7.7", port, False)
        assert json.loads(rec.read_text())["host"] == "10.7.7.7"
    finally:
        teardown_broker("first", root=tmp_path)
        (tmp_path / "broker" / "svc.json").unlink(missing_ok=True)


def test_bind_addresses_scope():
    """The broker is never handed an all-interfaces bind: loopback only
    for the local backend; loopback + advertise (+ the host's outbound
    interface for non-local advertise addresses) otherwise."""
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        _bind_addresses,
        detect_host_ip,
    )

    assert _bind_addresses(None) == "127.0.0.1"
    assert _bind_addresses("127.0.0.1") == "127.0.0.1"
    host_ip = detect_host_ip()
    addrs = _bind_addresses("203.0.113.9").split(",")
    assert addrs[0] == "127.0.0.1"
    assert "203.0.113.9" in addrs
    assert "*" not in addrs and "0.0.0.0" not in addrs
    if host_ip != "127.0.0.1":
        assert host_ip in addrs


def test_broker_binary_skips_unbindable_address(tmp_path):
    """The binary binds what it can from the list and serves: a NAT/public
    advertise address that is not a local interface must not be fatal."""
    import subprocess
    import time as _time

    from deeplearning_cfn_tpu_torch.cluster.broker_client import build_broker

    binary = build_broker()
    log_path = tmp_path / "b.log"
    with open(log_path, "wb") as fh:
        proc = subprocess.Popen(
            [str(binary), "0", "127.0.0.1,203.0.113.9"],
            stdout=fh, stderr=subprocess.STDOUT,
        )
    try:
        deadline = _time.monotonic() + 10
        port = None
        while _time.monotonic() < deadline and port is None:
            text = log_path.read_text(errors="replace")
            m = re.search(r"listening on (\d+)", text)
            if m:
                port = int(m.group(1))
                break
            _time.sleep(0.05)
        assert port, log_path.read_text(errors="replace")
        assert "skipping unbindable address 203.0.113.9" in log_path.read_text(
            errors="replace"
        )
        from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

        conn = BrokerConnection("127.0.0.1", port, timeout_s=2)
        try:
            assert conn.ping()
        finally:
            conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=5)


def test_stale_lock_from_dead_holder_is_reclaimed(tmp_path):
    """A crash between lock-create and unlink must not brick --broker
    auto: a lock whose recorded holder pid is dead is reclaimed and the
    broker starts normally."""
    lock = tmp_path / "broker" / "svc.lock"
    lock.parent.mkdir(parents=True)
    # Spawn-and-reap a child so its pid is known-dead.
    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    lock.write_text(str(proc.pid))
    host, port, started = ensure_broker("svc", root=tmp_path, timeout_s=15)
    try:
        assert started is True
        assert broker_status("svc", root=tmp_path)["alive"] is True
    finally:
        teardown_broker("svc", root=tmp_path)


def test_unlink_lock_tolerates_concurrent_reaper(tmp_path, monkeypatch):
    """Two teardowns racing on the same stale lock: the loser's rename
    hits FileNotFoundError and must treat it as success (the lock is
    gone either way), not crash the teardown."""
    from deeplearning_cfn_tpu_torch.cluster.broker_service import _unlink_lock_if_stale

    import subprocess
    import sys

    lock = tmp_path / "svc.lock"
    # Missing lock: plain no-op.
    _unlink_lock_if_stale(lock)

    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    lock.write_text(str(proc.pid))

    real_rename = os.rename

    def stealing_rename(src, dst):
        # The concurrent reaper wins between our staleness check and our
        # rename: the lock vanishes out from under us.
        os.unlink(src)
        raise FileNotFoundError(src)

    monkeypatch.setattr(os, "rename", stealing_rename)
    _unlink_lock_if_stale(lock)  # must not raise
    monkeypatch.setattr(os, "rename", real_rename)
    assert not lock.exists()
    assert list(tmp_path.glob("*.stale*")) == []


def test_unlink_lock_restores_fresh_lock_grabbed_by_mistake(tmp_path, monkeypatch):
    """The full TOCTOU: the stale lock is reaped by a peer AND a new
    ensure_broker exclusive-creates a fresh lock before our rename — we
    grab the NEW holder's lock, must notice the pid changed, and put it
    back instead of deleting a live winner's lock."""
    from deeplearning_cfn_tpu_torch.cluster.broker_service import _unlink_lock_if_stale

    import subprocess
    import sys

    lock = tmp_path / "svc.lock"
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    lock.write_text(str(proc.pid))  # the stale lock we observe

    real_rename = os.rename

    def racing_rename(src, dst):
        # Between observation and rename the lock is replaced by a live
        # winner's (same path, new content); the rename takes the new one.
        Path(src).write_text(str(os.getpid()))
        real_rename(src, dst)

    monkeypatch.setattr(os, "rename", racing_rename)
    _unlink_lock_if_stale(lock)
    monkeypatch.setattr(os, "rename", real_rename)
    assert lock.exists(), "live winner's lock must be restored"
    assert lock.read_text() == str(os.getpid())
    assert list(tmp_path.glob("*.stale*")) == []


def test_unlink_lock_reaps_dead_holder_without_residue(tmp_path):
    from deeplearning_cfn_tpu_torch.cluster.broker_service import _unlink_lock_if_stale

    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    lock = tmp_path / "svc.lock"
    lock.write_text(str(proc.pid))
    _unlink_lock_if_stale(lock)
    assert not lock.exists()
    assert list(tmp_path.glob("*.stale*")) == []


def test_teardown_stale_record_does_not_kill_recycled_pid(tmp_path):
    """After a reboot the record can point at a recycled pid belonging to
    an unrelated process; teardown must verify the cmdline is actually
    dlcfn-broker before signalling."""
    rec = tmp_path / "broker" / "svc.json"
    rec.parent.mkdir(parents=True)
    rec.write_text(
        json.dumps(
            {"cluster": "svc", "host": "127.0.0.1", "port": 1,
             "pid": os.getpid()}  # a live pid that is NOT a broker
        )
    )
    out = teardown_broker("svc", root=tmp_path)
    assert out["broker"] == "stale-record"
    os.kill(os.getpid(), 0)  # we are demonstrably still alive
    assert broker_status("svc", root=tmp_path) is None


def test_teardown_without_record_is_noop(tmp_path):
    assert teardown_broker("none", root=tmp_path) == {"broker": "none"}


# --- warm standby / failover ------------------------------------------------


def test_standby_lifecycle_and_adoption(tmp_path):
    """The failover path end to end: ensure_standby_broker spawns the
    replica and publishes the endpoint list; when the primary dies,
    ensure_broker ADOPTS the live standby — promotion RPC, epoch bump,
    record rewrite — instead of spawning a fresh process."""
    import signal
    import time

    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        broker_replication_status,
        ensure_standby_broker,
        standby_broker_status,
    )

    _, port, _ = ensure_broker("svc", root=tmp_path)
    try:
        sb_host, sb_port, sb_started = ensure_standby_broker("svc", root=tmp_path)
        assert sb_started is True and sb_port != port
        assert standby_broker_status("svc", root=tmp_path)["alive"] is True
        # The standby record carries the operator-only bit and the shared
        # AUTH token (clients fail over without a second secret).
        sb_rec_file = tmp_path / "broker" / "svc.standby.json"
        assert (sb_rec_file.stat().st_mode & 0o777) == 0o600
        rec = json.loads((tmp_path / "broker" / "svc.json").read_text())
        assert rec["endpoints"] == [["127.0.0.1", port], [sb_host, sb_port]]
        repl = broker_replication_status("svc", root=tmp_path)
        assert repl["primary"]["role"] == "primary"
        assert repl["standby"]["role"] == "standby"

        os.kill(int(rec["pid"]), signal.SIGKILL)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if not broker_status("svc", root=tmp_path)["alive"]:
                break
            time.sleep(0.05)
        host2, port2, started2 = ensure_broker("svc", root=tmp_path)
        # Adoption, not a respawn: the standby's port, nothing started.
        assert (host2, port2, started2) == ("127.0.0.1", sb_port, False)
        rec2 = json.loads((tmp_path / "broker" / "svc.json").read_text())
        assert rec2["role"] == "primary"
        assert int(rec2["epoch"]) >= 1  # the promotion ladder bumped it
        # Self-healing: adoption re-provisioned a FRESH standby into the
        # vacated replica slot — a degraded pair is never steady state.
        sb2 = json.loads(sb_rec_file.read_text())
        assert int(sb2["port"]) != sb_port  # a new process, not the promotee
        assert rec2["endpoints"] == [
            ["127.0.0.1", sb_port], [sb2["host"], int(sb2["port"])]
        ]
        repl2 = broker_replication_status("svc", root=tmp_path)
        assert repl2["primary"]["role"] == "primary"
        assert repl2["primary"]["alive"] is True
        assert repl2["standby"] is not None
        assert repl2["standby"]["alive"] is True
        assert repl2["standby"]["role"] == "standby"
        assert repl2["lag_entries"] == 0
    finally:
        out = teardown_broker("svc", root=tmp_path)
    assert broker_status("svc", root=tmp_path) is None
    with pytest.raises(ProcessLookupError):
        os.kill(int(out["pid"]), 0)


def test_stale_standby_record_does_not_shadow_dead_primary(tmp_path):
    """Both records dead: ensure must discard the stale standby record
    and spawn fresh — never hand clients a standby address nothing
    listens on."""
    rec_dir = tmp_path / "broker"
    rec_dir.mkdir(parents=True)
    (rec_dir / "svc.json").write_text(
        json.dumps({"cluster": "svc", "host": "127.0.0.1", "port": 1, "pid": 1})
    )
    (rec_dir / "svc.standby.json").write_text(
        json.dumps(
            {"cluster": "svc", "host": "127.0.0.1", "port": 2, "pid": 1,
             "role": "standby", "epoch": 0}
        )
    )
    host, port, started = ensure_broker("svc", root=tmp_path)
    try:
        assert started is True
        assert port not in (1, 2)
        assert not (rec_dir / "svc.standby.json").exists()
        assert broker_status("svc", root=tmp_path)["alive"] is True
    finally:
        teardown_broker("svc", root=tmp_path)


def test_teardown_reaps_standby_and_replication_log(tmp_path):
    """delete's stack-resource contract covers the whole replicated pair:
    standby process, standby record, and the replication journal all go."""
    from deeplearning_cfn_tpu_torch.cluster.broker_service import ensure_standby_broker

    ensure_broker("svc", root=tmp_path)
    _, _, _ = ensure_standby_broker("svc", root=tmp_path)
    sb_pid = int(
        json.loads((tmp_path / "broker" / "svc.standby.json").read_text())["pid"]
    )
    out = teardown_broker("svc", root=tmp_path)
    assert out["broker"] == "stopped"
    assert out["standby"]["broker"] == "stopped"
    with pytest.raises(ProcessLookupError):
        os.kill(sb_pid, 0)
    assert not (tmp_path / "broker" / "svc.standby.json").exists()
    assert not (tmp_path / "broker" / "svc.repl.jsonl").exists()
    assert not (tmp_path / "broker" / "svc.standby.repl.jsonl").exists()


def test_advertise_address_is_recorded(tmp_path):
    host, port, _ = ensure_broker("adv", root=tmp_path, advertise="10.1.2.3")
    try:
        assert host == "10.1.2.3"
        rec = json.loads((tmp_path / "broker" / "adv.json").read_text())
        assert rec["host"] == "10.1.2.3"
        # Liveness probing must still work against the advertised address
        # being unroutable from here?  No: status probes the recorded host,
        # so an unroutable advertise reads as dead from THIS machine — the
        # operator host always advertises an address routable to itself in
        # practice (loopback or its own IP).  Probe via loopback instead.
        from deeplearning_cfn_tpu_torch.cluster.broker_service import _alive

        assert _alive("127.0.0.1", port)
    finally:
        teardown_broker("adv", root=tmp_path)


# --- sharded control plane ---------------------------------------------------


def test_sharded_broker_lifecycle_and_routing(tmp_path):
    """The sharded deployment end to end: ensure brings up N independent
    primary/standby pairs sharing one AUTH token, each fenced to its
    shard of the keyspace (SHARD verb); the router hashes keys to the
    owning pair; per-shard replication status reports no pair degraded;
    teardown reaps every shard and the map."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import (
        ShardedBrokerRouter,
        shard_for_key,
    )
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        broker_shard_replication_status,
        ensure_sharded_broker,
        sharded_broker_records,
        teardown_sharded_broker,
    )

    out = ensure_sharded_broker("svc", 2, root=tmp_path)
    try:
        assert out["n_shards"] == 2 and len(out["shards"]) == 2
        records = sharded_broker_records("svc", root=tmp_path)
        assert [e["shard"] for e in records] == [0, 1]
        tokens = set()
        for entry in records:
            rec = entry["record"]
            assert rec is not None and rec["alive"] is True
            assert rec["shard"] == entry["shard"] and rec["n_shards"] == 2
            assert len(rec["endpoints"]) == 2  # primary + warm standby
            tokens.add(rec["token"])
        assert len(tokens) == 1 and tokens != {None}  # one shared secret

        router = ShardedBrokerRouter.for_cluster("svc", root=tmp_path)
        try:
            assert router.ping() is True
            # Each shard's broker knows its slot in the ring.
            for k, conn in enumerate(router.shard_connections()):
                assert conn.shard() == (k, 2)
            # A queue lands on — and only on — the pair the hash names.
            queue = "work/route-check"
            owner = shard_for_key(queue, 2)
            assert router.shard_index(queue) == owner
            router.send_idempotent(queue, b"job", "r1")
            for k, conn in enumerate(router.shard_connections()):
                assert conn.depth(queue) == (1 if k == owner else 0)
        finally:
            router.close()

        # Replication is per shard: draining the owner's journal restores
        # zero lag everywhere (the other shard never had any).
        from deeplearning_cfn_tpu_torch.cluster.broker_service import (
            ReplicationStreamer,
        )

        shipped = ReplicationStreamer(
            f"svc.shard{owner}", root=tmp_path
        ).step()
        assert shipped == 1
        repl = broker_shard_replication_status("svc", root=tmp_path)
        assert repl["n_shards"] == 2 and repl["degraded_shards"] == 0
        for row in repl["shards"]:
            assert row["status"]["primary"]["alive"] is True
            assert row["status"]["standby"]["alive"] is True
    finally:
        down = teardown_sharded_broker("svc", root=tmp_path)
    assert {r["result"]["broker"] for r in down["shards"]} == {"stopped"}
    assert sharded_broker_records("svc", root=tmp_path) is None
    for k in range(2):
        assert broker_status(f"svc.shard{k}", root=tmp_path) is None


# --- the records held to the JAX package's -----------------------------------------


def _normalised(path: Path):
    """A record file with what differs between two spawns (pid, port,
    token, start time) replaced by placeholders; None when absent."""
    if not path.exists():
        return None
    rec = json.loads(path.read_text())
    ports = {}
    for key in ("pid", "started_ts"):
        if key in rec:
            rec[key] = f"<{key}>"
    if rec.get("token"):
        rec["token"] = "<token>"
    if "port" in rec:
        rec["port"] = ports.setdefault(rec["port"], f"<port{len(ports)}>")
    for ep in rec.get("endpoints") or []:
        ep[1] = ports.setdefault(ep[1], f"<port{len(ports)}>")
    return rec


def _records(root: Path) -> dict:
    return {p.name: _normalised(p) for p in sorted((root / "broker").glob("*.json"))}


def _scenario(side: str, name: str, root: Path, monkeypatch) -> list:
    """One ``name`` scenario through one side's service under ``root``;
    the JAX side runs the port's build of the broker, so the two differ
    only in the Python.  Returns the calls' results and the records after
    each step, normalised; every broker is torn down before returning."""
    svc = broker_service if side == "port" else jbroker_service
    if side == "jax":
        binary = broker_client.build_broker()
        monkeypatch.setattr(jbroker_service, "build_broker", lambda: binary)
        monkeypatch.setattr(jbroker_service, "BROKER_BIN", binary)
    out = []
    clusters = ["svc"]
    try:
        if name == "ensure-reuse":
            host, _, started = svc.ensure_broker("svc", root=root)
            out.append((host, started, _records(root)))
            host, _, started = svc.ensure_broker("svc", root=root, advertise="127.0.0.1")
            out.append((host, started, _records(root)))
        elif name == "advertise":
            svc.ensure_broker("svc", root=root, advertise="10.1.1.1")
            out.append(_records(root))
            host, _, started = svc.ensure_broker("svc", root=root, advertise="10.2.2.2")
            out.append((host, started, _records(root)))
        elif name == "standby":
            svc.ensure_broker("svc", root=root)
            host, _, started = svc.ensure_standby_broker("svc", root=root)
            out.append((host, started, _records(root)))
            status = svc.broker_replication_status("svc", root=root)
            out.append({node: {k: v for k, v in (status[node] or {}).items()
                               if k in ("alive", "role", "epoch", "host")}
                        for node in ("primary", "standby")})
        elif name == "sharded":
            clusters = ["svc.shard0", "svc.shard1"]
            res = svc.ensure_sharded_broker("svc", 2, root=root, standby=False)
            out.append([(s["shard"], s["cluster"], s["host"], s["started"])
                        for s in res["shards"]])
            out.append(_records(root))
            down = svc.teardown_sharded_broker("svc", root=root)
            out.append([(r["shard"], r["cluster"], r["result"]["broker"])
                        for r in down["shards"]])
        for cluster in clusters:
            result = svc.teardown_broker(cluster, root=root)
            for r in (result, result.get("standby") or {}):
                r.pop("pid", None)
                r.pop("port", None)
            out.append(result)
        out.append(_records(root))
    finally:
        for cluster in clusters:
            svc.teardown_broker(cluster, root=root)
    return out


@pytest.mark.skipif(jbroker_service is None, reason="needs the JAX package")
@pytest.mark.parametrize("name", ["ensure-reuse", "advertise", "standby", "sharded"])
def test_records_equal_jax(name, tmp_path, monkeypatch):
    port = _scenario("port", name, tmp_path / "port", monkeypatch)
    assert port == _scenario("jax", name, tmp_path / "jax", monkeypatch)
    assert port[-1] == {}  # every record gone after the teardown


@pytest.mark.skipif(jbroker_service is None, reason="needs the JAX package")
def test_liveness_and_token_views_equal_jax(tmp_path, monkeypatch):
    """``broker_token``, ``cluster_liveness`` and a watcher's poll over the
    same broker table (the JAX side reads the port's record)."""
    from deeplearning_cfn_tpu.obs import liveness as jliveness

    from deeplearning_cfn_tpu_torch.obs import liveness

    ensure_broker("svc", root=tmp_path)
    try:
        token = broker_service.broker_token("svc", root=tmp_path)
        assert token == jbroker_service.broker_token("svc", root=tmp_path)
        conn = broker_client.BrokerConnection("127.0.0.1", broker_status(
            "svc", root=tmp_path)["port"], token=token)
        try:
            for w in ("g/0", "g/1", "g/0"):
                conn.heartbeat(w)
        finally:
            conn.close()
        cfg, jcfg = liveness.LivenessConfig(), jliveness.LivenessConfig()
        views = [broker_service.cluster_liveness("svc", root=tmp_path, config=cfg),
                 jbroker_service.cluster_liveness("svc", root=tmp_path, config=jcfg)]
        for view in views:
            for row in view.values():
                row["age_s"] = round(row["age_s"])  # read a moment apart
        assert views[0] == views[1]
        assert {w: r["beats"] for w, r in views[0].items()} == {"g/0": 2, "g/1": 1}
    finally:
        out = teardown_broker("svc", root=tmp_path)
    with pytest.raises(ProcessLookupError):
        os.kill(int(out["pid"]), 0)
