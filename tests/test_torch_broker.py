"""The port's broker client against the native broker, on the CPU.

The cases of ``tests/test_broker.py`` run on the port's client
(``deeplearning_cfn_tpu_torch.cluster.broker_client``) and the port's build
of the unmodified ``native/broker/broker.cpp`` (``build/torch_native/``):
the broker queue honours the in-memory queue's contract, the provisioning
choreography runs over it unchanged, AUTH gates every state verb, and
garbage on the wire closes only its own connection.  Then the port is held
to the JAX package's client: byte-equal request lines for every verb (a
recording proxy in front of a broker), each client reading what the other
wrote on one broker, and ``shard_for_key``, ``serialize_group`` and the
telemetry snapshot bytes equal.  The build: several processes at once into
one empty directory build one binary; a compiler failure raises
``BrokerError``; ``native/broker/dlcfn-broker`` is never read or written.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import pytest

from deeplearning_cfn_tpu_torch.cluster import broker_client
from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerProcess

try:
    from deeplearning_cfn_tpu.cluster import broker_backend as jbroker_backend
    from deeplearning_cfn_tpu.cluster import broker_client as jbroker_client
    from deeplearning_cfn_tpu.obs import aggregator as jaggregator
    from deeplearning_cfn_tpu.provision import backend as jbackend
except ImportError:  # the card's host has no JAX package to compare with
    jbroker_client = None

needs_jax = pytest.mark.skipif(jbroker_client is None, reason="needs the JAX package")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="native toolchain unavailable",
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_ambient_token(monkeypatch):
    # BrokerConnection reads $DLCFN_BROKER_TOKEN when no token is passed.
    monkeypatch.delenv("DLCFN_BROKER_TOKEN", raising=False)


@pytest.fixture(scope="module")
def broker():
    with BrokerProcess() as b:
        yield b


def test_send_receive_delete(broker):
    q = broker.queue("t1")
    q.send({"a": 1})
    msgs = q.receive(max_messages=10, visibility_timeout_s=60)
    assert len(msgs) == 1 and msgs[0].body == {"a": 1}
    q.delete(msgs[0].receipt)
    assert q.approximate_depth() == 0


def test_visibility_timeout_redelivery(broker):
    q = broker.queue("t2")
    q.send({"x": "y"})
    first = q.receive(visibility_timeout_s=0.2)
    assert len(first) == 1
    assert q.receive(visibility_timeout_s=0.2) == []
    time.sleep(0.3)
    again = q.receive(visibility_timeout_s=60)
    assert len(again) == 1
    assert again[0].receive_count == 2
    q.purge()


def test_broadcast_trick(broker):
    q = broker.queue("t3")
    q.send({"event": "worker-setup"})
    for _ in range(8):
        msgs = q.receive(max_messages=1, visibility_timeout_s=0)
        assert len(msgs) == 1 and msgs[0].body["event"] == "worker-setup"
    assert q.approximate_depth() == 1
    q.purge()


def test_fifo_and_batch(broker):
    q = broker.queue("t4")
    for i in range(15):
        q.send({"i": i})
    batch = q.receive(max_messages=10, visibility_timeout_s=60)
    assert [m.body["i"] for m in batch] == list(range(10))
    q.purge()


def test_delete_unknown_receipt_noop(broker):
    q = broker.queue("t5")
    q.send({"a": 1})
    q.delete("r-bogus")
    assert q.approximate_depth() == 1
    q.purge()


def test_full_choreography_over_broker(broker, contract_root):
    # The entire provision -> discover -> contract flow with the native
    # broker as transport; compute plane stays fake.
    from deeplearning_cfn_tpu_torch.config.schema import ClusterSpec, JobSpec, NodePool, StorageSpec
    from deeplearning_cfn_tpu_torch.provision.local import LocalBackend
    from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner

    spec = ClusterSpec(
        name="over-broker",
        pool=NodePool(accelerator_type="local-1", workers=4),
        storage=StorageSpec(kind="local"),
        job=JobSpec(global_batch_size=32),
    )
    backend = LocalBackend(queue_factory=broker.queue)
    # Real clock: poll loops must find messages immediately (no 30 s stalls)
    # because the controller posts before bootstrap starts.
    spec.timeouts.poll_interval_s = 0.05
    result = Provisioner(backend, spec, contract_root=contract_root).provision()
    assert result.contract.workers_count == 4
    assert not result.degraded


def test_large_payload(broker):
    q = broker.queue("t6")
    big = {"blob": "x" * 1_000_000}
    q.send(big)
    msgs = q.receive(max_messages=1, visibility_timeout_s=60)
    assert msgs[0].body == big
    q.delete(msgs[0].receipt)


def test_kv_set_get(broker):
    """The shared-KV surface carrying signals + group-state snapshots."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

    conn = BrokerConnection("127.0.0.1", broker.port)
    assert conn.get("signal:nope") is None
    conn.set("signal:cluster-ready:t", b"SUCCESS")
    assert conn.get("signal:cluster-ready:t") == b"SUCCESS"
    conn.set("signal:cluster-ready:t", b"FAILURE")  # overwrite wins
    assert conn.get("signal:cluster-ready:t") == b"FAILURE"
    payload = ("{" + '"k":"' + "y" * 100_000 + '"}').encode()
    conn.set("group-state:big", payload)
    assert conn.get("group-state:big") == payload
    conn.close()


def test_agent_backend_group_roundtrip(broker):
    """WorkerGroup snapshots survive the publish/read path agents use."""
    from deeplearning_cfn_tpu_torch.cluster.broker_backend import (
        BrokerAgentBackend,
        GROUP_STATE_KEY_FMT,
        serialize_group,
    )
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection
    from deeplearning_cfn_tpu_torch.provision.backend import (
        Instance,
        InstanceState,
        ResourceSignal,
        WorkerGroup,
    )

    group = WorkerGroup(
        name="rt-workers", desired=2, minimum=1, chips_per_worker=4,
        replace_unhealthy_suspended=True,
        instances=[
            Instance("i-1", "rt-workers", 0, InstanceState.RUNNING, "10.0.0.2", True, 4),
            Instance("i-2", "rt-workers", 1, InstanceState.PENDING, None, True, 4),
        ],
    )
    conn = BrokerConnection("127.0.0.1", broker.port)
    conn.set(GROUP_STATE_KEY_FMT.format(name="rt-workers"), serialize_group(group))
    conn.close()

    agent = BrokerAgentBackend("127.0.0.1", broker.port)
    seen = agent.describe_group("rt-workers")
    assert seen == group
    # Unpublished group -> unsatisfiable placeholder, not a crash.
    placeholder = agent.describe_group("ghost")
    assert placeholder.instances == [] and placeholder.desired == 1
    agent.signal_resource("group:rt-workers", ResourceSignal.SUCCESS)
    assert agent.get_resource_signal("group:rt-workers") is ResourceSignal.SUCCESS
    agent.close()


def test_reset_cluster_state_scrubs_previous_generation(broker):
    """recover() against a live broker must not read the previous
    cluster's SUCCESS signal or worker-setup broadcast (stale-state bug)."""
    from deeplearning_cfn_tpu_torch.cluster.bootstrap import cluster_ready_resource
    from deeplearning_cfn_tpu_torch.cluster.broker_backend import BrokerRendezvousBackend
    from deeplearning_cfn_tpu_torch.provision.backend import ResourceSignal
    from deeplearning_cfn_tpu_torch.provision.local import LocalBackend

    be = BrokerRendezvousBackend(LocalBackend(), "127.0.0.1", broker.port)
    ready = cluster_ready_resource("gen")
    be.signal_resource(ready, ResourceSignal.SUCCESS)
    be.signal_resource("group:gen-workers", ResourceSignal.FAILURE)
    be.get_queue("gen-worker-queue").send({"event": "worker-setup", "stale": True})

    be.reset_cluster_state("gen", ["gen-workers"], ["gen-worker-queue"])

    # Broker side is scrubbed (inner LocalBackend memory is irrelevant to
    # agents; a fresh controller process starts with an empty inner store).
    fresh = BrokerRendezvousBackend(LocalBackend(), "127.0.0.1", broker.port)
    assert fresh.get_resource_signal(ready) is None
    assert fresh.get_resource_signal("group:gen-workers") is None
    assert fresh.get_queue("gen-worker-queue").receive(visibility_timeout_s=0.0) == []


def test_concurrent_clients_stress(broker):
    """20 threads x (KV set/get + queue send/receive/delete) against one
    broker: no lost messages, no cross-talk, no torn values — the C++
    broker serves every agent of a large cluster concurrently."""
    import json
    import threading

    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

    N, PER = 20, 25
    errors: list[str] = []

    def worker(i: int) -> None:
        try:
            c = BrokerConnection("127.0.0.1", broker.port)
            q = broker.queue(f"stress-{i}")  # private queue per thread
            for j in range(PER):
                payload = {"thread": i, "seq": j, "blob": "x" * 200}
                q.send(payload)
                c.set(f"stress-key-{i}", json.dumps(payload).encode())
            got = []
            while len(got) < PER:
                msgs = q.receive(max_messages=10, visibility_timeout_s=60)
                for m in msgs:
                    got.append(m.body)
                    q.delete(m.receipt)
            assert len(got) == PER
            assert {g["seq"] for g in got} == set(range(PER))
            assert all(g["thread"] == i for g in got)
            raw = c.get(f"stress-key-{i}")
            assert raw is not None
            last = json.loads(raw.decode())
            assert last["thread"] == i and last["seq"] == PER - 1
            c.close()
        except Exception as e:  # surface in the main thread
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # A hung worker (e.g. a lost message spinning the receive loop) must
    # fail the test, not silently time out of join().
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    assert not errors, errors


def test_auth_gates_every_state_verb():
    """A token-spawned broker is the IAM-gated control plane analog
    (deeplearning.template:193-197): PING stays open for liveness, but
    registering (SEND), polling (RECV), and rendezvous reads/writes
    (GET/SET) all require the AUTH handshake — a wrong or missing token
    is rejected and the connection closed."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import (
        BrokerConnection,
        BrokerError,
    )

    with BrokerProcess(token="s3cret-tok") as b:
        # Liveness is checkable without credentials.
        bare = BrokerConnection("127.0.0.1", b.port, token="")
        assert bare.ping()
        # ...but no state verb works: rejected, connection closed.
        with pytest.raises(BrokerError):
            bare.send("q", b"register-me")
        bare2 = BrokerConnection("127.0.0.1", b.port, token="")
        with pytest.raises(BrokerError):
            bare2.receive("q", 10, 0)
        bare3 = BrokerConnection("127.0.0.1", b.port, token="")
        with pytest.raises(BrokerError):
            bare3.get("signal:cluster-ready:x")
        # A wrong token fails the handshake itself.
        with pytest.raises(BrokerError, match="AUTH rejected"):
            BrokerConnection("127.0.0.1", b.port, token="wrong-tok")
        # The right token unlocks the full protocol.
        q = b.queue("authq")
        q.send({"event": "ready"})
        msgs = q.receive(max_messages=1, visibility_timeout_s=60)
        assert msgs[0].body == {"event": "ready"}
        good = BrokerConnection("127.0.0.1", b.port, token="s3cret-tok")
        good.set("signal:x", b"SUCCESS")
        assert good.get("signal:x") == b"SUCCESS"
        good.close()


def test_open_broker_accepts_token_bearing_clients():
    """Back-compat: clients carrying an ambient token must still talk to
    an open (dev/test) broker — AUTH is accepted as a no-op."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

    with BrokerProcess() as b:
        conn = BrokerConnection("127.0.0.1", b.port, token="whatever")
        conn.set("k", b"v")
        assert conn.get("k") == b"v"
        conn.close()


def test_broker_survives_malformed_wire_input(broker):
    """A network service on the cluster's control path must not crash or
    wedge on garbage: binary junk, oversized headers, truncated SEND
    bodies, and nonsense verbs each at worst close THAT connection —
    liveness and the queue contract keep working for everyone else."""
    import os
    import socket

    def raw_conn():
        s = socket.create_connection(("127.0.0.1", broker.port), timeout=5)
        s.settimeout(5)
        return s

    # 1. Pure binary garbage (includes newlines -> parsed as junk verbs).
    s = raw_conn()
    s.sendall(os.urandom(4096))
    s.close()
    # 2. An unbounded header: the 64 KiB line sanity bound must cut it off.
    s = raw_conn()
    try:
        s.sendall(b"A" * (1 << 17))
        s.close()
    except (BrokenPipeError, ConnectionResetError):
        pass  # server already dropped us mid-send: the bound worked
    # 3. A SEND that promises a body and never delivers (truncated).
    s = raw_conn()
    s.sendall(b"SEND q 1048576\ntiny")
    s.close()
    # 4. Negative / non-numeric argument fields.
    for line in (b"RECV q -5 -9999\n", b"SEND q notanumber\n", b"RECV\n"):
        s = raw_conn()
        s.sendall(line)
        try:
            s.recv(256)
        except (TimeoutError, ConnectionResetError, OSError):
            pass
        s.close()

    # The broker is alive and the contract still holds for real clients.
    q = broker.queue("post-fuzz")
    q.send({"still": "working"})
    msgs = q.receive(max_messages=1, visibility_timeout_s=60)
    assert msgs[0].body == {"still": "working"}
    q.delete(msgs[0].receipt)


# --- the port held to the JAX package's client --------------------------------


class _RecordingProxy:
    """A TCP proxy in front of a broker that records every byte its one
    client sends, so two clients' request streams can be compared."""

    def __init__(self, port: int):
        self.upstream = port
        self.sent = bytearray()
        self.server = socket.create_server(("127.0.0.1", 0))
        self.port = self.server.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        client, _ = self.server.accept()
        up = socket.create_connection(("127.0.0.1", self.upstream))

        def pump(src, dst, record):
            try:
                while True:
                    chunk = src.recv(65536)
                    if not chunk:
                        break
                    if record:
                        self.sent += chunk
                    dst.sendall(chunk)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        back = threading.Thread(target=pump, args=(up, client, False), daemon=True)
        back.start()
        pump(client, up, True)
        back.join(timeout=5)
        client.close()
        up.close()

    def close(self) -> None:
        self.thread.join(timeout=5)
        self.server.close()


def _every_verb(conn_cls, port: int, token: str) -> list:
    """Every verb of the line protocol once, through ``conn_cls``; returns
    the answers (equal between the clients on equal fresh brokers)."""
    conn = conn_cls("127.0.0.1", port, timeout_s=5.0, token=token)
    try:
        out = [conn.ping(), conn.send("q", b"hello\nworld"), conn.depth("q")]
        msgs = conn.receive("q", 5, 60_000)
        out.append([(m[0], m[1], m[2], m[3]) for m in msgs])
        out.append(conn.delete("q", msgs[0][1]))
        out.append(conn.delete("q", "r-bogus"))
        conn.set("k", b"v 1\n")
        out += [conn.get("k"), conn.get("missing"), conn.unset("k"), conn.unset("k")]
        out += [conn.heartbeat("g/0"), sorted(conn.heartbeats())]
        out += [conn.telem("g/0", b'{"v":1}'), [(w, c, p) for w, (_, c, p) in
                                                 sorted(conn.telemetry().items())]]
        out += [conn.send_idempotent("q", b"x", "rid-1"), conn.send_idempotent("q", b"x", "rid-1")]
        conn.purge("q")
        out += [conn.role(), conn.shard()]
        out.append(conn.promote(3))
        return out
    finally:
        conn.close()


@needs_jax
def test_request_lines_are_byte_equal_to_jax_for_every_verb():
    """Each client against a fresh AUTH broker behind a recording proxy:
    the bytes on the wire, AUTH first, are the same, and so are the
    answers."""
    streams, answers = [], []
    for conn_cls in (broker_client.BrokerConnection, jbroker_client.BrokerConnection):
        with BrokerProcess(token="tok-1") as b:
            proxy = _RecordingProxy(b.port)
            answers.append(_every_verb(conn_cls, proxy.port, "tok-1"))
            proxy.close()
            streams.append(bytes(proxy.sent))
    assert streams[0] == streams[1]
    assert streams[0].startswith(b"AUTH tok-1\nPING\nSEND q 11\nhello\nworld")
    assert answers[0] == answers[1]


@needs_jax
def test_each_client_reads_what_the_other_wrote(broker):
    port_q = broker_client.BrokerQueue("xq", "127.0.0.1", broker.port)
    jax_q = jbroker_client.BrokerQueue("xq", "127.0.0.1", broker.port)
    try:
        port_q.send({"from": "port", "i": 1})
        got = jax_q.receive(max_messages=1, visibility_timeout_s=60)
        assert got[0].body == {"from": "port", "i": 1}
        jax_q.delete(got[0].receipt)
        jax_q.send({"from": "jax", "i": 2})
        got = port_q.receive(max_messages=1, visibility_timeout_s=60)
        assert got[0].body == {"from": "jax", "i": 2}
        port_q.delete(got[0].receipt)
        assert jax_q.approximate_depth() == 0
    finally:
        port_q.close()
        jax_q.close()
    pc = broker_client.BrokerConnection("127.0.0.1", broker.port)
    jc = jbroker_client.BrokerConnection("127.0.0.1", broker.port)
    try:
        jc.set("signal:x", b"SUCCESS")
        assert pc.get("signal:x") == b"SUCCESS"
        pc.telem("xw/0", b'{"gauges":{}}')
        assert jc.telemetry()["xw/0"][1:] == (1, b'{"gauges":{}}')
        jc.heartbeat("xw/1")
        assert pc.heartbeats()["xw/1"][1] == 1
    finally:
        pc.close()
        jc.close()


@needs_jax
@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 16])
def test_shard_for_key_equals_jax(n_shards):
    keys = [f"work/{i}" for i in range(200)] + ["", "signal:cluster-ready:x", "g/0", "ü-key"]
    port = [broker_client.shard_for_key(k, n_shards) for k in keys]
    assert port == [jbroker_client.shard_for_key(k, n_shards) for k in keys]
    assert port == [zlib.crc32(k.encode()) % n_shards for k in keys]
    with pytest.raises(ValueError):
        broker_client.shard_for_key("k", 0)


def _group(backend_mod, instances: int):
    states = list(backend_mod.InstanceState)
    return backend_mod.WorkerGroup(
        name="g-workers", desired=instances, minimum=1, chips_per_worker=4,
        replace_unhealthy_suspended=bool(instances % 2),
        instances=[
            backend_mod.Instance(f"i-{i}", "g-workers", i, states[i % len(states)],
                                 None if i % 3 == 2 else f"10.0.0.{i + 2}", i % 4 != 3, 4)
            for i in range(instances)
        ],
    )


@needs_jax
@pytest.mark.parametrize("instances", [0, 1, 5])
def test_serialize_group_bytes_equal_jax(instances):
    from deeplearning_cfn_tpu_torch.cluster import broker_backend
    from deeplearning_cfn_tpu_torch.provision import backend

    raw = broker_backend.serialize_group(_group(backend, instances))
    assert raw == jbroker_backend.serialize_group(_group(jbackend, instances))
    assert broker_backend.deserialize_group(raw) == _group(backend, instances)
    assert broker_backend.serialize_group(broker_backend.deserialize_group(raw)) == raw


@needs_jax
@pytest.mark.parametrize("case", ["plain", "non-finite", "long-summary", "numpy"])
def test_snapshot_bytes_equal_jax(case):
    import numpy as np

    from deeplearning_cfn_tpu_torch.obs import aggregator

    gauges = {"dlcfn_mesh_workers": 1.0, "dlcfn_serve_queue_depth": 3}
    summaries = {"dlcfn_step_ms": [1.5, 2.5]}
    if case == "non-finite":
        gauges["b"] = float("nan")
        summaries["dlcfn_step_ms"] = [float("inf"), 1.0]
    elif case == "long-summary":
        summaries["dlcfn_step_ms"] = [float(i) for i in range(200)]
    elif case == "numpy":
        gauges["n"] = np.float32(0.25)
        summaries["dlcfn_step_ms"] = [np.float64(2.0)]
    port = aggregator.encode_snapshot(aggregator.agent_snapshot(gauges, summaries))
    assert port == jaggregator.encode_snapshot(jaggregator.agent_snapshot(gauges, summaries))
    json.loads(port)  # strict JSON, always


# --- the build --------------------------------------------------------------------


def test_parallel_builds_into_an_empty_dir_make_one_binary(tmp_path):
    """Several processes (xdist workers, agents) building at once: the lock
    and the rename leave one binary, and no temporary file."""
    jax_bin = REPO / "native" / "broker" / "dlcfn-broker"
    before = jax_bin.stat().st_mtime_ns if jax_bin.exists() else None
    code = ("import sys; from pathlib import Path; "
            "from deeplearning_cfn_tpu_torch.cluster.broker_client import build_broker; "
            "print(build_broker(build_dir=Path(sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")],
                              cwd=REPO, stdout=subprocess.PIPE, text=True) for _ in range(3)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(outs) == 1
    built = Path(outs.pop())
    assert built == broker_client.broker_binary_path(tmp_path / "b")
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["build.lock", built.name]
    assert "dlcfn-broker" in built.name and os.access(built, os.X_OK)
    # The JAX package's binary is neither built nor touched.
    after = jax_bin.stat().st_mtime_ns if jax_bin.exists() else None
    assert after == before
    assert broker_client.build_broker() != jax_bin


def test_a_compiler_failure_raises_broker_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(broker_client.BrokerError, match="building the broker failed"):
        broker_client.build_broker(build_dir=tmp_path)
    assert [p.name for p in tmp_path.iterdir()] == ["build.lock"]
