"""Client for the native rendezvous broker (native/broker/broker.cpp).

Counterpart of ``deeplearning_cfn_tpu/cluster/broker_client.py``, copied
(the port imports nothing of the JAX package); the wire protocol is the
same byte for byte.  ``BrokerQueue`` implements the same
:class:`RendezvousQueue` interface as the in-memory queue, over the broker's
TCP line protocol — so the provisioner, bootstrap agents, and elasticity
controller run unchanged against the production transport.

The broker binary is the port's own build of the unmodified C++ source:
:func:`build_broker` compiles it with ``native/broker/Makefile``'s flags into
``build/torch_native/dlcfn-broker-<hash>`` (named by a hash of the source and
the flags) at first use, under a file lock, writing a temporary file and
moving it into place — processes that start together build it once.  It
never runs ``make`` in ``native/broker/`` and never reads or writes the
``dlcfn-broker`` that the JAX package builds there.  ``BrokerProcess``
spawns and supervises a local broker instance; on a deployment the broker
runs on the controller host and workers dial the address stamped into
their metadata.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import socket
import subprocess
import uuid
import zlib
from pathlib import Path
from typing import Any

from deeplearning_cfn_tpu_torch.cluster.queue import Message, RendezvousQueue
from deeplearning_cfn_tpu_torch.obs.tracing import span
from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.resilience import (
    CircuitBreaker,
    RetryExhausted,
    RetryPolicy,
)
from deeplearning_cfn_tpu_torch.utils.timeouts import (
    BudgetExhausted,
    Clock,
    MonotonicClock,
    TimeoutBudget,
)

log = get_logger("dlcfn.broker")


def _traced(method):
    """Wrap an RPC method in a ``rpc.<name>`` span (obs flight journal)."""
    import functools

    span_name = f"rpc.{method.__name__}"

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with span(span_name):
            return method(self, *args, **kwargs)

    return wrapper


_ROOT = Path(__file__).resolve().parents[2]
BROKER_SRC = _ROOT / "native" / "broker" / "broker.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
# native/broker/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-pthread",)


def shard_for_key(key: str, n_shards: int) -> int:
    """The broker keyspace hash ring: which shard owns ``key``.

    CRC32 rather than Python's ``hash()`` — the ring must be stable
    across processes, restarts, and languages (PYTHONHASHSEED randomizes
    ``hash()`` per interpreter), because the router, the sim fleet, and
    any future C++ client must all agree on placement.  Queues, KV keys,
    and heartbeat worker ids all route through this one function."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    return zlib.crc32(key.encode("utf-8")) % n_shards


class BrokerError(RuntimeError):
    pass


class BrokerFenced(BrokerError):
    """A replication write was rejected by epoch fencing: the sender is a
    deposed primary and must stop streaming (docs/RESILIENCE.md)."""

    def __init__(self, epoch: int, seq: int):
        super().__init__(
            f"replication fenced: epoch {epoch} is stale (entry seq {seq})"
        )
        self.epoch = epoch
        self.seq = seq


class BrokerTimeout(BrokerError, TimeoutError):
    """The broker did not become reachable within the readiness budget."""

    def __init__(self, timeout_s: float, last: BaseException | None = None):
        super().__init__(
            f"broker did not become reachable within {timeout_s:.1f}s"
            + (f" (last error: {last})" if last is not None else "")
        )
        self.timeout_s = timeout_s
        self.last = last


def await_broker_ready(
    probe,
    timeout_s: float = 5.0,
    clock: Clock | None = None,
    poll_interval_s: float = 0.05,
) -> None:
    """Poll ``probe()`` until it stops raising OSError, bounded by a
    monotonic deadline.

    The unified-policy port of the old bare ``time.sleep(0.05)`` loop:
    attempts draw from one :class:`TimeoutBudget` on an injectable clock,
    and exhaustion raises the typed :class:`BrokerTimeout` instead of a
    generic error (callers can distinguish "never came up" from protocol
    failures).
    """
    clock = clock or MonotonicClock()
    policy = RetryPolicy(
        # The budget is the real bound; size the attempt ceiling so the
        # policy can never give up before the deadline does.
        max_attempts=max(2, int(timeout_s / max(poll_interval_s, 1e-6)) + 1),
        base_s=poll_interval_s,
        cap_s=max(poll_interval_s * 5, poll_interval_s),
        clock=clock,
        seed=0,
        retryable=(OSError,),
    )
    budget = TimeoutBudget(timeout_s, clock=clock)
    try:
        policy.call(probe, budget=budget, phase="broker-ready")
    except (BudgetExhausted, RetryExhausted) as err:
        last = getattr(err, "last", None) or err
        raise BrokerTimeout(timeout_s, last) from err


class BrokerConnection:
    """One TCP connection speaking the broker line protocol.

    ``token``: shared-secret for the AUTH handshake (the IAM-gating
    analog of the reference's SQS control plane,
    deeplearning.template:193-197).  Defaults to $DLCFN_BROKER_TOKEN —
    the ambient channel the cluster contract stamps on VMs — so every
    existing construction site authenticates without plumbing changes.
    Pass an explicit token to override (controller-side callers read it
    from the broker record)."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 10.0,
        token: str | None = None,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        if token is None:
            token = os.environ.get("DLCFN_BROKER_TOKEN") or None
        if token:
            # A failed handshake must not leak the connected socket: an
            # agent's bootstrap retry loop would otherwise accumulate one
            # fd per attempt until EMFILE masks the real auth failure.
            try:
                if any(c.isspace() for c in token):
                    raise BrokerError(
                        "broker token must not contain whitespace"
                    )
                self.sock.sendall(f"AUTH {token}\n".encode())
                resp = self._read_line()
                if resp != "OK":
                    raise BrokerError(f"broker AUTH rejected: {resp}")
            except BaseException:
                self.close()
                raise

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_line(self) -> str:
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise BrokerError("broker closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line.decode()

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise BrokerError("broker closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    @_traced
    def ping(self) -> bool:
        self.sock.sendall(b"PING\n")
        return self._read_line() == "PONG"

    @_traced
    def send(self, queue: str, body: bytes) -> str:
        self.sock.sendall(f"SEND {queue} {len(body)}\n".encode() + body)
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"SEND failed: {resp}")
        return resp[3:]

    @_traced
    def receive(self, queue: str, max_messages: int, visibility_ms: int) -> list[tuple[str, str, int, bytes]]:
        self.sock.sendall(f"RECV {queue} {max_messages} {visibility_ms}\n".encode())
        header = self._read_line()
        if not header.startswith("N "):
            raise BrokerError(f"RECV failed: {header}")
        out = []
        for _ in range(int(header[2:])):
            mline = self._read_line().split(" ")
            if mline[0] != "MSG":
                raise BrokerError(f"bad MSG frame: {mline}")
            _, mid, receipt, count, length = mline
            out.append((mid, receipt, int(count), self._read_exact(int(length))))
        return out

    @_traced
    def delete(self, queue: str, receipt: str) -> bool:
        self.sock.sendall(f"DEL {queue} {receipt}\n".encode())
        resp = self._read_line()
        if resp == "OK":
            return True
        if resp == "MISS":
            return False
        # A standby's "ERR not primary" must surface as an error the
        # failover wrapper can classify, not as a silent MISS.
        raise BrokerError(f"DEL failed: {resp}")

    @_traced
    def depth(self, queue: str) -> int:
        self.sock.sendall(f"DEPTH {queue}\n".encode())
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"DEPTH failed: {resp}")
        return int(resp[3:])

    @_traced
    def purge(self, queue: str) -> None:
        self.sock.sendall(f"PURGE {queue}\n".encode())
        resp = self._read_line()
        if resp != "OK":
            raise BrokerError(f"PURGE failed: {resp}")

    # --- shared KV (signals + group-state snapshots) ---------------------
    @_traced
    def set(self, key: str, value: bytes) -> None:
        self.sock.sendall(f"SET {key} {len(value)}\n".encode() + value)
        resp = self._read_line()
        if resp != "OK":
            raise BrokerError(f"SET failed: {resp}")

    @_traced
    def get(self, key: str) -> bytes | None:
        self.sock.sendall(f"GET {key}\n".encode())
        resp = self._read_line()
        if resp == "NONE":
            return None
        if not resp.startswith("VAL "):
            raise BrokerError(f"GET failed: {resp}")
        return self._read_exact(int(resp[4:]))

    @_traced
    def unset(self, key: str) -> bool:
        self.sock.sendall(f"UNSET {key}\n".encode())
        resp = self._read_line()
        if resp == "OK":
            return True
        if resp == "MISS":
            return False
        raise BrokerError(f"UNSET failed: {resp}")

    # --- liveness (obs plane) --------------------------------------------
    @_traced
    def heartbeat(self, worker_id: str) -> int:
        """Record a beat for ``worker_id``; returns its beat count."""
        if not worker_id or any(c.isspace() for c in worker_id):
            raise BrokerError(f"bad heartbeat worker id: {worker_id!r}")
        self.sock.sendall(f"HEARTBEAT {worker_id}\n".encode())
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"HEARTBEAT failed: {resp}")
        return int(resp[3:])

    @_traced
    def heartbeats(self) -> dict[str, tuple[float, int]]:
        """Dump the broker's beat table: worker -> (age_s, beat count)."""
        self.sock.sendall(b"HEARTBEAT\n")
        header = self._read_line()
        if not header.startswith("N "):
            raise BrokerError(f"HEARTBEAT dump failed: {header}")
        out: dict[str, tuple[float, int]] = {}
        for _ in range(int(header[2:])):
            hline = self._read_line().split(" ")
            if hline[0] != "HB" or len(hline) != 4:
                raise BrokerError(f"bad HB frame: {hline}")
            _, worker, age_ms, count = hline
            out[worker] = (int(age_ms) / 1000.0, int(count))
        return out

    # --- fleet telemetry (obs plane) --------------------------------------
    @_traced
    def telem(self, worker_id: str, snapshot: bytes) -> int:
        """Record ``worker_id``'s latest telemetry snapshot (last-write-
        wins, like a beat with a payload); returns its snapshot count."""
        if not worker_id or any(c.isspace() for c in worker_id):
            raise BrokerError(f"bad telemetry worker id: {worker_id!r}")
        self.sock.sendall(
            f"TELEM {worker_id} {len(snapshot)}\n".encode() + snapshot
        )
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"TELEM failed: {resp}")
        return int(resp[3:])

    @_traced
    def telemetry(self) -> dict[str, tuple[float, int, bytes]]:
        """Dump the broker's telemetry table: worker ->
        (age_s, snapshot count, latest snapshot bytes)."""
        self.sock.sendall(b"TELEM\n")
        header = self._read_line()
        if not header.startswith("N "):
            raise BrokerError(f"TELEM dump failed: {header}")
        out: dict[str, tuple[float, int, bytes]] = {}
        for _ in range(int(header[2:])):
            tline = self._read_line().split(" ")
            if tline[0] != "TM" or len(tline) != 5:
                raise BrokerError(f"bad TM frame: {tline}")
            _, worker, age_ms, count, length = tline
            payload = self._read_exact(int(length))
            out[worker] = (int(age_ms) / 1000.0, int(count), payload)
        return out

    # --- replication / leader handover (docs/RESILIENCE.md) --------------
    @_traced
    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        """Enqueue with an idempotency key: re-sending the same ``rid``
        (the at-least-once re-send after a failover) enqueues at most
        once — the rid doubles as the message id."""
        if not rid or any(c.isspace() for c in rid):
            raise BrokerError(f"bad idempotency key: {rid!r}")
        self.sock.sendall(f"SENDID {queue} {rid} {len(body)}\n".encode() + body)
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"SENDID failed: {resp}")
        return resp[3:]

    @_traced
    def role(self) -> tuple[str, int, int]:
        """The peer's (role, epoch, replication position).  Position is
        entries journaled for a primary, entries applied for a standby —
        primary minus standby is the replication lag in entries."""
        self.sock.sendall(b"ROLE\n")
        rline = self._read_line().split(" ")
        if rline[0] != "ROLE" or len(rline) != 4:
            raise BrokerError(f"bad ROLE frame: {rline}")
        _, role_name, epoch, seq = rline
        return role_name, int(epoch), int(seq)

    @_traced
    def promote(self, epoch: int) -> int:
        """Fence the peer to ``epoch`` and make it primary.  The epoch
        must exceed the peer's current one (the promotion ladder)."""
        self.sock.sendall(f"PROMOTE {epoch}\n".encode())
        resp = self._read_line()
        if not resp.startswith("OK "):
            raise BrokerError(f"PROMOTE failed: {resp}")
        return int(resp[3:])

    @_traced
    def sync_entry(self, epoch: int, seq: int, frame: bytes) -> int:
        """Replicate one journal frame to a standby.  Raises
        :class:`BrokerFenced` when the receiver's epoch is newer — this
        sender has been deposed and must stop streaming."""
        self.sock.sendall(f"SYNC {epoch} {seq} {len(frame)}\n".encode() + frame)
        resp = self._read_line()
        if resp.startswith("ERR fenced"):
            raise BrokerFenced(epoch, seq)
        if not resp.startswith("OK "):
            raise BrokerError(f"SYNC failed: {resp}")
        return int(resp[3:])

    @_traced
    def shard(self) -> tuple[int, int]:
        """The peer's (shard index, total shards) on the keyspace ring;
        (0, 1) for an unsharded broker.  Lets a router verify it dialed
        the owner of the keys it is about to route."""
        self.sock.sendall(b"SHARD\n")
        sline = self._read_line().split(" ")
        if sline[0] != "SHARD" or len(sline) != 3:
            raise BrokerError(f"bad SHARD frame: {sline}")
        _, shard, n_shards = sline
        return int(shard), int(n_shards)


def endpoints_from_record(record: dict) -> list[tuple[str, int]]:
    """The failover endpoint list a broker record file publishes.

    Replicated records carry ``endpoints`` (primary first, standby
    after); legacy single-process records only have host/port."""
    eps: list[tuple[str, int]] = []
    for ep in record.get("endpoints") or []:
        host, port = ep
        eps.append((str(host), int(port)))
    primary = (str(record["host"]), int(record["port"]))
    if primary not in eps:
        eps.insert(0, primary)
    return eps


class FailoverBrokerConnection:
    """Broker client that fails over across replica endpoints.

    Holds one live connection to the current leader.  A connection-level
    failure (dial refused, peer died mid-RPC, a standby's ``ERR not
    primary``) records a failure on THAT endpoint's breaker and moves to
    the next endpoint whose breaker admits a call; endpoints whose
    breaker is open are skipped (breaker-open is a failover trigger, not
    a dead end).  The first successful RPC after a switch journals
    ``broker_failover`` and resets the new endpoint's breaker — outage
    classification stays endpoint-local, so a clean failover never counts
    against a shared outage budget (docs/RESILIENCE.md "Broker
    failover").

    At-least-once safety: ``send`` goes through SENDID with a request id
    generated once per logical send, so the re-send after a primary dies
    mid-RPC (applied but unacked) cannot double-enqueue.  Every other
    verb is idempotent (reads, last-write-wins KV, receipt-keyed acks) or
    at-least-once by design (RECV leases).

    ``dial(host, port)`` is the connection seam: tests and the
    virtual-clock soak inject simulated connections; the default dials a
    real :class:`BrokerConnection` with this instance's token.

    ``endpoints_source`` (optional, ``() -> [(host, port), ...]``) is
    re-read once per RPC after every construction-time endpoint has been
    refused: after a failover the adoption ladder REWRITES the broker
    record (promoted primary first, auto-re-provisioned standby after),
    so a client started before the failover finds the fresh pair without
    a restart instead of walking dead endpoints forever.
    """

    _ENDPOINT_ERROR_HINTS = ("closed connection", "not primary")

    def __init__(
        self,
        endpoints,
        token: str | None = None,
        dial=None,
        breaker_factory=None,
        clock: Clock | None = None,
        max_cycles: int = 2,
        timeout_s: float = 10.0,
        endpoints_source=None,
    ):
        if not endpoints:
            raise BrokerError("failover connection needs at least one endpoint")
        self._endpoints = [(str(h), int(p)) for h, p in endpoints]
        self._token = token
        self._timeout_s = timeout_s
        self._clock = clock or MonotonicClock()
        if dial is None:

            def dial(host: str, port: int):
                return BrokerConnection(
                    host, port, timeout_s=self._timeout_s, token=self._token
                )

        self._dial = dial
        if breaker_factory is None:

            def breaker_factory(host: str, port: int) -> CircuitBreaker:
                return CircuitBreaker(
                    name=f"broker-endpoint:{host}:{port}",
                    failure_threshold=3,
                    reset_after_s=5.0,
                    clock=self._clock,
                )

        self._breaker_factory = breaker_factory
        self._breakers = {ep: breaker_factory(*ep) for ep in self._endpoints}
        self._endpoints_source = endpoints_source
        self._conn = None
        self._active = 0
        self._established: tuple[str, int] | None = None
        self._max_cycles = max_cycles
        self.failovers = 0
        self.endpoint_refreshes = 0

    @property
    def active_endpoint(self) -> tuple[str, int]:
        return self._endpoints[self._active]

    def breaker(self, endpoint) -> CircuitBreaker:
        host, port = endpoint
        return self._breakers[(str(host), int(port))]

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _is_endpoint_failure(self, exc: BaseException) -> bool:
        if isinstance(exc, (ConnectionError, OSError)):
            return True
        if isinstance(exc, BrokerError):
            text = str(exc)
            return any(hint in text for hint in self._ENDPOINT_ERROR_HINTS)
        return False

    def _next_allowed(self) -> int | None:
        n = len(self._endpoints)
        for step in range(n):
            idx = (self._active + step) % n
            if self._breakers[self._endpoints[idx]].allow():
                return idx
        return None

    def _refresh_endpoints(self) -> bool:
        """Re-read the endpoint list from ``endpoints_source`` (the
        rewritten broker record after adoption/re-provisioning).  Returns
        whether the list actually changed; breakers for surviving
        endpoints keep their failure history, new endpoints start
        closed."""
        if self._endpoints_source is None:
            return False
        try:
            fresh = [
                (str(h), int(p)) for h, p in (self._endpoints_source() or [])
            ]
        except Exception as exc:
            log.warning("broker endpoint refresh failed: %s", exc)
            return False
        if not fresh or fresh == self._endpoints:
            return False
        self.close()
        self._breakers = {
            ep: self._breakers.get(ep) or self._breaker_factory(*ep)
            for ep in fresh
        }
        self._endpoints = fresh
        self._active = 0
        self.endpoint_refreshes += 1
        return True

    def _call(self, rpc: str, op):
        last: BaseException | None = None
        # Second pass only after a refresh actually changed the endpoint
        # list: every known endpoint was refused, so re-read the record —
        # adoption may have replaced the pair since this client started.
        for attempt_pass in range(2):
            if attempt_pass and not self._refresh_endpoints():
                break
            attempts = len(self._endpoints) * self._max_cycles
            for _ in range(attempts):
                idx = self._next_allowed()
                if idx is None:
                    break
                endpoint = self._endpoints[idx]
                try:
                    if self._conn is None or idx != self._active:
                        self.close()
                        self._conn = self._dial(*endpoint)
                        self._active = idx
                    result = op(self._conn)
                except BaseException as exc:
                    if not self._is_endpoint_failure(exc):
                        raise
                    last = exc
                    self._breakers[endpoint].record_failure()
                    self.close()
                    self._active = (idx + 1) % len(self._endpoints)
                    continue
                if (
                    self._established is not None
                    and endpoint != self._established
                ):
                    # A successful switch is a failover, not an outage:
                    # reset the adopted endpoint's breaker and journal the
                    # event instead of feeding any shared failure budget.
                    self.failovers += 1
                    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

                    get_recorder().record(
                        "broker_failover",
                        rpc=rpc,
                        from_host=self._established[0],
                        from_port=self._established[1],
                        to_host=endpoint[0],
                        to_port=endpoint[1],
                    )
                self._breakers[endpoint].record_success()
                self._established = endpoint
                return result
        raise BrokerError(
            f"{rpc}: no broker endpoint available (endpoints "
            f"{self._endpoints}, last error: {last})"
        ) from last

    # -- the BrokerConnection surface, failover-wrapped -------------------
    def ping(self) -> bool:
        return self._call("ping", lambda c: c.ping())

    def send(self, queue: str, body: bytes, rid: str | None = None) -> str:
        rid = rid or uuid.uuid4().hex  # dlcfn: noqa[DLC601] idempotency key for a real client: must be unique across processes, so entropy is the point; sims pass explicit rids
        return self._call("send", lambda c: c.send_idempotent(queue, body, rid))

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        return self._call(
            "send_idempotent", lambda c: c.send_idempotent(queue, body, rid)
        )

    def receive(self, queue: str, max_messages: int, visibility_ms: int):
        return self._call(
            "receive", lambda c: c.receive(queue, max_messages, visibility_ms)
        )

    def delete(self, queue: str, receipt: str) -> bool:
        return self._call("delete", lambda c: c.delete(queue, receipt))

    def depth(self, queue: str) -> int:
        return self._call("depth", lambda c: c.depth(queue))

    def purge(self, queue: str) -> None:
        return self._call("purge", lambda c: c.purge(queue))

    def set(self, key: str, value: bytes) -> None:
        return self._call("set", lambda c: c.set(key, value))

    def get(self, key: str) -> bytes | None:
        return self._call("get", lambda c: c.get(key))

    def unset(self, key: str) -> bool:
        return self._call("unset", lambda c: c.unset(key))

    def heartbeat(self, worker_id: str) -> int:
        return self._call("heartbeat", lambda c: c.heartbeat(worker_id))

    def heartbeats(self) -> dict[str, tuple[float, int]]:
        return self._call("heartbeats", lambda c: c.heartbeats())

    def telem(self, worker_id: str, snapshot: bytes) -> int:
        return self._call("telem", lambda c: c.telem(worker_id, snapshot))

    def telemetry(self) -> dict[str, tuple[float, int, bytes]]:
        return self._call("telemetry", lambda c: c.telemetry())

    def role(self) -> tuple[str, int, int]:
        return self._call("role", lambda c: c.role())

    def shard(self) -> tuple[int, int]:
        return self._call("shard", lambda c: c.shard())


class ShardedBrokerRouter:
    """Shard-aware broker client over N independent primary/standby pairs.

    Hashes every queue/key/worker id on the production ring
    (:func:`shard_for_key`) and drives THAT shard's
    :class:`FailoverBrokerConnection` — per-endpoint CircuitBreakers,
    idempotent SENDID re-sends, and record-refresh failover all stay
    endpoint-local, so a single shard's failover stalls only the keys
    that hash there while the other shards' traffic flows untouched.

    ``shard_endpoints`` is a list (index = shard) of endpoint lists;
    ``shard_endpoint_sources`` optionally supplies a per-shard
    ``endpoints_source`` callable (normally a closure over that shard's
    record file) so long-lived routers survive adoption rewrites.
    Table-dump reads (``heartbeats``/``telemetry``) merge every
    reachable shard and skip shards mid-failover — the merged-view
    contract the liveness watcher expects."""

    def __init__(
        self,
        shard_endpoints,
        token: str | None = None,
        dial=None,
        breaker_factory=None,
        clock: Clock | None = None,
        timeout_s: float = 10.0,
        shard_endpoint_sources=None,
    ):
        if not shard_endpoints:
            raise BrokerError("sharded router needs at least one shard")
        if shard_endpoint_sources is not None and len(
            shard_endpoint_sources
        ) != len(shard_endpoints):
            raise BrokerError(
                "shard_endpoint_sources must match shard_endpoints"
            )
        self.n_shards = len(shard_endpoints)
        self._conns = [
            FailoverBrokerConnection(
                endpoints,
                token=token,
                dial=dial,
                breaker_factory=breaker_factory,
                clock=clock,
                timeout_s=timeout_s,
                endpoints_source=(
                    shard_endpoint_sources[k]
                    if shard_endpoint_sources is not None
                    else None
                ),
            )
            for k, endpoints in enumerate(shard_endpoints)
        ]

    @classmethod
    def for_cluster(
        cls, cluster_name: str, root=None, **kwargs
    ) -> "ShardedBrokerRouter":
        """Build a router from a recorded sharded deployment: per-shard
        endpoints come from each shard's record file, and each shard's
        ``endpoints_source`` re-reads that record so adoption rewrites
        are picked up live."""
        from deeplearning_cfn_tpu_torch.cluster import broker_service

        shard_map = broker_service.sharded_broker_records(cluster_name, root)
        if shard_map is None:
            raise BrokerError(
                f"no sharded broker recorded for {cluster_name}"
            )
        endpoints: list[list[tuple[str, int]]] = []
        sources = []
        token = None
        for entry in shard_map:
            record = entry.get("record")
            if record is None:
                raise BrokerError(
                    f"shard {entry.get('shard')} of {cluster_name} has no "
                    "live record"
                )
            token = token or record.get("token")
            endpoints.append(endpoints_from_record(record))

            def source(name=entry["cluster"]):
                rec = broker_service.broker_status(name, root)
                return endpoints_from_record(rec) if rec else []

            sources.append(source)
        kwargs.setdefault("token", token)
        return cls(endpoints, shard_endpoint_sources=sources, **kwargs)

    @property
    def failovers(self) -> int:
        return sum(conn.failovers for conn in self._conns)

    def shard_index(self, key: str) -> int:
        return shard_for_key(key, self.n_shards)

    def connection(self, key: str) -> FailoverBrokerConnection:
        """The failover connection owning ``key``'s shard."""
        return self._conns[self.shard_index(key)]

    def shard_connections(self) -> list[FailoverBrokerConnection]:
        return list(self._conns)

    def close(self) -> None:
        for conn in self._conns:
            conn.close()

    # -- key-routed verbs -------------------------------------------------
    def ping(self) -> bool:
        return all(conn.ping() for conn in self._conns)

    def send(self, queue: str, body: bytes, rid: str | None = None) -> str:
        return self.connection(queue).send(queue, body, rid)

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        return self.connection(queue).send_idempotent(queue, body, rid)

    def receive(self, queue: str, max_messages: int, visibility_ms: int):
        return self.connection(queue).receive(
            queue, max_messages, visibility_ms
        )

    def delete(self, queue: str, receipt: str) -> bool:
        return self.connection(queue).delete(queue, receipt)

    def depth(self, queue: str) -> int:
        return self.connection(queue).depth(queue)

    def purge(self, queue: str) -> None:
        return self.connection(queue).purge(queue)

    def set(self, key: str, value: bytes) -> None:
        return self.connection(key).set(key, value)

    def get(self, key: str) -> bytes | None:
        return self.connection(key).get(key)

    def unset(self, key: str) -> bool:
        return self.connection(key).unset(key)

    def heartbeat(self, worker_id: str) -> int:
        return self.connection(worker_id).heartbeat(worker_id)

    def telem(self, worker_id: str, snapshot: bytes) -> int:
        return self.connection(worker_id).telem(worker_id, snapshot)

    # -- merged table dumps ----------------------------------------------
    def heartbeats(self) -> dict[str, tuple[float, int]]:
        merged: dict[str, tuple[float, int]] = {}
        for conn in self._conns:
            try:
                merged.update(conn.heartbeats())
            except BrokerError:
                continue  # shard mid-failover: only ITS slice goes dark
        return merged

    def telemetry(self) -> dict[str, tuple[float, int, bytes]]:
        merged: dict[str, tuple[float, int, bytes]] = {}
        for conn in self._conns:
            try:
                merged.update(conn.telemetry())
            except BrokerError:
                continue
        return merged


class BrokerQueue(RendezvousQueue):
    """RendezvousQueue over the native broker."""

    def __init__(
        self,
        name: str,
        host: str = "127.0.0.1",
        port: int = 8477,
        token: str | None = None,
    ):
        self.name = name
        self._conn = BrokerConnection(host, port, token=token)

    def send(self, body: dict[str, Any]) -> str:
        return self._conn.send(self.name, json.dumps(body).encode())

    def receive(
        self, max_messages: int = 10, visibility_timeout_s: float = 60.0
    ) -> list[Message]:
        raw = self._conn.receive(
            self.name, max_messages, int(visibility_timeout_s * 1000)
        )
        return [
            Message(
                message_id=mid,
                body=json.loads(payload.decode()),
                receipt=receipt,
                receive_count=count,
            )
            for mid, receipt, count, payload in raw
        ]

    def delete(self, receipt: str) -> None:
        self._conn.delete(self.name, receipt)

    def purge(self) -> None:
        self._conn.purge(self.name)

    def approximate_depth(self) -> int:
        return self._conn.depth(self.name)

    def close(self) -> None:
        self._conn.close()


def broker_binary_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the broker is built: named by a hash of the source and flags.
    The name keeps ``dlcfn-broker`` in it, which teardown's pid check reads
    in ``/proc/<pid>/cmdline``."""
    h = hashlib.sha256(BROKER_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return Path(build_dir) / f"dlcfn-broker-{h.hexdigest()[:12]}"


def build_broker(force: bool = False, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/broker/broker.cpp`` into ``build_dir`` unless it is
    there (idempotent), under a file lock; the output is written to a
    temporary file and moved into place.  Raises :class:`BrokerError` with
    the compiler's output."""
    out = broker_binary_path(build_dir)
    if out.exists() and not force:
        return out
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise BrokerError("building the broker needs g++ (or $CXX); none found")
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists() and not force:  # built by another process meanwhile
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                # Bounded: a wedged compiler must fail the provision step,
                # not hang it.
                res = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(BROKER_SRC), *LD_FLAGS],
                    capture_output=True, text=True, timeout=600,
                )
            except (OSError, subprocess.TimeoutExpired) as e:
                raise BrokerError(f"building the broker failed: {e}") from e
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise BrokerError(f"building the broker failed:\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


class BrokerProcess:
    """Build + spawn + supervise a local broker (ephemeral port by default).

    ``token``: spawn the broker with AUTH required (via env, never argv —
    /proc cmdline is world-readable)."""

    def __init__(
        self,
        port: int = 0,
        token: str | None = None,
        ready_timeout_s: float = 5.0,
        clock: Clock | None = None,
    ):
        binary = build_broker()
        self.token = token
        env = dict(os.environ)
        env.pop("DLCFN_BROKER_TOKEN", None)
        if token:
            env["DLCFN_BROKER_TOKEN"] = token
        self.proc = subprocess.Popen(
            [str(binary), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        assert self.proc.stdout is not None
        line = self.proc.stdout.readline()
        if "listening on" not in line:
            raise BrokerError(f"broker failed to start: {line!r}")
        self.port = int(line.strip().rsplit(" ", 1)[-1])

        # Wait until accepting, on a monotonic budget with a typed
        # timeout (BrokerTimeout) instead of the old unbounded-feeling
        # bare-sleep spin.
        def _probe() -> None:
            conn = BrokerConnection("127.0.0.1", self.port, timeout_s=1.0)
            try:
                conn.ping()
            finally:
                conn.close()

        await_broker_ready(_probe, timeout_s=ready_timeout_s, clock=clock)

    def queue(self, name: str) -> BrokerQueue:
        return BrokerQueue(name, "127.0.0.1", self.port, token=self.token)

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()

    def __enter__(self) -> "BrokerProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
