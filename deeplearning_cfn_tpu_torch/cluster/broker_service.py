"""The rendezvous broker as a STACK RESOURCE.

Counterpart of ``deeplearning_cfn_tpu/cluster/broker_service.py``, copied
(the port imports nothing of the JAX package): the records under the
contract root are the JAX package's, field for field.

The reference's control-plane queues are CloudFormation resources — created
with the stack, deleted with it, never a manual pre-step
(deeplearning.template:743-754).  Round 2 shipped the broker binary and the
agents that dial it, but ``create`` still assumed an operator had started a
broker somewhere routable.  This module closes that gap: ``dlcfn create
--broker auto`` (and run/recover) calls :func:`ensure_broker`, which

- reuses a live broker previously recorded for this cluster (idempotent,
  like CloudFormation's no-op update for an unchanged resource),
- otherwise builds (``broker_client.build_broker``, into
  ``build/torch_native/``) and spawns the broker as a DETACHED process that
  outlives the CLI (the stack outlives ``create``),
- health-checks it (PING) before any queued-resource creation happens, and
- records ``{host, port, pid}`` under the contract root so ``dlcfn
  delete`` can tear it down with the cluster (:func:`teardown_broker`).

Topology: the broker runs on the operator/controller host — the GCE-VM
analog of the reference's regional SQS endpoint — and its address is
stamped into TPU VM metadata exactly as an explicit ``--broker HOST:PORT``
would be (provision/gcp.py broker_host).  ``advertise`` selects the address
written to the record: loopback for the local/dev backend, this host's
routable IP (or an explicit override) for real clusters.

Exposure: the broker is bound to loopback plus the advertise interface
only (and this host's outbound interface when the advertise address is a
non-local NAT/public IP, since that is where forwarded traffic actually
arrives) — never all interfaces.  An unauthenticated rendezvous plane
must not listen on interfaces no cluster VM dials.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import time
from pathlib import Path
from typing import Sequence

from deeplearning_cfn_tpu_torch.cluster.broker_client import (
    BrokerConnection,
    BrokerError,
    build_broker,
)
from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.obs.liveness import (
    LivenessConfig,
    LivenessTable,
    WorkerState,
)
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder, read_journal
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.broker")

_LISTENING = re.compile(r"listening on (\d+)")


def _record_path(cluster_name: str, root: Path | None = None) -> Path:
    root = root or ClusterContract.root_dir()
    return root / "broker" / f"{cluster_name}.json"


def _standby_record_path(cluster_name: str, root: Path | None = None) -> Path:
    root = root or ClusterContract.root_dir()
    return root / "broker" / f"{cluster_name}.standby.json"


def _repl_log_path(cluster_name: str, root: Path | None = None) -> Path:
    """The primary's replication journal: flight-recorder JSONL
    (``kind: broker_apply``) appended by the broker binary for every
    state mutation it applies, tailed by :class:`ReplicationStreamer`."""
    root = root or ClusterContract.root_dir()
    return root / "broker" / f"{cluster_name}.repl.jsonl"


def _standby_repl_log_path(
    cluster_name: str, root: Path | None = None
) -> Path:
    """The STANDBY's copy of the journal: every SYNC entry it applies is
    re-journaled at the entry's own seq/epoch, so after a promotion the
    adopter renames this file over :func:`_repl_log_path` and replication
    resumes from the promoted node's journal (self-healing pair)."""
    root = root or ClusterContract.root_dir()
    return root / "broker" / f"{cluster_name}.standby.repl.jsonl"


def shard_cluster_name(cluster_name: str, shard: int) -> str:
    """The per-shard internal cluster name: shard ``k`` of ``cluster`` is
    recorded, locked, logged, and journaled as ``cluster.shard<k>`` —
    every single-pair code path (spawn/adopt/teardown/status) applies to
    a shard unchanged."""
    return f"{cluster_name}.shard{shard}"


def _shard_map_path(cluster_name: str, root: Path | None = None) -> Path:
    """The shard-map record: which per-shard cluster names make up a
    sharded deployment, in ring order."""
    root = root or ClusterContract.root_dir()
    return root / "broker" / f"{cluster_name}.shards.json"


def detect_host_ip() -> str:
    """This host's outbound IP — the address a TPU VM would dial.  The
    UDP-connect trick never sends a packet; the fallback is loopback
    (dev boxes with no route)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def _alive(host: str, port: int, timeout_s: float = 2.0) -> bool:
    # token="" suppresses the AUTH handshake (PING is deliberately
    # unauthenticated): liveness must be checkable before the record —
    # and therefore the token — exists, and must not fail on a stale
    # ambient DLCFN_BROKER_TOKEN.
    try:
        conn = BrokerConnection(host, port, timeout_s=timeout_s, token="")
        try:
            return conn.ping()
        finally:
            conn.close()
    except (OSError, BrokerError):
        return False


def broker_token(cluster_name: str, root: Path | None = None) -> str | None:
    """The shared secret of the cluster's recorded broker, or None (open
    broker from an older record).  The record file is operator-only
    (0600); VMs receive the token through instance metadata, the channel
    the reference used for IAM-scoped credentials."""
    rec = _record_path(cluster_name, root)
    try:
        return json.loads(rec.read_text()).get("token") or None
    except (OSError, ValueError):
        return None


def _write_record(rec: Path, payload: dict) -> None:
    """Write the broker record operator-only: it carries the AUTH token,
    which must never be world-readable on a shared host — not even for
    the umask window between create and chmod.  A fresh 0600 inode is
    created and atomically renamed over the record, so readers see
    either the old record or the new one, never a partial write or a
    permissive mode."""
    tmp = rec.with_suffix(".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(json.dumps(payload))
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, rec)


def _bind_addresses(advertise: str | None) -> str:
    """The comma-separated bind list handed to the broker binary: loopback
    (liveness probes + the local/dev backend) plus the advertise interface.
    A non-local advertise address (operator NAT/public IP) cannot be bound
    — the binary skips it — so the host's outbound interface is included
    too, which is where NAT-forwarded traffic actually arrives."""
    addrs = ["127.0.0.1"]
    if advertise and advertise not in addrs:
        addrs.append(advertise)
        host_ip = detect_host_ip()
        if host_ip not in addrs:
            addrs.append(host_ip)
    return ",".join(addrs)


def broker_status(cluster_name: str, root: Path | None = None) -> dict | None:
    """The recorded broker for a cluster, plus liveness — or None.

    Liveness is probed on LOOPBACK: the broker always runs on this host
    (loopback is always in its bind list); the recorded ``host`` is only
    the address VMs dial, which may be a NAT/public IP not locally
    routable — probing it would misread a live broker as dead and spawn a
    leaked duplicate."""
    rec = _record_path(cluster_name, root)
    try:
        data = json.loads(rec.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    data["alive"] = _alive("127.0.0.1", int(data["port"]))
    return data


def standby_broker_status(
    cluster_name: str, root: Path | None = None
) -> dict | None:
    """The recorded warm-standby replica for a cluster, plus liveness —
    or None.  Loopback probe, same rationale as :func:`broker_status`."""
    srec = _standby_record_path(cluster_name, root)
    try:
        data = json.loads(srec.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    data["alive"] = _alive("127.0.0.1", int(data["port"]))
    return data


def _adopt_standby(
    cluster_name: str,
    root: Path | None,
    dead_record: dict,
    rec: Path,
) -> tuple[str, int, bool] | None:
    """Promote a live warm standby over a dead primary's record.

    The promotion ladder (docs/RESILIENCE.md "Broker failover"): fence the
    standby to ``max(dead primary's epoch, standby's epoch) + 1`` with
    PROMOTE — strictly above any term the deposed primary could still be
    streaming under — then rewrite the PRIMARY record file to point at it
    and unlink the standby record (it is a standby no more).  Returns
    ``(host, port, False)`` like a reuse, or None when no LIVE standby
    exists; a stale standby record is unlinked here so it cannot shadow
    the dead primary (the single-process-singleton bug this replaces).

    Self-healing (docs/RESILIENCE.md "Sharded broker"): the promoted
    node's own journal copy is renamed over the primary journal path
    (its repl fd follows the inode, so post-promotion appends continue
    in place), a FRESH standby is re-provisioned, and the journal is
    replayed into it — a failover never leaves a degraded pair as steady
    state.  Re-provisioning is best-effort: a failure degrades to the
    pre-heal behavior (promoted primary, no standby) rather than failing
    the adoption.
    """
    srec = _standby_record_path(cluster_name, root)
    try:
        standby = json.loads(srec.read_text())
    except (OSError, ValueError):
        return None
    if not _alive("127.0.0.1", int(standby["port"])):
        log.warning(
            "standby broker record for %s (pid %s) is stale; removing it",
            cluster_name, standby.get("pid"),
        )
        srec.unlink(missing_ok=True)
        return None
    token = standby.get("token") or dead_record.get("token") or ""
    conn = BrokerConnection(
        "127.0.0.1", int(standby["port"]), timeout_s=5.0, token=token
    )
    try:
        _, standby_epoch, repl_seq = conn.role()
        new_epoch = max(
            int(dead_record.get("epoch", 0) or 0), standby_epoch
        ) + 1
        conn.promote(new_epoch)
    finally:
        conn.close()
    host = standby.get("host") or dead_record.get("host") or "127.0.0.1"
    port = int(standby["port"])
    record_payload = {
        "cluster": cluster_name,
        "host": host,
        "port": port,
        "pid": int(standby["pid"]),
        "binds": standby.get("binds", dead_record.get("binds", "")),
        "binds_requested": standby.get(
            "binds_requested", dead_record.get("binds_requested", "")
        ),
        "token": token or None,
        "role": "primary",
        "epoch": new_epoch,
        "endpoints": [[host, port]],
        "started_ts": standby.get("started_ts", time.time()),
    }
    for key in ("shard", "n_shards"):
        if key in dead_record:
            record_payload[key] = dead_record[key]
    _write_record(rec, record_payload)
    srec.unlink(missing_ok=True)
    # The promoted node journaled every entry it acked into its own copy;
    # rename it over the primary journal path so its repl fd (which
    # follows the inode) keeps appending there and the streamer resumes
    # from the promoted node's journal.  The dead primary's journal — and
    # with it any unshipped tail that died with the process — is replaced.
    standby_repl = _standby_repl_log_path(cluster_name, root)
    repl_log = _repl_log_path(cluster_name, root)
    if standby_repl.exists():
        os.replace(standby_repl, repl_log)
    else:
        repl_log.unlink(missing_ok=True)
    log.warning(
        "promoted standby broker for %s at %s:%d (pid %s, epoch %d, "
        "replayed seq %d)",
        cluster_name, host, port, standby.get("pid"), new_epoch, repl_seq,
    )
    get_recorder().record(
        "broker_promoted",
        cluster=cluster_name,
        broker_host=host,
        broker_port=port,
        epoch=new_epoch,
        repl_seq=repl_seq,
    )
    # Self-heal: re-provision a FRESH standby and replay the journal into
    # it, so broker_replication_status never reports a degraded pair as
    # steady state.  Best-effort — the promoted primary is already
    # serving; a heal failure is logged and retried by the next ensure.
    try:
        sb_host, sb_port, _ = ensure_standby_broker(cluster_name, root=root)
        streamer = ReplicationStreamer(cluster_name, root=root)
        replayed = streamer.step()
        get_recorder().record(
            "standby_reprovisioned",
            cluster=cluster_name,
            broker_host=sb_host,
            broker_port=sb_port,
            epoch=new_epoch,
            replayed=replayed,
        )
        log.warning(
            "re-provisioned standby broker for %s at %s:%d (%d journal "
            "entries replayed)",
            cluster_name, sb_host, sb_port, replayed,
        )
    except (OSError, BrokerError) as exc:
        log.warning(
            "standby re-provision for %s failed (pair stays degraded "
            "until the next ensure): %s",
            cluster_name, exc,
        )
    return host, port, False


def ensure_broker(
    cluster_name: str,
    root: Path | None = None,
    advertise: str | None = None,
    port: int = 0,
    timeout_s: float = 30.0,
    extra_binds: Sequence[str] | None = None,
    reuse_token: str | None = None,
    reuse_epoch: int | None = None,
    shard: int | None = None,
    n_shards: int | None = None,
) -> tuple[str, int, bool]:
    """Return ``(host, port, started)`` for a live broker serving this
    cluster, starting one (detached) if none is recorded and reachable.

    ``extra_binds``: additional interfaces to bind beyond what
    ``advertise`` implies — the restart path passes the PREVIOUS broker's
    requested binds here so the replacement serves the union.  Without
    the union, two concurrent CLIs passing different advertise addresses
    would ping-pong: each restart binds only its own advertise, which
    re-fails the other CLI's reuse check, which restarts again.

    ``shard``/``n_shards``: the keyspace-ring stamp for a per-shard pair
    spawned by :func:`ensure_sharded_broker` — written to the record and
    the binary's SHARD identity; None for an unsharded broker."""
    rec = _record_path(cluster_name, root)

    def reuse_live(record: dict) -> tuple[str, int, bool] | None:
        """Return a live recorded broker, rewriting the advertised host
        when the caller passes a different one — the record's host is only
        the address VMs dial; an operator re-running with a (corrected)
        advertise address must not be silently held to the old one.  Used
        by BOTH reuse paths (uncontended and lock-contention wait), so a
        ``create --broker-advertise X`` racing a concurrent ``run`` cannot
        come back with the other process's advertise address.

        Returns None when the rewrite needs interfaces the running broker
        never bound (its bind set is fixed at spawn): handing VMs an
        address nothing listens on would hang bootstrap with connection
        refusals.  The caller restarts the broker with the right binds."""
        host = record["host"]
        if advertise is not None and advertise != host:
            # Records from before binds were narrowed carry no bind list;
            # those brokers bound all interfaces, so any rewrite is safe.
            # The comparison is against the REQUESTED set (what the old
            # broker attempted), not the actual binds: an address the old
            # broker already tried and found unbindable (a NAT advertise)
            # would fail again after a restart — comparing against actual
            # binds would restart on every reuse, forever.
            attempted = set(
                str(record.get("binds_requested", record.get("binds", "*"))).split(",")
            )
            needed = set(_bind_addresses(advertise).split(","))
            if "*" not in attempted and not needed <= attempted:
                log.warning(
                    "advertise %s needs interfaces the live broker never "
                    "attempted to bind (%s); restarting it with the wider "
                    "bind set",
                    advertise, ",".join(sorted(attempted)),
                )
                return None
            log.warning(
                "rewriting broker advertise address for %s: %s -> %s",
                cluster_name, host, advertise,
            )
            record["host"] = host = advertise
            # The failover dial list leads with the primary's advertised
            # address; keep it in step with the rewrite.
            if record.get("endpoints"):
                record["endpoints"][0] = [host, int(record["port"])]
            _write_record(
                rec, {k: v for k, v in record.items() if k != "alive"}
            )
        log.info(
            "reusing broker for %s at %s:%s (pid %s)",
            cluster_name, host, record["port"], record["pid"],
        )
        return host, int(record["port"]), False

    def restart_with_wider_binds(old_record: dict) -> tuple[str, int, bool]:
        # The replacement binds the UNION of the old broker's requested
        # interfaces and this caller's: concurrent CLIs with different
        # advertise addresses converge on one broker serving both instead
        # of killing each other's in turn.  (The teardown itself still
        # discards the old broker's in-memory rendezvous state — which is
        # exactly why converging after ONE restart matters.)
        prior = [
            a
            for a in str(
                old_record.get("binds_requested", old_record.get("binds", ""))
            ).split(",")
            if a and a != "*"
        ]
        merged = sorted(set(prior) | set(extra_binds or []))
        teardown_broker(cluster_name, root)
        return ensure_broker(
            cluster_name, root=root, advertise=advertise, port=port,
            timeout_s=timeout_s, extra_binds=merged,
            shard=shard, n_shards=n_shards,
            # Carry the old broker's AUTH token into the replacement:
            # agents provisioned by the OTHER CLI hold it in VM metadata,
            # and that CLI's process holds it ambiently — regenerating
            # would permanently lock them all out.
            reuse_token=old_record.get("token") or reuse_token,
            # Bump the epoch: the replacement is a NEW leadership term (its
            # in-memory state starts empty), so any stale replication
            # stream from the torn-down broker must be fenced.
            reuse_epoch=int(old_record.get("epoch", 0) or 0) + 1,
        )

    existing = broker_status(cluster_name, root)
    if existing is not None:
        if existing["alive"]:
            reused = reuse_live(existing)
            if reused is None:
                return restart_with_wider_binds(existing)
            return reused
        # Dead primary: adopt (promote) a live warm standby before falling
        # back to a cold start — a promotion keeps the replicated KV /
        # queue / heartbeat state; a fresh spawn starts empty.  A STALE
        # standby record is unlinked inside _adopt_standby so it can never
        # shadow the dead primary on later calls.
        adopted = _adopt_standby(cluster_name, root, existing, rec)
        if adopted is not None:
            return adopted
        log.warning(
            "recorded broker for %s at %s:%s is dead; starting a new one",
            cluster_name, existing["host"], existing["port"],
        )
        # Preserve the dead broker's AUTH token: VMs provisioned against
        # it hold that token in instance metadata, and a crash-restart of
        # the operator host must let them re-converge, not lock them out.
        if reuse_token is None:
            reuse_token = existing.get("token") or None
        # Fence the dead broker's term even on a cold restart: if its
        # process is merely partitioned (not dead) and later streams SYNC
        # frames, the bumped epoch rejects them.
        if reuse_epoch is None:
            reuse_epoch = int(existing.get("epoch", 0) or 0) + 1
        rec.unlink(missing_ok=True)

    binary = build_broker()
    rec.parent.mkdir(parents=True, exist_ok=True)
    log_path = rec.with_suffix(".log")
    # Exclusive-create lock: two concurrent ensure calls (parallel create +
    # run) must not each spawn a detached broker — the loser's process
    # would be leaked with no record pointing at it.
    lock = rec.with_suffix(".lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
    except FileExistsError:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = broker_status(cluster_name, root)
            if st is not None and st["alive"]:
                reused = reuse_live(st)
                if reused is None:
                    # The race winner's broker lacks interfaces this
                    # caller's advertise needs; replace it.
                    return restart_with_wider_binds(st)
                return reused
            # Stale-lock reclaim: the holder wrote its pid for exactly
            # this check — a crash between lock and unlink must not brick
            # --broker auto until manual cleanup.
            try:
                holder = int(lock.read_text().strip() or 0)
            except (FileNotFoundError, ValueError):
                holder = 0
            holder_alive = False
            if holder:
                try:
                    os.kill(holder, 0)
                    holder_alive = True
                except ProcessLookupError:
                    holder_alive = False
                except PermissionError:
                    # EPERM = the pid EXISTS under another user — alive.
                    holder_alive = True
            if holder and not holder_alive:
                # Atomic reclaim: rename wins exactly once, so two waiters
                # observing the same dead holder cannot both proceed (the
                # loser's rename fails and it keeps waiting for the
                # winner's record).  The rename alone is not enough — a
                # slow waiter could rename the WINNER's fresh lock — so
                # verify the renamed file still names the dead holder and
                # restore it if not.
                stale = lock.with_suffix(".stale")
                try:
                    os.rename(lock, stale)
                except FileNotFoundError:
                    time.sleep(0.1)
                    continue
                try:
                    renamed_holder = int(stale.read_text().strip() or 0)
                except (FileNotFoundError, ValueError):
                    renamed_holder = 0
                if renamed_holder != holder:
                    # We grabbed a lock newer than the one we observed
                    # dead: put it back and keep waiting on its owner.
                    try:
                        os.rename(stale, lock)
                    except OSError:
                        pass
                    time.sleep(0.1)
                    continue
                stale.unlink(missing_ok=True)
                log.warning(
                    "reclaimed stale broker lock %s (holder pid %d is dead)",
                    lock, holder,
                )
                return ensure_broker(
                    cluster_name, root=root, advertise=advertise, port=port,
                    timeout_s=max(deadline - time.monotonic(), 5.0),
                    extra_binds=extra_binds, reuse_token=reuse_token,
                    reuse_epoch=reuse_epoch, shard=shard, n_shards=n_shards,
                )
            time.sleep(0.1)
        raise BrokerError(
            f"another process holds {lock} but never published a live "
            "broker; remove the lock if it is stale"
        )
    try:
        # "wb": a crashed broker's log would otherwise leave a stale
        # "listening on <port>" line that the parser below would match
        # first, pointing every restart at the dead port.
        log_fh = open(log_path, "wb")
        try:
            # start_new_session: the broker is a stack resource that must
            # survive this CLI process (and its process group / terminal).
            # The explicit bind list keeps the unauthenticated rendezvous
            # plane off interfaces no cluster VM dials (see module doc).
            bind_list = _bind_addresses(advertise).split(",")
            for a in extra_binds or []:
                if a and a != "*" and a not in bind_list:
                    bind_list.append(a)
            # Shared-secret AUTH (the reference's control plane was
            # IAM-gated, deeplearning.template:193-197; an open rendezvous
            # on the advertise interface is below that bar).  Via env so
            # the token never appears in /proc/<pid>/cmdline.
            import secrets

            token = reuse_token or secrets.token_hex(16)  # dlcfn: noqa[DLC601] auth token for a real broker process: unpredictability is the requirement, not replayability
            epoch = int(reuse_epoch or 0)
            # Fresh leadership term, fresh journal: a new primary's seq
            # counter restarts at 1, so stale entries from the previous
            # term would make a standby's skip-by-seq dedup swallow the
            # new term's stream.
            repl_log = _repl_log_path(cluster_name, root)
            repl_log.unlink(missing_ok=True)
            spawn_env = {
                **os.environ,
                "DLCFN_BROKER_TOKEN": token,
                "DLCFN_BROKER_ROLE": "primary",
                "DLCFN_BROKER_EPOCH": str(epoch),
                "DLCFN_BROKER_REPL_LOG": str(repl_log),
            }
            if n_shards is not None:
                spawn_env["DLCFN_BROKER_SHARD"] = str(shard or 0)
                spawn_env["DLCFN_BROKER_NSHARDS"] = str(n_shards)
            proc = subprocess.Popen(
                [str(binary), str(port), ",".join(bind_list)],
                stdout=log_fh,
                stderr=subprocess.STDOUT,
                start_new_session=True,
                env=spawn_env,
            )
        finally:
            log_fh.close()

        # The broker prints "dlcfn-broker listening on <port>" first; poll
        # the log for it (stdout is detached), then health-check with PING.
        deadline = time.monotonic() + timeout_s
        bound_port: int | None = None
        while time.monotonic() < deadline and bound_port is None:
            if proc.poll() is not None:
                raise BrokerError(
                    f"broker exited with {proc.returncode} at startup; "
                    f"see {log_path}"
                )
            m = _LISTENING.search(log_path.read_text(errors="replace"))
            if m:
                bound_port = int(m.group(1))
                break
            time.sleep(0.05)
        if bound_port is None:
            proc.terminate()
            raise BrokerError(f"broker did not report a port; see {log_path}")
        while time.monotonic() < deadline:
            if _alive("127.0.0.1", bound_port):
                break
            time.sleep(0.05)
        else:
            proc.terminate()
            raise BrokerError("broker did not become reachable")

        host = advertise or "127.0.0.1"
        # Record what the broker ACTUALLY listens on, not what was
        # requested: the binary skips unbindable addresses (NAT IPs,
        # port conflicts on one interface) non-fatally and logs each.
        # Recording the requested list would let a later advertise
        # rewrite pass the needed<=bound safety check against addresses
        # nothing serves.
        requested = list(bind_list)
        skipped = set(
            re.findall(
                r"skipping unbindable address (\S+)",
                log_path.read_text(errors="replace"),
            )
        )
        actual_binds = [a for a in requested if a not in skipped]
        if advertise and advertise in skipped:
            # Expected for a NAT/public advertise address (traffic arrives
            # at the host's own interface, which is bound); surfaced so a
            # port conflict on a LOCAL advertise interface is not silent.
            log.warning(
                "advertise address %s is not locally bindable; VMs must "
                "reach the broker via forwarding to one of: %s",
                advertise, ",".join(actual_binds),
            )
        record_payload = {
            "cluster": cluster_name,
            "host": host,
            "port": bound_port,
            "pid": proc.pid,
            # What the broker actually listens on (skips removed)
            # vs what was attempted: reuse compares advertise needs
            # against ATTEMPTED (retrying a known-unbindable NAT
            # address is pointless), while the actual list is the
            # honest record of what serves.
            "binds": ",".join(actual_binds),
            "binds_requested": ",".join(requested),
            # The AUTH shared secret; the record is chmod 0600.
            "token": token,
            # Replication metadata (docs/RESILIENCE.md "Broker
            # failover"): the leadership term this process was fenced
            # to at spawn, and the ordered dial list handed to
            # failover clients (endpoints_from_record).  A standby
            # attach (ensure_standby_broker) appends its address here.
            "role": "primary",
            "epoch": epoch,
            "endpoints": [[host, bound_port]],
            "started_ts": time.time(),
        }
        if n_shards is not None:
            record_payload["shard"] = int(shard or 0)
            record_payload["n_shards"] = int(n_shards)
        _write_record(rec, record_payload)
    finally:
        lock.unlink(missing_ok=True)
    log.info(
        "started broker for %s at %s:%d (pid %d, log %s)",
        cluster_name, host, bound_port, proc.pid, log_path,
    )
    get_recorder().record(
        "broker_started",
        cluster=cluster_name,
        broker_host=host,
        broker_port=bound_port,
        broker_pid=proc.pid,
    )
    return host, bound_port, True


def ensure_standby_broker(
    cluster_name: str,
    root: Path | None = None,
    port: int = 0,
    timeout_s: float = 30.0,
) -> tuple[str, int, bool]:
    """Return ``(host, port, started)`` for a warm-standby replica of the
    cluster's recorded primary, spawning one (detached) if none is live.

    The standby runs on the same host as the primary (the operator /
    controller host), shares its AUTH token, starts at the primary's
    epoch with ``DLCFN_BROKER_ROLE=standby`` — rejecting client writes
    until promoted — and is recorded in ``<cluster>.standby.json``.  The
    PRIMARY record's ``endpoints`` list is extended so failover clients
    (``FailoverBrokerConnection``) learn both addresses from one record.
    State flows to it through :class:`ReplicationStreamer`, not at spawn:
    a standby attached mid-life converges as the journal is replayed.
    """
    primary = broker_status(cluster_name, root)
    if primary is None or not primary["alive"]:
        raise BrokerError(
            f"no live primary broker recorded for {cluster_name}; "
            "run ensure_broker first"
        )
    srec = _standby_record_path(cluster_name, root)
    existing = standby_broker_status(cluster_name, root)
    if existing is not None:
        if existing["alive"]:
            log.info(
                "reusing standby broker for %s at %s:%s (pid %s)",
                cluster_name, existing["host"], existing["port"],
                existing["pid"],
            )
            return existing["host"], int(existing["port"]), False
        srec.unlink(missing_ok=True)

    binary = build_broker()
    srec.parent.mkdir(parents=True, exist_ok=True)
    log_path = srec.with_suffix(".log")
    binds = str(
        primary.get("binds_requested") or primary.get("binds") or "127.0.0.1"
    )
    token = primary.get("token") or ""
    epoch = int(primary.get("epoch", 0) or 0)
    # The standby journals every SYNC entry it applies into its OWN copy
    # of the journal, seq/epoch-faithful (not a local counter, so replay
    # after ITS promotion dedups exactly).  Fresh standby, fresh copy.
    standby_repl = _standby_repl_log_path(cluster_name, root)
    standby_repl.unlink(missing_ok=True)
    env = {
        **os.environ,
        # Token via env (never argv).
        "DLCFN_BROKER_TOKEN": token,
        "DLCFN_BROKER_ROLE": "standby",
        "DLCFN_BROKER_EPOCH": str(epoch),
        "DLCFN_BROKER_REPL_LOG": str(standby_repl),
    }
    # A shard-stamped primary gets a matching standby (SHARD identity).
    if primary.get("n_shards"):
        env["DLCFN_BROKER_SHARD"] = str(primary.get("shard", 0))
        env["DLCFN_BROKER_NSHARDS"] = str(primary["n_shards"])
    # "wb" for the same stale-"listening on" reason as ensure_broker.
    log_fh = open(log_path, "wb")
    try:
        proc = subprocess.Popen(
            [str(binary), str(port), binds],
            stdout=log_fh,
            stderr=subprocess.STDOUT,
            start_new_session=True,
            env=env,
        )
    finally:
        log_fh.close()

    deadline = time.monotonic() + timeout_s
    bound_port: int | None = None
    while time.monotonic() < deadline and bound_port is None:
        if proc.poll() is not None:
            raise BrokerError(
                f"standby broker exited with {proc.returncode} at startup; "
                f"see {log_path}"
            )
        m = _LISTENING.search(log_path.read_text(errors="replace"))
        if m:
            bound_port = int(m.group(1))
            break
        time.sleep(0.05)
    if bound_port is None:
        proc.terminate()
        raise BrokerError(
            f"standby broker did not report a port; see {log_path}"
        )
    while time.monotonic() < deadline:
        if _alive("127.0.0.1", bound_port):
            break
        time.sleep(0.05)
    else:
        proc.terminate()
        raise BrokerError("standby broker did not become reachable")

    host = primary["host"]
    standby_payload = {
        "cluster": cluster_name,
        "host": host,
        "port": bound_port,
        "pid": proc.pid,
        "binds": binds,
        "binds_requested": binds,
        "token": token or None,
        "role": "standby",
        "epoch": epoch,
        "started_ts": time.time(),
    }
    for key in ("shard", "n_shards"):
        if key in primary:
            standby_payload[key] = primary[key]
    _write_record(srec, standby_payload)
    prec = {k: v for k, v in primary.items() if k != "alive"}
    prec["endpoints"] = [
        [primary["host"], int(primary["port"])],
        [host, bound_port],
    ]
    _write_record(_record_path(cluster_name, root), prec)
    log.info(
        "started standby broker for %s at %s:%d (pid %d, epoch %d, log %s)",
        cluster_name, host, bound_port, proc.pid, epoch, log_path,
    )
    get_recorder().record(
        "broker_standby_started",
        cluster=cluster_name,
        broker_host=host,
        broker_port=bound_port,
        broker_pid=proc.pid,
        epoch=epoch,
    )
    return host, bound_port, True


class ReplicationStreamer:
    """Ships the primary's replication journal to the warm standby.

    The primary appends every mutation it applies to a flight-recorder
    JSONL journal (``kind: broker_apply``); this streamer tails the file
    and replays each frame into the standby with SYNC.  Pull-based and
    resumable: the streamer resumes from its last shipped seq, the
    standby skips any entry at-or-below the seq it already applied
    (crash-safe at-least-once shipping composes with idempotent replay),
    and epoch fencing at the receiver raises ``BrokerFenced`` when this
    stream belongs to a deposed primary — the split-brain guard.
    """

    def __init__(
        self,
        cluster_name: str,
        root: Path | None = None,
        connect=None,
        clock=time.time,
    ):
        self.cluster_name = cluster_name
        self._root = root
        self._connect = connect  # injectable: () -> standby BrokerConnection
        self._clock = clock
        self.shipped_seq = 0
        self.shipped_total = 0

    def _dial_standby(self):
        if self._connect is not None:
            return self._connect()
        standby = standby_broker_status(self.cluster_name, self._root)
        if standby is None or not standby["alive"]:
            raise BrokerError(
                f"no live standby broker recorded for {self.cluster_name}"
            )
        return BrokerConnection(
            "127.0.0.1",
            int(standby["port"]),
            timeout_s=5.0,
            token=standby.get("token") or "",
        )

    def pending(self) -> list[dict]:
        """Journal entries not yet shipped, oldest first."""
        entries = read_journal(_repl_log_path(self.cluster_name, self._root))
        return [
            e
            for e in entries
            if e.get("kind") == "broker_apply"
            and int(e.get("seq", 0)) > self.shipped_seq
        ]

    def lag_seconds(self) -> float:
        """Age of the oldest journal entry not yet shipped; 0.0 when
        caught up."""
        todo = self.pending()
        if not todo:
            return 0.0
        return max(0.0, self._clock() - float(todo[0].get("ts", 0.0)))

    def _sender_epoch(self) -> int:
        """The recorded primary's current term: entries ship under
        ``max(entry epoch, sender epoch)``.  A promoted primary re-plays
        pre-promotion history to a fresh standby under ITS term (the
        entries' old epochs would be fenced), while a deposed primary's
        process cannot launder its stream — adoption atomically rotates
        the journal file this streamer tails, so the path always names
        the acting primary's history.  0 (entry epochs verbatim) when no
        record exists — the injected-connect test seam."""
        try:
            record = json.loads(
                _record_path(self.cluster_name, self._root).read_text()
            )
            return int(record.get("epoch", 0) or 0)
        except (OSError, ValueError):
            return 0

    def step(self) -> int:
        """Ship every unshipped journal entry to the standby; returns how
        many were shipped.  Raises ``BrokerFenced`` (via sync_entry) when
        the standby has seen a higher epoch — stop streaming, this
        primary is deposed."""
        todo = self.pending()
        if not todo:
            return 0
        sender_epoch = self._sender_epoch()
        conn = self._dial_standby()
        try:
            for e in todo:
                conn.sync_entry(
                    max(int(e["epoch"]), sender_epoch),
                    int(e["seq"]),
                    str(e["frame"]).encode("utf-8"),
                )
                self.shipped_seq = int(e["seq"])
                self.shipped_total += 1
        finally:
            conn.close()
        get_recorder().record(
            "broker_replicate",
            cluster=self.cluster_name,
            shipped=len(todo),
            seq=self.shipped_seq,
            lag_s=round(
                max(0.0, self._clock() - float(todo[-1].get("ts", 0.0))), 6
            ),
        )
        return len(todo)


def broker_replication_status(
    cluster_name: str, root: Path | None = None, clock=time.time
) -> dict | None:
    """Role / epoch / applied-seq for the recorded primary and standby,
    plus replication lag — the ``dlcfn status --broker`` and exporter
    view.  None when no broker is recorded.  Lag is measured from the
    journal: entries the standby has not applied, in count
    (``lag_entries``) and age of the oldest such entry
    (``lag_seconds``).  ``clock`` must match the journal's ``ts`` domain
    (wall clock for the binary's log; a VirtualClock in sims) — lag is
    an age metric against recorded stamps, not a deadline."""
    primary = broker_status(cluster_name, root)
    if primary is None:
        return None

    def probe(record: dict) -> dict:
        out = {
            "host": record["host"],
            "port": int(record["port"]),
            "pid": int(record["pid"]),
            "alive": bool(record.get("alive")),
            "role": record.get("role"),
            "epoch": record.get("epoch"),
            "seq": None,
        }
        if not out["alive"]:
            return out
        try:
            conn = BrokerConnection(
                "127.0.0.1",
                out["port"],
                timeout_s=2.0,
                token=record.get("token") or "",
            )
            try:
                role_name, epoch, seq = conn.role()
            finally:
                conn.close()
            out.update(role=role_name, epoch=epoch, seq=seq)
        except (OSError, BrokerError):
            out["alive"] = False
        return out

    standby = standby_broker_status(cluster_name, root)
    result = {
        "primary": probe(primary),
        "standby": probe(standby) if standby is not None else None,
    }
    pseq = result["primary"]["seq"]
    sseq = (result["standby"] or {}).get("seq")
    if pseq is None or sseq is None:
        result["lag_entries"] = None
        result["lag_seconds"] = None
        return result
    result["lag_entries"] = max(0, pseq - sseq)
    lag_s = 0.0
    if result["lag_entries"]:
        entries = [
            e
            for e in read_journal(_repl_log_path(cluster_name, root))
            if e.get("kind") == "broker_apply"
            and int(e.get("seq", 0)) > sseq
        ]
        if entries:
            lag_s = max(0.0, clock() - float(entries[0].get("ts", 0.0)))
    result["lag_seconds"] = round(lag_s, 6)
    return result


class BrokerLivenessWatcher:
    """Polls the broker's heartbeat table and drives the liveness machine.

    The supervisor-side half of the HEARTBEAT loop: agents beat at the
    broker (obs/heartbeat.py Heartbeater); this watcher dumps the table,
    feeds the ALIVE/SUSPECT/DEAD classifier, and publishes
    ``INSTANCE_TERMINATE`` on the provisioner event bus for each DEAD
    transition — silent death then takes exactly the recovery path a
    backend-reported termination does (elasticity -> RecoveryManager).

    A worker that resumes beating after DEAD is resurrected to ALIVE;
    idempotent controllers (the bus contract) make the duplicate
    terminate harmless if recovery already replaced it.
    """

    def __init__(
        self,
        cluster_name: str,
        group: str,
        bus=None,
        root: Path | None = None,
        config: LivenessConfig | None = None,
        clock=time.monotonic,
        fetch=None,
    ):
        self.cluster_name = cluster_name
        self.group = group
        self.bus = bus
        self._root = root
        self._fetch = fetch  # injectable: () -> {worker: (age_s, count)}
        self._last_counts: dict[str, int] = {}
        self.table = LivenessTable(
            config=config or LivenessConfig(),
            clock=clock,
            on_transition=self._on_transition,
        )

    def _on_transition(self, transition) -> None:
        worker, old, new = transition
        log.warning(
            "worker %s liveness: %s -> %s", worker, old.value, new.value
        )
        if new is WorkerState.DEAD and self.bus is not None:
            from deeplearning_cfn_tpu_torch.provision.events import (
                EventKind,
                LifecycleEvent,
            )

            self.bus.publish(
                LifecycleEvent(
                    kind=EventKind.INSTANCE_TERMINATE,
                    group=self.group,
                    instance_id=worker,
                    detail={"reason": "heartbeat-dead", "source": "liveness"},
                )
            )

    def _dump_heartbeats(self) -> dict[str, tuple[float, int]]:
        if self._fetch is not None:
            return self._fetch()
        status = broker_status(self.cluster_name, self._root)
        if status is None or not status["alive"]:
            return {}
        conn = BrokerConnection(
            "127.0.0.1",
            int(status["port"]),
            timeout_s=5.0,
            token=broker_token(self.cluster_name, self._root) or "",
        )
        try:
            return conn.heartbeats()
        finally:
            conn.close()

    def poll(self) -> list:
        """One fetch + sweep; returns the liveness transitions."""
        for worker, (age_s, count) in self._dump_heartbeats().items():
            self.table.observe(worker, age_s=age_s, count=count)
            # Journal each NEW beat with the observer's clock: paired
            # with the worker's heartbeat_sent event of the same seq,
            # obs/trace_export.py derives sender->observer clock offsets
            # (observed ts - age_s names the send instant on THIS clock).
            if count != self._last_counts.get(worker):
                self._last_counts[worker] = count
                get_recorder().record(
                    "heartbeat_observed",
                    worker=worker,
                    seq=count,
                    age_s=round(float(age_s), 6),
                )
        return self.table.sweep()

    def snapshot(self) -> dict:
        return self.table.snapshot()


def cluster_liveness(
    cluster_name: str,
    root: Path | None = None,
    config: LivenessConfig | None = None,
) -> dict:
    """One-shot per-worker liveness for a recorded cluster broker.

    The ``dlcfn status`` view: dump the broker's heartbeat table, classify
    each worker's silence against ``config``, return the snapshot.  Empty
    when no broker is recorded/alive or nothing has ever beaten.
    """
    watcher = BrokerLivenessWatcher(
        cluster_name, group="", bus=None, root=root, config=config
    )
    watcher.poll()
    return watcher.snapshot()


def _unlink_lock_if_stale(lock: Path) -> None:
    """Remove the ensure_broker spawn lock only when its holder is this
    process or dead.  A teardown racing a live ensure_broker (two CLIs,
    one restarting the broker while the other is mid-spawn) must not
    yank the winner's exclusive-create lock out from under it — that
    would let a THIRD caller spawn a second broker concurrently."""
    try:
        holder = int(lock.read_text().strip() or 0)
    except FileNotFoundError:
        return  # no lock to reap
    except (ValueError, OSError):
        holder = 0  # unreadable/corrupt: reap (verified below)
    if holder and holder != os.getpid():
        try:
            os.kill(holder, 0)
            return  # live holder: the lock is theirs, leave it
        except ProcessLookupError:
            pass
        except PermissionError:
            return  # exists under another user: alive
    # Check-then-unlink is a TOCTOU window: between the dead-holder check
    # and the unlink, a concurrent teardown may reap the same stale lock
    # AND a fresh ensure_broker may exclusive-create a new one — a plain
    # unlink here would delete the new winner's lock.  Same discipline as
    # ensure_broker's reclaim: rename (atomic, wins exactly once; losing
    # the race is fine), verify the renamed file still names the holder
    # we judged stale, restore it if we grabbed a newer lock.  The rename
    # target is pid-unique so two reapers cannot collide on it either.
    stale = lock.with_suffix(f".stale-{os.getpid()}")
    try:
        os.rename(lock, stale)
    except FileNotFoundError:
        return  # a concurrent reaper won; done either way
    except OSError:
        return  # cannot rename (exotic fs): leave the lock for the operator
    try:
        renamed_holder = int(stale.read_text().strip() or 0)
    except (FileNotFoundError, ValueError, OSError):
        renamed_holder = 0
    if renamed_holder != holder:
        # We grabbed a lock newer than the one we observed stale: it
        # belongs to a live ensure_broker — put it back.
        try:
            os.rename(stale, lock)
        except OSError:
            pass
        return
    stale.unlink(missing_ok=True)


def _reap_standby(cluster_name: str, root: Path | None) -> dict | None:
    """Stop and forget the cluster's recorded STANDBY broker, with the
    same pid-identity discipline as the primary teardown (cmdline verify
    on procfs; never signal an unverifiable pid).  None when no standby
    record exists."""
    srec = _standby_record_path(cluster_name, root)
    status = standby_broker_status(cluster_name, root)
    if status is None:
        return None
    pid = int(status["pid"])
    verdict = "stopped"
    if Path("/proc").exists():
        try:
            cmdline = (
                Path(f"/proc/{pid}/cmdline").read_bytes().decode(errors="replace")
            )
        except OSError:
            cmdline = ""
        if "dlcfn-broker" not in cmdline:
            verdict = "stale-record"
    else:
        verdict = "left-running"
    if verdict == "stopped":

        def gone() -> bool:
            try:
                if os.waitpid(pid, os.WNOHANG)[0] == pid:
                    return True
            except ChildProcessError:
                pass
            try:
                os.kill(pid, 0)
                return False
            except ProcessLookupError:
                return True

        try:
            os.kill(pid, signal.SIGTERM)
            for _ in range(50):
                if gone():
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        except PermissionError:
            verdict = "left-running"
    srec.unlink(missing_ok=True)
    srec.with_suffix(".log").unlink(missing_ok=True)
    return {
        "broker": verdict,
        "host": status["host"],
        "port": status["port"],
        "pid": pid,
    }


def teardown_broker(cluster_name: str, root: Path | None = None) -> dict:
    """Stop and forget the cluster's recorded broker — primary, warm
    standby, and replication journal (``delete``'s side of the
    stack-resource contract).  Safe when none exists."""
    rec = _record_path(cluster_name, root)
    standby_result = _reap_standby(cluster_name, root)
    _repl_log_path(cluster_name, root).unlink(missing_ok=True)
    _standby_repl_log_path(cluster_name, root).unlink(missing_ok=True)
    status = broker_status(cluster_name, root)
    if status is None:
        result = {"broker": "none"}
        if standby_result is not None:
            result["standby"] = standby_result
        return result
    pid = int(status["pid"])

    # Never SIGTERM a recycled pid: after a reboot the record survives but
    # the OS may have reassigned the pid to an unrelated same-user
    # process.  On procfs systems (every deployment target: TPU VMs /
    # GCE / the dev containers), verify the pid's cmdline is actually the
    # broker.  Without /proc there is NO safe way to verify a pid's
    # identity — a live port answering PING does not prove the recorded
    # pid is the broker — so never signal: clean the records and report
    # the pid for the operator.
    if Path("/proc").exists():
        try:
            cmdline = (
                Path(f"/proc/{pid}/cmdline").read_bytes().decode(errors="replace")
            )
        except OSError:
            cmdline = ""  # pid gone entirely: nothing to kill
        verdict = "stale-record" if "dlcfn-broker" not in cmdline else None
    else:
        verdict = "left-running"
    if verdict is not None:
        rec.unlink(missing_ok=True)
        rec.with_suffix(".log").unlink(missing_ok=True)
        _unlink_lock_if_stale(rec.with_suffix(".lock"))
        result = {
            "broker": verdict,
            "host": status["host"],
            "port": status["port"],
            "pid": pid,
        }
        if standby_result is not None:
            result["standby"] = standby_result
        return result

    def gone() -> bool:
        # Reap first if the broker is OUR child (ensure_broker ran in this
        # process): a terminated-but-unreaped child still answers kill(0).
        # Cross-process (create in one CLI, delete in another) the broker
        # was adopted and reaped by init, so kill(0) alone is accurate.
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return True
        except ChildProcessError:
            pass  # not our child
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            return True

    stopped = False
    try:
        os.kill(pid, signal.SIGTERM)
        for _ in range(50):
            if gone():
                stopped = True
                break
            time.sleep(0.1)
        if not stopped:
            os.kill(pid, signal.SIGKILL)
            for _ in range(50):
                if gone():
                    break
                time.sleep(0.1)
            stopped = True
    except ProcessLookupError:
        stopped = True  # already gone
    except PermissionError:
        # Someone else's pid (stale record reused by the OS): do not kill.
        stopped = False
    rec.unlink(missing_ok=True)
    rec.with_suffix(".log").unlink(missing_ok=True)
    _unlink_lock_if_stale(rec.with_suffix(".lock"))
    result = {
        "broker": "stopped" if stopped else "left-running",
        "host": status["host"],
        "port": status["port"],
        "pid": pid,
    }
    if standby_result is not None:
        result["standby"] = standby_result
    get_recorder().record("broker_teardown", cluster=cluster_name, **result)
    return result


def ensure_sharded_broker(
    cluster_name: str,
    n_shards: int,
    root: Path | None = None,
    advertise: str | None = None,
    timeout_s: float = 30.0,
    standby: bool = True,
) -> dict:
    """Bring up (or adopt) a sharded broker deployment: ``n_shards``
    independent primary/standby pairs, each owning one consistent-hash
    shard of the queue/KV/heartbeat keyspace (broker_client.shard_for_key).

    Each shard is a full ``ensure_broker`` cluster named
    ``<cluster>.shard<k>`` — its own record, lock, log, replication
    journal, epoch fence — so every single-pair mechanism (promotion,
    fencing, journal rename, auto-re-provision) applies per shard
    unchanged.  All shards share shard 0's AUTH token so a router holds
    one credential.  The shard map is written to ``<cluster>.shards.json``
    and consumed by :func:`sharded_broker_records` /
    ``ShardedBrokerRouter.for_cluster``.  Idempotent: live shards are
    reused, dead ones restarted.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    shards = []
    token: str | None = None
    for k in range(n_shards):
        shard_name = shard_cluster_name(cluster_name, k)
        host, port, started = ensure_broker(
            shard_name,
            root=root,
            advertise=advertise,
            timeout_s=timeout_s,
            reuse_token=token,
            shard=k,
            n_shards=n_shards,
        )
        if token is None:
            token = broker_token(shard_name, root)
        if standby:
            ensure_standby_broker(shard_name, root=root, timeout_s=timeout_s)
        shards.append(
            {"shard": k, "cluster": shard_name, "host": host, "port": port,
             "started": started}
        )
    _write_record(
        _shard_map_path(cluster_name, root),
        {"cluster": cluster_name, "n_shards": n_shards,
         "shards": [s["cluster"] for s in shards]},
    )
    get_recorder().record(
        "broker_sharded_ensure", cluster=cluster_name, n_shards=n_shards,
        started=sum(1 for s in shards if s["started"]),
    )
    return {"cluster": cluster_name, "n_shards": n_shards, "shards": shards}


def sharded_broker_records(
    cluster_name: str, root: Path | None = None
) -> list[dict] | None:
    """Per-shard broker records for a sharded deployment, in ring order —
    the routing table ``ShardedBrokerRouter.for_cluster`` builds its
    per-shard endpoint lists from.  None when no shard map is recorded
    (the cluster is unsharded or torn down).  A shard whose record is
    missing (mid-teardown, crashed before re-ensure) yields
    ``record: None`` — the router refuses to run with a hole in the ring
    rather than silently misrouting its keyspace slice."""
    try:
        shard_map = json.loads(_shard_map_path(cluster_name, root).read_text())
    except (OSError, ValueError):
        return None
    return [
        {"shard": k, "cluster": name, "record": broker_status(name, root)}
        for k, name in enumerate(shard_map.get("shards", []))
    ]


def broker_shard_replication_status(
    cluster_name: str, root: Path | None = None, clock=time.time
) -> dict | None:
    """Replication health for every shard of a sharded deployment — the
    ``dlcfn status --broker`` / exporter view.  None when no shard map is
    recorded.  Each entry is :func:`broker_replication_status` for that
    shard plus a ``degraded`` flag: True when the pair is not a healthy
    replicating primary+standby (missing/dead standby, or nonzero lag) —
    the state the self-healing adoption path exists to make transient,
    never steady-state."""
    try:
        shard_map = json.loads(_shard_map_path(cluster_name, root).read_text())
    except (OSError, ValueError):
        return None
    shards = []
    for k, name in enumerate(shard_map.get("shards", [])):
        status = broker_replication_status(name, root, clock=clock)
        degraded = True
        if status is not None:
            standby = status.get("standby")
            degraded = not (
                status["primary"]["alive"]
                and standby is not None
                and standby.get("alive")
                and not status.get("lag_entries")
            )
        shards.append(
            {"shard": k, "cluster": name, "status": status, "degraded": degraded}
        )
    return {
        "cluster": cluster_name,
        "n_shards": len(shards),
        "shards": shards,
        "degraded_shards": sum(1 for s in shards if s["degraded"]),
    }


def teardown_sharded_broker(
    cluster_name: str, root: Path | None = None
) -> dict:
    """Tear down every shard of a sharded deployment and forget the shard
    map.  Safe when none exists (mirrors :func:`teardown_broker`)."""
    try:
        shard_map = json.loads(_shard_map_path(cluster_name, root).read_text())
    except (OSError, ValueError):
        return {"broker": "none", "shards": []}
    results = [
        {"shard": k, "cluster": name, "result": teardown_broker(name, root)}
        for k, name in enumerate(shard_map.get("shards", []))
    ]
    _shard_map_path(cluster_name, root).unlink(missing_ok=True)
    get_recorder().record(
        "broker_sharded_teardown", cluster=cluster_name, n_shards=len(results)
    )
    return {"cluster": cluster_name, "shards": results}
