"""Serve replicas and the front-end that shields users from their death —
counterpart of ``deeplearning_cfn_tpu/serve/replica.py``.

:class:`ServeReplica` wraps one :class:`ContinuousBatchingEngine` in a
cluster identity: it registers itself in a KV table (``serve/<group>/<name>``,
any object with ``set(key, value)``) and, given a ``connection_factory``,
beats a liveness table through the port's
:class:`~deeplearning_cfn_tpu_torch.obs.heartbeat.Heartbeater`.  The broker
client behind a bare ``broker_host`` is not ported yet and raises.

:class:`ServeFrontEnd` routes requests to the least-loaded replica and
owns the durability contract: every accepted request either completes or
is replayed, verbatim, onto a surviving replica, keeping its original
``arrival_s``.  ``on_instance_loss`` is the elasticity controller's seam.
Greedy decoding is deterministic and placement-independent, so a replayed
request produces the same tokens on the survivor.
"""

from __future__ import annotations

import json
from typing import Callable

from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.serve.engine import (
    Completion,
    ContinuousBatchingEngine,
    ServeAdmissionError,
    ServeRequest,
)
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.serve")

REGISTRY_KEY_FMT = "serve/{group}/{name}"


class ServeReplica:
    """One engine + its cluster identity (registration, liveness)."""

    def __init__(
        self,
        engine: ContinuousBatchingEngine,
        name: str,
        group: str = "serve",
        broker_host: str | None = None,
        broker_port: int = 0,
        heartbeat_interval_s: float | None = None,
        connection_factory: Callable | None = None,
    ):
        self.engine = engine
        self.name = name
        self.group = group
        engine.name = name
        self.heartbeater: Heartbeater | None = None
        if broker_host or connection_factory is not None:
            # The replica's worker_id in the liveness table is
            # group/name, matching training agents' group/index form.
            self.heartbeater = Heartbeater(
                broker_host or "",
                broker_port,
                worker_id=f"{group}/{name}",
                interval_s=heartbeat_interval_s,
                connection_factory=connection_factory,
            )

    def register(self, conn) -> None:
        """Advertise this replica in the broker KV table (any object with
        ``set(key, value)`` — a BrokerConnection in production)."""
        scfg = self.engine.serve_cfg
        conn.set(
            REGISTRY_KEY_FMT.format(group=self.group, name=self.name),
            json.dumps(
                {
                    "name": self.name,
                    "group": self.group,
                    "num_slots": scfg.num_slots,
                    "max_context": scfg.max_context,
                    "prefill_len": scfg.prefill_len,
                },
                sort_keys=True,
            ),
        )
        get_recorder().record(
            "serve_register", replica=self.name, group=self.group
        )

    def beat(self) -> bool:
        """One cooperative liveness beat (False if no heartbeater)."""
        return self.heartbeater.beat_step() if self.heartbeater else False

    # --- engine delegation ----------------------------------------------
    def submit(self, request: ServeRequest, arrival_s: float | None = None) -> None:
        self.engine.submit(request, arrival_s)

    def step(self) -> list[Completion]:
        return self.engine.step()

    def pending(self) -> bool:
        return self.engine.pending()

    @property
    def load(self) -> int:
        return self.engine.active_slots + self.engine.queue_depth


class ServeFrontEnd:
    """Least-loaded router with zero-loss replay across replica death."""

    def __init__(self, replicas: list[ServeReplica]):
        self.replicas: dict[str, ServeReplica] = {r.name: r for r in replicas}
        self.failed: list[str] = []
        self.accepted: dict[str, ServeRequest] = {}
        self.assignment: dict[str, str] = {}  # request_id -> replica name
        self.completions: dict[str, Completion] = {}
        self.replayed: list[str] = []

    # --- routing ---------------------------------------------------------
    def _pick(self) -> ServeReplica:
        if not self.replicas:
            raise ServeAdmissionError("no live replicas")
        # Deterministic: least loaded, name as tiebreak.
        return min(self.replicas.values(), key=lambda r: (r.load, r.name))

    def submit(self, request: ServeRequest, arrival_s: float | None = None) -> str:
        """Route to a replica; returns the replica name.  Raising
        ServeAdmissionError means NOT accepted (no durability debt)."""
        replica = self._pick()
        replica.submit(request, arrival_s)
        self.accepted[request.request_id] = request
        self.assignment[request.request_id] = replica.name
        return replica.name

    def step_all(self) -> list[Completion]:
        """One scheduler step on every live replica; gathers completions."""
        done: list[Completion] = []
        for name in sorted(self.replicas):
            for c in self.replicas[name].step():
                self.completions[c.request_id] = c
                done.append(c)
        return done

    def pending(self) -> bool:
        return any(r.engine.pending() for r in self.replicas.values())

    # --- failure handling ------------------------------------------------
    def fail_replica(self, name: str) -> int:
        """Kill a replica and replay its in-flight requests (original
        arrival times kept) onto the survivors.  Returns replay count."""
        replica = self.replicas.pop(name, None)
        if replica is None:
            return 0
        self.failed.append(name)
        orphans = replica.engine.inflight_requests()
        for req in orphans:
            fresh = ServeRequest(
                request_id=req.request_id,
                prompt=req.prompt,
                max_new_tokens=req.max_new_tokens,
                arrival_s=req.arrival_s,
            )
            survivor = self._pick()
            survivor.submit(fresh, arrival_s=req.arrival_s)
            self.assignment[req.request_id] = survivor.name
            self.replayed.append(req.request_id)
        get_recorder().record(
            "serve_failover",
            replica=name,
            replayed=len(orphans),
            survivors=sorted(self.replicas),
        )
        log.warning(
            "replica %s failed; replayed %d in-flight request(s) onto %s",
            name,
            len(orphans),
            sorted(self.replicas),
        )
        return len(orphans)

    # --- pool resize (scheduler seam) -----------------------------------
    def add_replica(self, replica: ServeReplica) -> None:
        """Grow the pool: a lent slice's replica joins the router.  The
        fleet arbiter (sched/preempt.py) calls this when a preempted
        train slice is lent to the serve pool during a flash crowd."""
        if replica.name in self.replicas:
            raise ValueError(f"replica {replica.name} already in pool")
        self.replicas[replica.name] = replica
        get_recorder().record(
            "serve_pool_resize",
            action="add",
            replica=replica.name,
            pool=sorted(self.replicas),
        )
        log.info("replica %s joined pool (%s)", replica.name, sorted(self.replicas))

    def retire_replica(self, name: str, force: bool = False) -> ServeReplica | None:
        """Shrink the pool: remove ``name`` gracefully.  Unlike
        ``fail_replica`` the replica is healthy — by default retirement
        is refused (returns None) while it still holds in-flight work;
        with ``force`` the in-flight requests are replayed onto the
        survivors first (same durability contract as failover), which is
        what the arbiter uses to reclaim a lent slice off-peak."""
        replica = self.replicas.get(name)
        if replica is None:
            return None
        orphans = replica.engine.inflight_requests()
        if orphans and not force:
            return None
        del self.replicas[name]
        for req in orphans:
            fresh = ServeRequest(
                request_id=req.request_id,
                prompt=req.prompt,
                max_new_tokens=req.max_new_tokens,
                arrival_s=req.arrival_s,
            )
            survivor = self._pick()
            survivor.submit(fresh, arrival_s=req.arrival_s)
            self.assignment[req.request_id] = survivor.name
            self.replayed.append(req.request_id)
        get_recorder().record(
            "serve_pool_resize",
            action="retire",
            replica=name,
            replayed=len(orphans),
            pool=sorted(self.replicas),
        )
        log.info(
            "replica %s retired (replayed %d); pool now %s",
            name,
            len(orphans),
            sorted(self.replicas),
        )
        return replica

    def on_instance_loss(self, policy, event) -> None:
        """ElasticityController ``on_instance_loss`` seam adapter: an
        ``INSTANCE_TERMINATE`` for ``serve/<name>`` fails that replica."""
        instance = event.instance_id or ""
        name = instance.split("/", 1)[1] if "/" in instance else instance
        if name in self.replicas:
            self.fail_replica(name)

    def lost_requests(self) -> list[str]:
        """Accepted requests neither completed nor resident on a live
        replica — MUST be empty; the chaos scenario asserts it."""
        resident: set[str] = set()
        for r in self.replicas.values():
            resident.update(req.request_id for req in r.engine.inflight_requests())
        return sorted(
            rid
            for rid in self.accepted
            if rid not in self.completions and rid not in resident
        )
