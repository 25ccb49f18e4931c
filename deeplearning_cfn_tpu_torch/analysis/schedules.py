"""Deterministic interleaving harness for the heartbeat/liveness plane —
counterpart of ``deeplearning_cfn_tpu/analysis/schedules.py`` (no torch:
everything here is the control plane on virtual time).

The threaded choreography — Heartbeater beats, BrokerLivenessWatcher
polls, LivenessTable classifies, the bus publishes INSTANCE_TERMINATE,
recovery replaces — is claimed safe.  This harness *confirms* it
dynamically: a virtual clock plus a cooperative step scheduler run the
REAL components (no forked logic, no real threads, no sleeps) through
permuted schedules, including the silent-death path, and check ground
truth at every transition:

* a worker is only classified DEAD when its virtual silence really
  exceeded ``dead_after_s`` (no false terminations under any ordering);
* a DEAD classification always publishes exactly one INSTANCE_TERMINATE
  until the worker is recovered;
* every schedule runs to completion (single-threaded cooperative steps
  cannot deadlock; a wedged invariant still fails loudly).

Beside it sit the simulated brokers the chaos scenarios fail over: the
replicated pair (:class:`ReplicatedSimBroker`, epoch fencing, the
re-provisioned standby), the consistent-hash ring of pairs
(:class:`ShardedSimBroker`), their failover clients, and the soaks
(:func:`soak_failover`, :func:`soak_fleet`).  The serving plane's load
generator measures latency on :class:`VirtualClock`, and
:func:`interleavings` gives the seeded event orders the debounce tests and
the scenarios replay.  Everything is seeded and wall-clock free, so a
failing schedule is replayable byte-for-byte.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig, WorkerState


class VirtualClock:
    """Monotonic virtual time: only :meth:`advance` moves it.  Callable so
    it drops into every ``clock=`` seam."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    __call__ = now

    def advance(self, dt_s: float) -> float:
        if dt_s < 0:
            raise ValueError(f"virtual time cannot go backwards: {dt_s}")
        self._now += dt_s
        return self._now


class SimBroker:
    """The C++ broker's heartbeat table on virtual time: record() is the
    HEARTBEAT <worker> verb, dump() the table-dump mode (worker ->
    (age_s, count)), exactly the shape ``BrokerLivenessWatcher``'s
    ``fetch`` seam consumes."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._beats: dict[str, tuple[float, int]] = {}
        self._telem: dict[str, tuple[float, int, bytes]] = {}

    def record(self, worker: str) -> int:
        last, count = self._beats.get(worker, (0.0, 0))
        self._beats[worker] = (self._clock.now(), count + 1)
        return count + 1

    def record_telem(self, worker: str, payload: bytes) -> int:
        """The TELEM <worker> verb: last-write-wins snapshot + count."""
        _last, count, _old = self._telem.get(worker, (0.0, 0, b""))
        self._telem[worker] = (self._clock.now(), count + 1, payload)
        return count + 1

    def dump(self) -> dict[str, tuple[float, int]]:
        now = self._clock.now()
        return {
            worker: (now - last, count)
            for worker, (last, count) in self._beats.items()
        }

    def dump_telem(self) -> dict[str, tuple[float, int, bytes]]:
        """The TELEM dump mode: worker -> (age_s, count, snapshot)."""
        now = self._clock.now()
        return {
            worker: (now - last, count, payload)
            for worker, (last, count, payload) in self._telem.items()
        }

    def silence_s(self, worker: str) -> float | None:
        """Ground truth: virtual seconds since the worker's last beat."""
        if worker not in self._beats:
            return None
        return self._clock.now() - self._beats[worker][0]


class SimBrokerError(ConnectionError):
    """Injected connection failure (a broker restart mid-beat)."""


class SimBrokerConnection:
    """Duck-types the BrokerConnection surface Heartbeater uses
    (heartbeat + close).  ``fail_beats`` makes the next N beats raise, so
    schedules exercise the real reconnect path in Heartbeater.beat_step.
    ``fail_when`` is the partition predicate: while it returns True every
    beat raises (and so does every beat on a freshly redialed connection
    built with the same predicate), which models a network cut rather
    than a one-shot connection loss."""

    def __init__(
        self,
        broker: SimBroker,
        fail_beats: int = 0,
        fail_when: Callable[[], bool] | None = None,
    ):
        self._broker = broker
        self._fail_beats = fail_beats
        self._fail_when = fail_when
        self.closed = False

    def heartbeat(self, worker_id: str) -> int:
        if self.closed:
            raise SimBrokerError("connection is closed")
        if self._fail_when is not None and self._fail_when():
            raise SimBrokerError("network partition")
        if self._fail_beats > 0:
            self._fail_beats -= 1
            raise SimBrokerError("injected beat failure")
        return self._broker.record(worker_id)

    def telem(self, worker_id: str, snapshot: bytes) -> int:
        if self.closed:
            raise SimBrokerError("connection is closed")
        if self._fail_when is not None and self._fail_when():
            raise SimBrokerError("network partition")
        return self._broker.record_telem(worker_id, snapshot)

    def close(self) -> None:
        self.closed = True


@dataclass
class StepScheduler:
    """Cooperative scheduler: actors are named step functions; a schedule
    is an explicit sequence of actor names, executed synchronously in
    order.  No threads, no preemption — the *schedule* is the
    interleaving."""

    actors: dict[str, Callable[[], Any]] = field(default_factory=dict)
    trace: list[str] = field(default_factory=list)

    def add(self, name: str, step: Callable[[], Any]) -> None:
        if name in self.actors:
            raise ValueError(f"duplicate actor {name!r}")
        self.actors[name] = step

    def run(self, schedule: Iterable[str]) -> list[str]:
        for name in schedule:
            self.actors[name]()  # unknown actor -> KeyError, loudly
            self.trace.append(name)
        return self.trace


def interleavings(
    actions: Sequence[str],
    count: int,
    seed: int = 0,
) -> list[tuple[str, ...]]:
    """``count`` distinct seeded shuffles of ``actions``.  Deterministic:
    the same (actions, count, seed) always yields the same schedules, so
    a failure names its schedule reproducibly."""
    rng = random.Random(seed)
    seen: set[tuple[str, ...]] = set()
    out: list[tuple[str, ...]] = []
    attempts = 0
    limit = count * 1000
    while len(out) < count:
        attempts += 1
        if attempts > limit:
            raise RuntimeError(
                f"could not generate {count} distinct schedules from "
                f"{len(actions)} actions (got {len(out)})"
            )
        shuffled = list(actions)
        rng.shuffle(shuffled)
        candidate = tuple(shuffled)
        if candidate not in seen:
            seen.add(candidate)
            out.append(candidate)
    return out


class InvariantViolation(AssertionError):
    """A liveness classification contradicted virtual-clock ground truth."""


class HeartbeatChoreography:
    """The full heartbeat-death -> recovery loop wired from REAL parts over
    virtual time: real ``Heartbeater`` instances (driven cooperatively via
    ``beat_step()``, never started as threads) beat at a :class:`SimBroker`;
    a real ``BrokerLivenessWatcher`` polls it through the ``fetch`` seam
    into the real ``LivenessTable``; DEAD transitions publish
    INSTANCE_TERMINATE on a real ``EventBus``; the recover step replaces
    terminated workers with fresh heartbeaters, as RecoveryManager would.

    Step vocabulary (for :class:`StepScheduler` schedules):

    * ``beat:<worker>``  one heartbeat from that worker (no-op once killed)
    * ``tick``           advance the virtual clock by ``tick_s``
    * ``poll``           watcher fetch + sweep, with ground-truth checks
    * ``kill:<worker>``  the worker dies silently (stops beating)
    * ``cut:<worker>``   network partition: its beats fail until healed
    * ``heal:<worker>``  the partition heals; its beats land again
    * ``recover``        replace every terminated-but-unrecovered worker

    Every ``poll`` validates transitions against the broker's own virtual
    timeline, so no schedule can smuggle in a false DEAD or a missed one.
    """

    def __init__(
        self,
        workers: Sequence[str],
        config: LivenessConfig | None = None,
        tick_s: float = 5.0,
        fail_first_beats: int = 0,
    ):
        from deeplearning_cfn_tpu_torch.cluster.broker_service import (
            BrokerLivenessWatcher,
        )
        from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
        from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind

        self.clock = VirtualClock()
        self.broker = SimBroker(self.clock)
        self.config = config or LivenessConfig()
        self.tick_s = tick_s
        self.bus = EventBus()
        self.terminated: list[tuple[Any, float | None]] = []
        self._verified = 0
        self._terminate_kind = EventKind.INSTANCE_TERMINATE
        self.bus.subscribe(self._on_event)
        self.watcher = BrokerLivenessWatcher(
            cluster_name="sim",
            group="workers",
            bus=self.bus,
            config=self.config,
            clock=self.clock,
            fetch=self.broker.dump,
        )
        # A one-shot failure budget: only the FIRST dial gets the failing
        # connection, so Heartbeater's drop-and-redial recovery actually
        # lands a beat afterwards (a per-connection budget would fail
        # every redial forever).
        self._fail_budget = max(0, fail_first_beats)
        # Workers currently on the wrong side of a network cut: their
        # beats (on live AND freshly redialed connections) raise until a
        # heal step removes them.
        self.partitioned: set[str] = set()
        self._mk_heartbeater = lambda worker: Heartbeater(
            host="sim",
            port=0,
            worker_id=worker,
            interval_s=tick_s,
            connection_factory=lambda w=worker: self._dial_sim(w),
        )
        self.heartbeaters = {w: self._mk_heartbeater(w) for w in workers}
        self.alive: set[str] = set(workers)
        self.recovered: dict[str, str] = {}  # dead worker -> replacement

    def _dial_sim(self, worker: str | None = None) -> SimBrokerConnection:
        fails, self._fail_budget = self._fail_budget, 0
        return SimBrokerConnection(
            self.broker,
            fail_beats=fails,
            fail_when=(
                (lambda: worker in self.partitioned)
                if worker is not None
                else None
            ),
        )

    # --- bus + truth checking -------------------------------------------
    def _on_event(self, event: Any) -> None:
        # Never raise here: EventBus isolates handler exceptions by
        # contract, which would swallow the invariant.  Capture the
        # ground-truth silence at publish time; poll verifies it.
        if event.kind is self._terminate_kind:
            self.terminated.append(
                (event, self.broker.silence_s(event.instance_id))
            )

    def _check_terminates(self) -> None:
        while self._verified < len(self.terminated):
            event, silence = self.terminated[self._verified]
            self._verified += 1
            if silence is None or silence < self.config.dead_after_s:
                raise InvariantViolation(
                    f"INSTANCE_TERMINATE for {event.instance_id} at "
                    f"virtual silence {silence}; dead_after_s="
                    f"{self.config.dead_after_s}"
                )

    def _check_transitions(self, transitions: Iterable[Any]) -> None:
        for worker, _old, new in transitions:
            silence = self.broker.silence_s(worker)
            if silence is None:
                continue
            if new is WorkerState.DEAD and silence < self.config.dead_after_s:
                raise InvariantViolation(
                    f"{worker} marked DEAD at silence {silence:.1f}s "
                    f"< dead_after {self.config.dead_after_s}s"
                )
            if new is WorkerState.SUSPECT and (
                silence < self.config.suspect_after_s
            ):
                raise InvariantViolation(
                    f"{worker} marked SUSPECT at silence {silence:.1f}s "
                    f"< suspect_after {self.config.suspect_after_s}s"
                )
            if new is WorkerState.ALIVE and silence >= self.config.dead_after_s:
                raise InvariantViolation(
                    f"{worker} marked ALIVE at silence {silence:.1f}s "
                    f">= dead_after {self.config.dead_after_s}s"
                )

    # --- the step vocabulary --------------------------------------------
    def step(self, action: str) -> None:
        name, _, arg = action.partition(":")
        if name == "beat":
            if arg in self.alive:
                self.heartbeaters[arg].beat_step()
        elif name == "tick":
            self.clock.advance(self.tick_s)
        elif name == "poll":
            self._check_transitions(self.watcher.poll())
            self._check_terminates()
        elif name == "kill":
            self.alive.discard(arg)
        elif name == "cut":
            # Network partition: the worker keeps trying to beat (stays in
            # alive) but every beat fails until healed.
            self.partitioned.add(arg)
        elif name == "heal":
            self.partitioned.discard(arg)
        elif name == "recover":
            for event, _silence in list(self.terminated):
                dead = event.instance_id
                if dead in self.recovered:
                    continue  # duplicate terminate: recovery is idempotent
                replacement = f"{dead}+1"
                self.recovered[dead] = replacement
                self.heartbeaters[replacement] = self._mk_heartbeater(
                    replacement
                )
                self.alive.add(replacement)
                self.heartbeaters[replacement].beat_step()
        else:
            raise ValueError(f"unknown step {action!r}")

    def run(self, schedule: Iterable[str]) -> "HeartbeatChoreography":
        scheduler = StepScheduler()
        executed = list(schedule)
        for action in dict.fromkeys(executed):
            scheduler.add(action, lambda a=action: self.step(a))
        scheduler.run(executed)
        if len(scheduler.trace) != len(executed):
            raise InvariantViolation("schedule did not run to completion")
        return self

    # --- end-state assertions -------------------------------------------
    def states(self) -> dict[str, str]:
        return {
            worker: info["state"]
            for worker, info in self.watcher.snapshot().items()
        }

    def terminated_workers(self) -> list[str]:
        return [event.instance_id for event, _silence in self.terminated]


# --- replicated control plane on virtual time --------------------------------


class SimNotPrimary(SimBrokerError):
    """Write rejected by a standby or deposed node ("ERR not primary")."""


class SimFenced(SimBrokerError):
    """Replication entry rejected by epoch fencing ("ERR fenced")."""


class SimBrokerNode(SimBroker):
    """One virtual broker process: :class:`SimBroker`'s heartbeat table
    plus the replicated queue/KV state, a role, an epoch, and — while
    primary — a journal of applied frames (the sim twin of the C++
    broker's ``DLCFN_BROKER_REPL_LOG`` stream).  Mutations mirror the
    wire contract: they raise :class:`SimNotPrimary` on a non-primary
    and plain :class:`SimBrokerError` once the process is killed; reads
    stay open on a live standby.

    One deliberate divergence from the binary: replayed HEARTBEAT frames
    carry the ORIGINAL beat timestamp instead of being restamped at
    apply time.  The real pair restamps because two hosts' clocks are
    not comparable; the sim shares one virtual clock, so carrying the
    send instant keeps silence ground truth exact across a failover.
    """

    def __init__(
        self,
        clock: VirtualClock,
        name: str = "broker-a",
        role: str = "primary",
        epoch: int = 0,
    ):
        super().__init__(clock)
        self.name = name
        self.role = role
        self.epoch = epoch
        self.up = True
        self.journal: list[dict] = []  # [{"seq","epoch","ts","frame"}]
        self.seq = 0  # last seq journaled as primary
        self.sync_seq = 0  # last seq applied as standby
        self.fenced = 0  # stale-epoch SYNC rejections
        self.queues: dict[str, list[tuple[str, bytes]]] = {}
        self.applied: dict[str, set[str]] = {}  # queue -> idempotency keys
        self.kv: dict[str, bytes] = {}

    # -- role / liveness gates -------------------------------------------
    def _gate_write(self) -> None:
        if not self.up:
            raise SimBrokerError("closed connection")
        if self.role != "primary":
            raise SimNotPrimary("not primary")

    def _journal_frame(self, frame: dict) -> None:
        self.seq += 1
        self.journal.append(
            {
                "seq": self.seq,
                "epoch": self.epoch,
                "ts": self._clock.now(),
                "frame": frame,
            }
        )

    # -- client verbs (mutating: primary only) ---------------------------
    def record(self, worker: str) -> int:
        self._gate_write()
        count = super().record(worker)
        self._journal_frame(
            {
                "verb": "HEARTBEAT",
                "worker": worker,
                "ts": self._beats[worker][0],
                "count": count,
            }
        )
        return count

    def record_telem(self, worker: str, payload: bytes) -> int:
        self._gate_write()
        count = super().record_telem(worker, payload)
        self._journal_frame(
            {
                "verb": "TELEM",
                "worker": worker,
                "ts": self._telem[worker][0],
                "count": count,
                "payload": payload,
            }
        )
        return count

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        self._gate_write()
        if self._apply_send(queue, body, rid):
            # Journaled only when actually applied — a deduped re-send
            # must not inflate the replication stream (matches the
            # binary's applied-gated repl_append).
            self._journal_frame(
                {"verb": "SENDID", "queue": queue, "rid": rid, "body": body}
            )
        return rid

    def set(self, key: str, value: bytes) -> None:
        self._gate_write()
        self.kv[key] = value
        self._journal_frame({"verb": "SET", "key": key, "value": value})

    # -- reads (open on any live node) -----------------------------------
    def dump(self) -> dict[str, tuple[float, int]]:
        if not self.up:
            raise SimBrokerError("closed connection")
        return super().dump()

    def dump_telem(self) -> dict[str, tuple[float, int, bytes]]:
        if not self.up:
            raise SimBrokerError("closed connection")
        return super().dump_telem()

    def depth(self, queue: str) -> int:
        if not self.up:
            raise SimBrokerError("closed connection")
        return len(self.queues.get(queue, ()))

    # -- replication (standby side) --------------------------------------
    def _apply_send(self, queue: str, body: bytes, rid: str) -> bool:
        seen = self.applied.setdefault(queue, set())
        if rid in seen:
            return False
        seen.add(rid)
        self.queues.setdefault(queue, []).append((rid, body))
        return True

    def _apply_frame(self, frame: dict) -> None:
        verb = frame["verb"]
        if verb == "SENDID":
            self._apply_send(frame["queue"], frame["body"], frame["rid"])
        elif verb == "SET":
            self.kv[frame["key"]] = frame["value"]
        elif verb == "HEARTBEAT":
            self._beats[frame["worker"]] = (frame["ts"], frame["count"])
        elif verb == "TELEM":
            self._telem[frame["worker"]] = (
                frame["ts"],
                frame["count"],
                frame["payload"],
            )
        else:
            raise ValueError(f"unknown replication verb {verb!r}")

    def sync(self, epoch: int, seq: int, frame: dict) -> int:
        """Apply one replicated journal entry (the SYNC verb).  Epoch
        fencing first: a stale term is rejected and counted; a HIGHER
        term demotes this node if it thought itself primary (the deposed
        half of a split brain learns it lost).  Then seq dedup: entries
        at-or-below the applied watermark are skipped, so at-least-once
        shipping never double-applies."""
        if not self.up:
            raise SimBrokerError("closed connection")
        if epoch < self.epoch or (epoch == self.epoch and self.role == "primary"):
            self.fenced += 1
            raise SimFenced(
                f"fenced: epoch {epoch} is stale at {self.name} "
                f"(epoch {self.epoch}, role {self.role})"
            )
        if epoch > self.epoch:
            self.epoch = epoch
            self.role = "standby"
        if seq > self.sync_seq:
            self._apply_frame(frame)
            self.sync_seq = seq
            # Journal the replicated entry at its INCOMING seq/epoch: the
            # standby keeps a complete copy of the history it applied, so
            # after ITS promotion it can re-provision a fresh standby and
            # resume replication from its own journal (the self-healing
            # half of the pair).  Seq-faithful, so a re-ship of the same
            # history dedups exactly like the original stream.
            self.journal.append(
                {
                    "seq": seq,
                    "epoch": epoch,
                    "ts": self._clock.now(),
                    "frame": frame,
                }
            )
        return seq

    def promote(self, epoch: int) -> int:
        """Fence to a strictly-higher epoch and take over as primary;
        the journal seq resumes from the replication watermark so the
        new term's entries extend (never collide with) the applied
        history."""
        if not self.up:
            raise SimBrokerError("closed connection")
        if epoch <= self.epoch:
            raise SimBrokerError(
                f"stale epoch {epoch} (current {self.epoch})"
            )
        self.epoch = epoch
        self.role = "primary"
        self.seq = max(self.seq, self.sync_seq)
        return epoch


class ReplicatedSimBroker:
    """A primary + warm-standby broker pair on virtual time.

    ``stream()`` plays :class:`ReplicationStreamer`: it ships journal
    entries the standby has not applied (``max_entries`` models a
    streamer that had not caught up when the primary died — the
    unshipped tail is what a warm standby genuinely loses).
    ``kill_primary()`` is the process dying; ``promote_standby()`` is
    the ``_adopt_standby`` ladder (fence to ``max(epochs) + 1``).  For
    split-brain schedules the primary is NOT killed: it keeps accepting
    writes on its side of the partition, and its post-promotion
    ``stream()`` attempts must all raise :class:`SimFenced` at the new
    primary, with ``demote()`` modelling the deposed node standing down
    once fenced."""

    def __init__(
        self,
        clock: VirtualClock,
        primary_name: str = "broker-a",
        standby_name: str = "broker-b",
    ):
        self.clock = clock
        self.primary = SimBrokerNode(clock, primary_name, role="primary")
        self.standby = SimBrokerNode(clock, standby_name, role="standby")
        self.reprovisions = 0  # fresh standbys spawned by auto-heal

    def nodes(self) -> list[SimBrokerNode]:
        return [self.primary, self.standby]

    def active(self) -> SimBrokerNode | None:
        """The live node currently claiming primary, if any."""
        for node in self.nodes():
            if node.up and node.role == "primary":
                return node
        return None

    def active_dump(self) -> dict[str, tuple[float, int]]:
        """The heartbeat table a liveness watcher would fetch: from the
        live primary, or empty while no node serves (broker outage)."""
        node = self.active()
        return node.dump() if node is not None else {}

    def active_dump_telem(self) -> dict[str, tuple[float, int, bytes]]:
        """The telemetry table a fleet aggregator would fetch: from the
        live primary, or empty while no node serves (broker outage)."""
        node = self.active()
        return node.dump_telem() if node is not None else {}

    def pending(self, src: SimBrokerNode | None = None) -> list[dict]:
        """Journal entries the standby has not applied, oldest first."""
        src = src or self.primary
        return [e for e in src.journal if e["seq"] > self.standby.sync_seq]

    def stream(
        self,
        src: SimBrokerNode | None = None,
        dst: SimBrokerNode | None = None,
        max_entries: int | None = None,
    ) -> int:
        """Ship unapplied journal entries ``src`` -> ``dst``; returns the
        count.  Raises :class:`SimFenced` the moment the receiver fences
        the stream (a deposed primary learns about its deposition here)."""
        src = src or self.primary
        dst = dst or self.standby
        if not src.up:
            raise SimBrokerError(f"{src.name} is down")
        todo = [e for e in src.journal if e["seq"] > dst.sync_seq]
        if max_entries is not None:
            todo = todo[:max_entries]
        for entry in todo:
            # Ship under the SENDER's current term (never below the
            # entry's own): a promoted primary re-replays old-term
            # history to a fresh standby under its new epoch, while a
            # deposed primary's stream still carries its stale epoch and
            # fences.  SYNC's epoch names the stream's term, not the
            # entry's origin.
            dst.sync(
                max(int(entry["epoch"]), src.epoch),
                entry["seq"],
                entry["frame"],
            )
        return len(todo)

    def kill_primary(self) -> None:
        self.primary.up = False

    def promote_standby(self) -> int:
        epoch = max(self.primary.epoch, self.standby.epoch) + 1
        return self.standby.promote(epoch)

    def reprovision_standby(self, name: str | None = None) -> SimBrokerNode:
        """Auto-heal after a failover: the acting primary spawns a FRESH
        standby at its own epoch and replays its full journal into it —
        the sim twin of ``_adopt_standby``'s re-provision step.  The
        deposed node is never reused; ``primary``/``standby`` are
        re-pointed so the pair is whole again (``pending()`` == 0 once
        the replay completes, which this method runs to the end)."""
        acting = self.active()
        if acting is None:
            raise SimBrokerError("no live primary to re-provision from")
        fresh = SimBrokerNode(
            self.clock,
            name or f"{acting.name}+standby{self.reprovisions}",
            role="standby",
            epoch=acting.epoch,
        )
        self.primary = acting
        self.standby = fresh
        self.reprovisions += 1
        self.stream()  # resume replication from the promoted journal
        return fresh

    def demote(self, node: SimBrokerNode) -> None:
        """A fenced ex-primary stands down (what the real deposed broker
        does on seeing a higher-epoch SYNC or BrokerFenced)."""
        node.role = "standby"
        node.epoch = max(n.epoch for n in self.nodes())


class FailoverSimConnection:
    """Duck-types the BrokerConnection surface agents use (heartbeat,
    send_idempotent, close) with ``FailoverBrokerConnection``'s
    walk-the-endpoint-list behavior: a dead node or a standby's
    "not primary" rejection advances to the next endpoint; success on a
    later endpoint IS the failover.  ``fail_when`` cuts this client off
    from every endpoint (its side of a partition)."""

    def __init__(
        self,
        nodes: Sequence[SimBrokerNode] | None = None,
        fail_when: Callable[[], bool] | None = None,
        nodes_source: Callable[[], Sequence[SimBrokerNode]] | None = None,
    ):
        if nodes is None and nodes_source is None:
            raise ValueError("need nodes or nodes_source")
        self._nodes = list(nodes) if nodes is not None else []
        self._nodes_source = nodes_source
        self._fail_when = fail_when
        self.closed = False
        self.failovers = 0

    def _call(self, op: Callable[[SimBrokerNode], Any]) -> Any:
        if self.closed:
            raise SimBrokerError("connection is closed")
        if self._fail_when is not None and self._fail_when():
            raise SimBrokerError("network partition")
        if self._nodes_source is not None:
            # Re-read the endpoint list each call — the sim twin of
            # FailoverBrokerConnection's endpoints_source refresh: a
            # client started before a failover finds the fresh
            # auto-re-provisioned standby without a restart.
            self._nodes = list(self._nodes_source())
        last: Exception | None = None
        for i, node in enumerate(self._nodes):
            try:
                result = op(node)
            except SimBrokerError as exc:
                last = exc
                continue
            if i > 0:
                self.failovers += 1
            return result
        raise SimBrokerError(f"no broker endpoint available: {last}")

    def heartbeat(self, worker_id: str) -> int:
        return self._call(lambda node: node.record(worker_id))

    def telem(self, worker_id: str, snapshot: bytes) -> int:
        return self._call(lambda node: node.record_telem(worker_id, snapshot))

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        return self._call(lambda node: node.send_idempotent(queue, body, rid))

    def close(self) -> None:
        self.closed = True


def soak_failover(
    agents: int = 1000,
    seed: int = 0,
    kill_count: int = 50,
    senders: int = 100,
    unshipped_tail: int = 37,
    tick_s: float = 5.0,
    config: LivenessConfig | None = None,
) -> dict:
    """1,000-agent (by default) broker-failover soak on virtual time.

    Real ``Heartbeater`` instances beat through failover connections at a
    :class:`ReplicatedSimBroker`; a real ``BrokerLivenessWatcher``
    classifies silence from whichever node is primary.  A seeded subset
    of agents dies silently; then the PRIMARY dies mid-round with
    ``unshipped_tail`` journal entries never shipped; the standby is
    promoted; traffic resumes through the failover path.  Meanwhile
    ``senders`` agents each submit one idempotent request before the
    kill and blindly RE-SEND the same request id after promotion (the
    client cannot know whether its frame was replicated), so exactly-once
    effects must come from idempotency keys honored by replay.

    Returns structural facts only — no wall-clock, no paths — so chaos
    reports and perf-smoke stages built on it are byte-deterministic per
    seed:  ``lost_terminates`` / ``spurious_terminates`` /
    ``duplicate_terminates`` / ``premature_terminates`` must all be 0,
    ``duplicate_sends`` must be 0 with ``work_depth == senders``, and
    ``fenced_writes`` stays 0 (no split brain in this scenario).
    """
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        BrokerLivenessWatcher,
    )
    from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind

    rng = random.Random(seed)
    clock = VirtualClock()
    cluster = ReplicatedSimBroker(clock)
    cfg = config or LivenessConfig()
    bus = EventBus()
    terminated: list[tuple[str, float | None]] = []

    def on_event(event: Any) -> None:
        if event.kind is EventKind.INSTANCE_TERMINATE:
            node = cluster.active() or cluster.standby
            terminated.append(
                (event.instance_id, node.silence_s(event.instance_id))
            )

    bus.subscribe(on_event)
    watcher = BrokerLivenessWatcher(
        cluster_name="sim-failover",
        group="agents",
        bus=bus,
        config=cfg,
        clock=clock,
        fetch=cluster.active_dump,
    )

    names = [f"agent-{i:04d}" for i in range(agents)]
    killed = set(rng.sample(names, kill_count))
    live = [w for w in names if w not in killed]
    sender_names = rng.sample(live, senders)
    beaters = {
        w: Heartbeater(
            host="sim",
            port=0,
            worker_id=w,
            interval_s=tick_s,
            connection_factory=lambda: FailoverSimConnection(cluster.nodes()),
        )
        for w in names
    }
    alive = set(names)

    def round_(stream: bool = True) -> None:
        for w in names:
            if w in alive:
                beaters[w].beat_step()
        if stream and cluster.active() is cluster.primary:
            cluster.stream()
        clock.advance(tick_s)
        watcher.poll()

    # Warmup: everyone beating, replication caught up.
    for _ in range(3):
        round_()
    # A seeded subset dies silently, mid-traffic.
    alive -= killed
    for _ in range(2):
        round_()

    # The kill round: beats + idempotent submissions land on the primary,
    # which then dies with the journal tail unshipped.
    for w in names:
        if w in alive:
            beaters[w].beat_step()
    rids = {w: f"{w}/job-{seed}" for w in sender_names}
    for w in sender_names:
        cluster.primary.send_idempotent(
            "work", f"payload-{w}".encode(), rids[w]
        )
    backlog = len(cluster.pending())
    cluster.stream(max_entries=max(0, backlog - unshipped_tail))
    lag_at_kill = len(cluster.pending())
    cluster.kill_primary()
    clock.advance(tick_s)
    watcher.poll()  # broker outage: fetch is empty, nobody terminates early

    # Promotion ladder: standby fenced to a strictly-higher epoch.
    epoch = cluster.promote_standby()

    # At-least-once across the switch: every sender blindly re-sends its
    # request id through the failover path; replayed rids dedup, the
    # unshipped tail lands exactly once.
    resend = FailoverSimConnection(cluster.nodes())
    for w in sender_names:
        resend.send_idempotent("work", f"payload-{w}".encode(), rids[w])
    resend.close()

    # Drain: silence of the killed agents crosses dead_after_s on the NEW
    # primary's replicated heartbeat table.
    drain_rounds = int(cfg.dead_after_s // tick_s) + 3
    for _ in range(drain_rounds):
        round_(stream=False)

    new_primary = cluster.standby
    work = new_primary.queues.get("work", [])
    rid_list = [rid for rid, _body in work]
    term_names = [w for w, _s in terminated]
    return {
        "agents": agents,
        "killed": len(killed),
        "terminated": len(term_names),
        "lost_terminates": len(killed - set(term_names)),
        "spurious_terminates": len(set(term_names) - killed),
        "duplicate_terminates": len(term_names) - len(set(term_names)),
        "premature_terminates": sum(
            1
            for _w, s in terminated
            if s is None or s < cfg.dead_after_s
        ),
        "senders": senders,
        "work_depth": len(work),
        "duplicate_sends": len(rid_list) - len(set(rid_list)),
        "unshipped_at_kill": lag_at_kill,
        "replayed_seq": new_primary.sync_seq,
        "journaled_seq": cluster.primary.seq,
        "epoch": epoch,
        "fenced_writes": cluster.primary.fenced + cluster.standby.fenced,
        "client_failovers": resend.failovers,
        "rounds": 6 + drain_rounds,
    }


def _shard_for_key(key: str, n_shards: int) -> int:
    """The production hash ring — ONE routing function shared by the
    real client and the sim, so a schedule proven here routes identically
    against the sharded binary fleet."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import shard_for_key

    return shard_for_key(key, n_shards)


class ShardedSimBroker:
    """N independent :class:`ReplicatedSimBroker` pairs behind the
    production consistent-hash ring (``broker_client.shard_for_key``).

    Queues/keys/workers route to ``shard_for_key(key, n_shards)``; each
    shard fails over, fences, and auto-re-provisions independently, so a
    single shard's outage stalls only the keys that hash there — the sim
    twin of ``ensure_sharded_broker``'s per-shard pairs."""

    def __init__(self, clock: VirtualClock, n_shards: int = 4):
        if n_shards < 1:
            raise ValueError(f"need at least one shard, got {n_shards}")
        self.clock = clock
        self.n_shards = n_shards
        self.shards = [
            ReplicatedSimBroker(
                clock,
                primary_name=f"shard{k}-a",
                standby_name=f"shard{k}-b",
            )
            for k in range(n_shards)
        ]

    def shard_index(self, key: str) -> int:
        return _shard_for_key(key, self.n_shards)

    def route(self, key: str) -> ReplicatedSimBroker:
        return self.shards[self.shard_index(key)]

    def active_dump(self) -> dict[str, tuple[float, int]]:
        """The merged heartbeat table a liveness watcher fetches: every
        shard's live primary contributes its slice; a shard mid-failover
        contributes nothing (only ITS workers go briefly unobserved)."""
        merged: dict[str, tuple[float, int]] = {}
        for shard in self.shards:
            merged.update(shard.active_dump())
        return merged

    def stream_all(self) -> int:
        """One replication pass over every shard whose recorded primary
        is the acting one (a shard mid-failover is skipped, exactly as
        ``ReplicationStreamer`` has no live source there)."""
        shipped = 0
        for shard in self.shards:
            if shard.active() is shard.primary:
                shipped += shard.stream()
        return shipped

    def healed_pairs(self) -> int:
        """Shards whose pair is whole and caught up: a live primary, a
        live replicating standby, zero replication lag."""
        healed = 0
        for shard in self.shards:
            acting = shard.active()
            if (
                acting is not None
                and acting is shard.primary
                and shard.standby.up
                and shard.standby.role == "standby"
                and not shard.pending()
            ):
                healed += 1
        return healed


class ShardedSimConnection:
    """Duck-types the agent-facing connection surface over a
    :class:`ShardedSimBroker`: each op hashes its key to a shard and
    walks THAT shard's endpoints through a per-shard
    :class:`FailoverSimConnection` (``nodes_source`` re-reads the pair,
    so an auto-re-provisioned standby is visible without a redial)."""

    def __init__(self, cluster: ShardedSimBroker):
        self._cluster = cluster
        self._conns = [
            FailoverSimConnection(nodes_source=shard.nodes)
            for shard in cluster.shards
        ]
        self.closed = False

    @property
    def failovers(self) -> int:
        return sum(conn.failovers for conn in self._conns)

    def _conn_for(self, key: str) -> FailoverSimConnection:
        if self.closed:
            raise SimBrokerError("connection is closed")
        return self._conns[self._cluster.shard_index(key)]

    def heartbeat(self, worker_id: str) -> int:
        return self._conn_for(worker_id).heartbeat(worker_id)

    def telem(self, worker_id: str, snapshot: bytes) -> int:
        return self._conn_for(worker_id).telem(worker_id, snapshot)

    def send_idempotent(self, queue: str, body: bytes, rid: str) -> str:
        return self._conn_for(queue).send_idempotent(queue, body, rid)

    def close(self) -> None:
        self.closed = True
        for conn in self._conns:
            conn.close()


def soak_fleet(
    agents: int = 10000,
    shards: int = 8,
    seed: int = 0,
    kill_count: int = 200,
    senders: int = 400,
    failover_shards: int = 3,
    unshipped_tail: int = 11,
    stale_writes: int = 5,
    tick_s: float = 5.0,
    config: LivenessConfig | None = None,
) -> dict:
    """10,000-agent (by default) multi-shard fleet soak on virtual time.

    The fleet-scale schedule the sharded control plane must survive, all
    in one seeded run: real ``Heartbeater`` instances beat through
    shard-routed failover connections; a real ``BrokerLivenessWatcher``
    classifies silence from the MERGED per-shard heartbeat tables; a
    seeded subset of agents dies silently.  Then, concurrently:
    ``failover_shards`` primaries die mid-traffic with unshipped journal
    tails (promotion + AUTO-RE-PROVISION of a fresh standby, half the
    shards healing before the client re-send storm and half after — the
    re-provision race); one healthy shard suffers a partition cut (its
    standby is promoted while the deposed primary keeps accepting
    writes, whose replication attempt must fence WITHOUT advancing the
    new primary — reject, never diverge); every sender blindly re-sends
    its request id through the shard router.  Traffic then drains until
    every silent death is detected on the replicated tables.

    Returns structural facts only (no wall-clock, no paths), so reports
    are byte-deterministic per seed: the terminate counters and
    ``duplicate_sends`` / ``diverged_entries`` must be 0 with
    ``delivered == senders + stale_writes``, ``degraded_pairs`` must be
    0 (no post-failover steady state missing a standby), and
    ``unaffected_shard_failovers`` must be 0 (a one-shard outage stalls
    only that shard's clients).
    """
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        BrokerLivenessWatcher,
    )
    from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind

    rng = random.Random(seed)
    clock = VirtualClock()
    cluster = ShardedSimBroker(clock, n_shards=shards)
    cfg = config or LivenessConfig()
    bus = EventBus()
    terminated: list[tuple[str, float | None]] = []

    def on_event(event: Any) -> None:
        if event.kind is EventKind.INSTANCE_TERMINATE:
            shard = cluster.route(event.instance_id)
            node = shard.active() or shard.standby
            terminated.append(
                (event.instance_id, node.silence_s(event.instance_id))
            )

    bus.subscribe(on_event)
    watcher = BrokerLivenessWatcher(
        cluster_name="sim-fleet",
        group="agents",
        bus=bus,
        config=cfg,
        clock=clock,
        fetch=cluster.active_dump,
    )

    names = [f"agent-{i:05d}" for i in range(agents)]
    killed = set(rng.sample(names, kill_count))
    live = [w for w in names if w not in killed]
    sender_names = rng.sample(live, senders)
    # One failover connection per agent, pinned to ITS shard; tagged by
    # shard so the blast radius of each outage is attributable.
    agent_conns: list[tuple[int, FailoverSimConnection]] = []

    def make_conn(worker: str) -> FailoverSimConnection:
        k = cluster.shard_index(worker)
        conn = FailoverSimConnection(nodes_source=cluster.shards[k].nodes)
        agent_conns.append((k, conn))
        return conn

    beaters = {
        w: Heartbeater(
            host="sim",
            port=0,
            worker_id=w,
            interval_s=tick_s,
            connection_factory=lambda w=w: make_conn(w),
        )
        for w in names
    }
    alive = set(names)

    def round_() -> None:
        for w in names:
            if w in alive:
                beaters[w].beat_step()
        cluster.stream_all()
        clock.advance(tick_s)
        watcher.poll()

    # Warmup: everyone beating on every shard, replication caught up.
    for _ in range(3):
        round_()
    # A seeded subset dies silently, mid-traffic.
    alive -= killed
    for _ in range(2):
        round_()

    # The kill round: beats + shard-routed idempotent submissions land,
    # then a seeded subset of shard PRIMARIES dies with their journal
    # tails unshipped.
    for w in names:
        if w in alive:
            beaters[w].beat_step()
    queues = {w: f"work/{w}" for w in sender_names}
    rids = {w: f"{w}/job-{seed}" for w in sender_names}
    for w in sender_names:
        cluster.route(queues[w]).primary.send_idempotent(
            queues[w], f"payload-{w}".encode(), rids[w]
        )
    fail_shards = sorted(rng.sample(range(shards), failover_shards))
    unshipped_total = 0
    for k in range(shards):
        shard = cluster.shards[k]
        if k in fail_shards:
            backlog = len(shard.pending())
            shard.stream(max_entries=max(0, backlog - unshipped_tail))
            unshipped_total += len(shard.pending())
            shard.kill_primary()
        else:
            shard.stream()
    clock.advance(tick_s)
    watcher.poll()  # dead shards fetch empty: nobody terminates early

    # Promotion + auto-heal wave.  Even-indexed shards re-provision their
    # fresh standby BEFORE the client re-send storm, odd-indexed after —
    # both orders of the re-provision race run every seed.
    epochs: dict[str, int] = {}
    for idx, k in enumerate(fail_shards):
        shard = cluster.shards[k]
        epochs[str(k)] = shard.promote_standby()
        if idx % 2 == 0:
            shard.reprovision_standby()

    # Partition cut on the lowest HEALTHY shard: its standby is promoted
    # while the deposed primary is still up and accepting writes on its
    # side of the cut.
    split_shard = min(k for k in range(shards) if k not in fail_shards)
    sp = cluster.shards[split_shard]
    epochs[str(split_shard)] = sp.promote_standby()
    split_queue = next(
        q
        for q in (f"split/{i}" for i in range(10 * shards))
        if cluster.shard_index(q) == split_shard
    )
    stale_rids = [f"stale/{j}/job-{seed}" for j in range(stale_writes)]
    for rid in stale_rids:
        sp.primary.send_idempotent(split_queue, rid.encode(), rid)
    # The deposed primary's replication attempt must be REJECTED without
    # the new primary applying a single entry: fence, never diverge.
    seq_before = sp.standby.sync_seq
    fenced_streams = 0
    try:
        sp.stream(src=sp.primary, dst=sp.standby)
    except SimFenced:
        fenced_streams += 1
    diverged_entries = (sp.standby.sync_seq - seq_before) + sum(
        1
        for rid in stale_rids
        if rid in sp.standby.applied.get(split_queue, set())
    )
    # Heal the cut: the fenced ex-primary stands down and dies; the
    # acting primary auto-re-provisions a fresh standby from its journal.
    sp.demote(sp.primary)
    sp.primary.up = False
    sp.reprovision_standby()

    # At-least-once across every switch: senders blindly re-send their
    # request ids through the shard router, and the partition-era writes
    # (lost with the deposed primary) are re-driven the same way.
    resend = ShardedSimConnection(cluster)
    for w in sender_names:
        resend.send_idempotent(queues[w], f"payload-{w}".encode(), rids[w])
    for rid in stale_rids:
        resend.send_idempotent(split_queue, rid.encode(), rid)
    resend.close()
    for idx, k in enumerate(fail_shards):
        if idx % 2 == 1:
            cluster.shards[k].reprovision_standby()

    # Drain: silence of the killed agents crosses dead_after_s on the
    # replicated per-shard tables; continuous streaming keeps every
    # fresh standby caught up.
    drain_rounds = int(cfg.dead_after_s // tick_s) + 3
    for _ in range(drain_rounds):
        round_()

    delivered = 0
    rid_dupes = 0
    for shard in cluster.shards:
        acting = shard.active()
        if acting is None:
            continue
        for entries in acting.queues.values():
            rid_list = [rid for rid, _body in entries]
            delivered += len(rid_list)
            rid_dupes += len(rid_list) - len(set(rid_list))
    affected = set(fail_shards) | {split_shard}
    term_names = [w for w, _s in terminated]
    return {
        "agents": agents,
        "shards": shards,
        "killed": len(killed),
        "terminated": len(term_names),
        "lost_terminates": len(killed - set(term_names)),
        "spurious_terminates": len(set(term_names) - killed),
        "duplicate_terminates": len(term_names) - len(set(term_names)),
        "premature_terminates": sum(
            1 for _w, s in terminated if s is None or s < cfg.dead_after_s
        ),
        "senders": senders,
        "sender_shards": len(
            {cluster.shard_index(q) for q in queues.values()}
        ),
        "delivered": delivered,
        "duplicate_sends": rid_dupes,
        "failover_shards": [str(k) for k in fail_shards],
        "split_shard": split_shard,
        "epochs": epochs,
        "unshipped_at_kill": unshipped_total,
        "stale_writes": stale_writes,
        "fenced_writes": sum(
            n.fenced for sh in cluster.shards for n in sh.nodes()
        ),
        "fenced_streams": fenced_streams,
        "diverged_entries": diverged_entries,
        "reprovisions": sum(sh.reprovisions for sh in cluster.shards),
        "healed_pairs": cluster.healed_pairs(),
        "degraded_pairs": shards - cluster.healed_pairs(),
        "client_failovers": sum(c.failovers for _k, c in agent_conns)
        + resend.failovers,
        "unaffected_shard_failovers": sum(
            c.failovers for k, c in agent_conns if k not in affected
        ),
        "rounds": 6 + drain_rounds,
    }
