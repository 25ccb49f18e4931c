"""The port's interleaving harness and simulated brokers against the JAX
package's (``analysis/schedules.py`` in both).

The heartbeat choreography drives the port's real Heartbeater,
BrokerLivenessWatcher, LivenessTable and EventBus over virtual time; for
the same seeded schedules its states, terminations and recoveries must be
JAX's.  ``soak_failover`` (a replicated pair under a thousand agents) and
``soak_fleet`` (a consistent-hash ring of pairs) must return JAX's result
dicts for the same seeds, and the sharded ring must route every key to
JAX's shard.  The seam contracts of ``tests/test_interleaving.py`` are held
on the port too: the >= 50 death-recovery interleavings, no false
termination, the mid-RPC primary death without duplicate side effects.
"""

import logging

import pytest

from deeplearning_cfn_tpu_torch.analysis import schedules as S
from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig, WorkerState

try:
    from deeplearning_cfn_tpu.analysis import schedules as JS
    from deeplearning_cfn_tpu.obs.liveness import LivenessConfig as JLivenessConfig
except ImportError:  # the card's host
    JS = None

needs_jax = pytest.mark.skipif(JS is None, reason="needs the JAX package, the reference")

PREFIX = ["beat:w0", "beat:w1", "poll"]
MIDDLE = ("beat:w0", "beat:w1", "beat:w1", "tick", "tick", "tick", "poll", "kill:w0", "poll")
DRAIN = ["beat:w1", "tick"] * 13 + ["poll"]


@pytest.fixture(autouse=True)
def _quiet_liveness():
    # Every transition of a thousand-agent soak logs a warning.
    logger = logging.getLogger("dlcfn")
    level = logger.level
    logger.setLevel(logging.ERROR)
    yield
    logger.setLevel(level)


def _choreo(module, config_cls, **kw):
    return module.HeartbeatChoreography(
        ["w0", "w1"], config=config_cls(suspect_after_s=15.0, dead_after_s=60.0),
        tick_s=5.0, **kw)


def _outcome(choreo):
    return choreo.states(), choreo.terminated_workers(), dict(choreo.recovered)


@needs_jax
@pytest.mark.parametrize("seed", [0, 7])
def test_death_recovery_choreography_equals_jax(seed):
    middles = S.interleavings(MIDDLE, count=12, seed=seed)
    assert middles == JS.interleavings(MIDDLE, count=12, seed=seed)
    for middle in middles:
        schedule = PREFIX + list(middle) + DRAIN + ["recover", "poll"]
        mine = _outcome(_choreo(S, LivenessConfig).run(schedule))
        theirs = _outcome(_choreo(JS, JLivenessConfig).run(schedule))
        assert mine == theirs, middle


@needs_jax
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_choreography_equals_jax(seed):
    short_cut = ("beat:w0", "beat:w1", "tick", "tick", "poll")
    for middle in S.interleavings(short_cut, count=4, seed=seed):
        first = PREFIX + ["cut:w0"] + list(middle) + ["heal:w0", "beat:w0", "poll"]
        second = (["cut:w0"] + ["beat:w0", "beat:w1", "tick"] * 13
                  + ["poll", "recover", "heal:w0", "beat:w0", "poll"])
        mine, theirs = _choreo(S, LivenessConfig), _choreo(JS, JLivenessConfig)
        assert _outcome(mine.run(first)) == _outcome(theirs.run(first))
        assert _outcome(mine.run(second)) == _outcome(theirs.run(second))


@needs_jax
@pytest.mark.parametrize("seed", [0, 1])
def test_soak_failover_equals_jax(seed):
    mine = S.soak_failover(agents=1000, seed=seed)
    assert mine == JS.soak_failover(agents=1000, seed=seed)
    assert mine["terminated"] == mine["killed"] and mine["epoch"] == 1


@needs_jax
@pytest.mark.parametrize("seed", [0, 1])
def test_soak_fleet_equals_jax(seed):
    kw = dict(agents=2000, shards=4, seed=seed, kill_count=50, senders=100,
              failover_shards=1, unshipped_tail=5, stale_writes=3)
    mine = S.soak_fleet(**kw)
    assert mine == JS.soak_fleet(**kw)
    assert mine["degraded_pairs"] == 0 and mine["healed_pairs"] == 4


@needs_jax
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_ring_routes_as_jax(n_shards):
    ring, jring = S.ShardedSimBroker(S.VirtualClock(), n_shards), JS.ShardedSimBroker(
        JS.VirtualClock(), n_shards)
    keys = [f"agent-{i:04d}" for i in range(300)] + ["gauntlet-work", "10.0.0.3", "work"]
    assert [ring.shard_index(k) for k in keys] == [jring.shard_index(k) for k in keys]
    assert len({ring.shard_index(k) for k in keys}) == n_shards
    # A failover on one shard: the heal count and the clients' failovers as JAX's.
    for r in (ring, jring):
        conn = (S if r is ring else JS).ShardedSimConnection(r)
        for k in keys[:40]:
            conn.heartbeat(k)
            conn.send_idempotent("work", k.encode(), k)
        r.stream_all()
        r.shards[0].kill_primary()
        r.shards[0].promote_standby()
        for k in keys[:40]:
            conn.heartbeat(k)
        r.result = (r.healed_pairs(), conn.failovers, sorted(r.active_dump().items()))
        r.shards[0].reprovision_standby()
        r.stream_all()
        r.result += (r.healed_pairs(),)
    assert ring.result == jring.result
    assert ring.result[0] < n_shards and ring.result[1] > 0 and ring.result[-1] == n_shards


@needs_jax
@pytest.mark.parametrize("seed", [13, 14])
def test_mid_rpc_primary_death_equals_jax(seed):
    def run(module):
        out = []
        for middle in module.interleavings(RPC_RACE, count=20, seed=seed):
            out.append(_rpc_race(module, middle))
        return out

    assert run(S) == run(JS)


RPC_RACE = ("rpc:r0", "rpc:r1", "rpc:r2", "stream", "stream", "kill")
RPC_RIDS = ("r0", "r1", "r2")


def _rpc_race(module, middle):
    clock = module.VirtualClock()
    cluster = module.ReplicatedSimBroker(clock)
    conn = module.FailoverSimConnection(cluster.nodes())
    acked: set[str] = set()
    for action in middle:
        clock.advance(1.0)
        if action == "kill":
            cluster.kill_primary()
        elif action == "stream":
            try:
                cluster.stream()
            except module.SimBrokerError:
                pass  # the streamer dialed a dead primary: the outage
        else:
            rid = action.split(":", 1)[1]
            try:
                conn.send_idempotent("work", b"job", rid)
                acked.add(rid)
            except module.SimBrokerError:
                pass  # died mid-RPC
    cluster.promote_standby()
    for rid in RPC_RIDS:  # blind at-least-once recovery
        conn.send_idempotent("work", b"job", rid)
    queue = [rid for rid, _ in cluster.standby.queues.get("work", [])]
    return sorted(acked), queue, conn.failovers


def test_fifty_plus_death_recovery_interleavings():
    middles = S.interleavings(MIDDLE, count=56, seed=7)
    assert len(set(middles)) == 56
    for middle in middles:
        choreo = _choreo(S, LivenessConfig).run(PREFIX + list(middle) + DRAIN
                                                 + ["recover", "poll"])
        states = choreo.states()
        assert states["w0"] == WorkerState.DEAD.value
        assert choreo.terminated_workers().count("w0") == 1
        assert states["w1"] == WorkerState.ALIVE.value
        assert "w1" not in choreo.terminated_workers()
        assert choreo.recovered == {"w0": "w0+1"}
        assert states["w0+1"] == WorkerState.ALIVE.value


def test_no_false_termination_while_everyone_beats():
    actions = ("beat:w0", "beat:w1", "tick", "tick", "tick", "poll", "poll")
    for middle in S.interleavings(actions, count=24, seed=11):
        choreo = _choreo(S, LivenessConfig).run(PREFIX + list(middle) + ["poll"])
        assert choreo.terminated_workers() == []
        assert WorkerState.DEAD.value not in choreo.states().values()


def test_truth_checking_is_not_vacuous():
    choreo = _choreo(S, LivenessConfig)
    choreo.run(["beat:w0", "poll"])
    with pytest.raises(S.InvariantViolation):
        choreo._check_transitions([("w0", WorkerState.ALIVE, WorkerState.DEAD)])


def test_injected_beat_failure_exercises_real_reconnect():
    choreo = _choreo(S, LivenessConfig, fail_first_beats=1)
    hb = choreo.heartbeaters["w0"]
    assert hb.beat_step() is False and hb.beats_sent == 0
    assert hb.beat_step() is True and hb.beats_sent == 1


def test_scheduler_fails_loudly_on_unknown_actor():
    sched = S.StepScheduler()
    sched.add("a", lambda: None)
    with pytest.raises(KeyError):
        sched.run(["a", "ghost"])
    with pytest.raises(ValueError):
        sched.add("a", lambda: None)


def test_primary_death_mid_rpc_no_duplicate_side_effects():
    for middle in S.interleavings(RPC_RACE, count=56, seed=13):
        acked, queue, _ = _rpc_race(S, middle)
        assert sorted(queue) == sorted(RPC_RIDS), (middle, queue)
        assert set(acked) <= set(queue)


def test_replayed_journal_is_idempotent_on_standby():
    clock = S.VirtualClock()
    cluster = S.ReplicatedSimBroker(clock)
    primary = cluster.primary
    for i in range(5):
        clock.advance(1.0)
        primary.send_idempotent("work", f"b{i}".encode(), f"r{i}")
    primary.set("leader", b"broker-a")
    primary.record("w0")
    assert cluster.stream() == 7
    snap = (dict(cluster.standby.queues), dict(cluster.standby.kv), cluster.standby.sync_seq)
    for entry in primary.journal:
        cluster.standby.sync(entry["epoch"], entry["seq"], entry["frame"])
    assert (dict(cluster.standby.queues), dict(cluster.standby.kv),
            cluster.standby.sync_seq) == snap
    assert cluster.standby.fenced == 0


def test_split_brain_writes_are_fenced():
    clock = S.VirtualClock()
    cluster = S.ReplicatedSimBroker(clock)
    cluster.primary.send_idempotent("work", b"a", "a")
    cluster.stream()
    assert cluster.promote_standby() == 1
    cluster.primary.send_idempotent("work", b"stale", "stale")
    with pytest.raises(S.SimFenced):
        for entry in cluster.pending():
            cluster.standby.sync(entry["epoch"], entry["seq"], entry["frame"])
    assert cluster.standby.fenced == 1
