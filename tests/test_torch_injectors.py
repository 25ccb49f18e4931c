"""The port's chaos injectors against the JAX package's, on the same seeds.

``deeplearning_cfn_tpu_torch/chaos/injectors.py`` is a copy of
``deeplearning_cfn_tpu/chaos/injectors.py`` over the port's seams.  Each
test drives both with the same seed and the same calls and requires the
same outcomes: the request and response sequence of ``FlakyOpener``, the
stalls of ``StallingConnectionFactory``, ``ChaosQueue``'s delivery order
and ``flush_held``, and the torn, slow and manifest-crash disks stacked
both ways over the port's ``train.checkpoint.CheckpointIO`` (the files on
disk byte-equal).  The seam contracts of ``tests/test_chaos.py`` are held
on the port too.
"""

import pytest

from deeplearning_cfn_tpu_torch.chaos import injectors
from deeplearning_cfn_tpu_torch.cluster.queue import InMemoryQueue
from deeplearning_cfn_tpu_torch.train.checkpoint import CheckpointIO, StateCheckpointer
from deeplearning_cfn_tpu_torch.utils.timeouts import FakeClock

try:
    from deeplearning_cfn_tpu.chaos import injectors as jinjectors
    from deeplearning_cfn_tpu.cluster.queue import InMemoryQueue as JInMemoryQueue
    from deeplearning_cfn_tpu.utils.timeouts import FakeClock as JFakeClock
except ImportError:  # the card's host
    jinjectors = None

needs_jax = pytest.mark.skipif(jinjectors is None, reason="needs the JAX package, the reference")


def _outcomes(opener, n=40):
    out = []
    for i in range(n):
        try:
            resp = opener(f"req-{i}")
            out.append(("ok", resp.read()))
        except Exception as exc:  # HTTPError or URLError
            out.append((type(exc).__name__, getattr(exc, "code", None), str(exc)))
    return out, list(opener.requests)


@needs_jax
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [dict(error_rate=0.45, reset_rate=0.15),
                                dict(error_rate=0.5, reset_rate=0.2, errors=(500,)),
                                dict(hard_down=True)], ids=["burst", "one-code", "hard-down"])
def test_flaky_opener_sequence_equals_jax(seed, kw):
    mine = _outcomes(injectors.FlakyOpener(seed=seed, **kw))
    theirs = _outcomes(jinjectors.FlakyOpener(seed=seed, **kw))
    assert mine == theirs
    assert mine[0]  # something was rolled


class _Conn:
    def __init__(self, log):
        self.log = log

    def heartbeat(self, worker_id):
        self.log.append(worker_id)
        return len(self.log)

    def close(self):
        self.log.append("closed")


@needs_jax
@pytest.mark.parametrize("seed", [0, 3])
def test_stalling_factory_stalls_as_jax(seed):
    def run(module):
        log = []
        factory = module.StallingConnectionFactory(lambda: _Conn(log), seed=seed, stall_rate=0.3)
        out = []
        for round_ in range(6):
            conn = factory()
            for _ in range(5):
                try:
                    out.append(conn.heartbeat(f"w{round_}"))
                except ConnectionError:
                    out.append("stall")
            conn.close()
        return out, log, factory.dials

    assert run(injectors) == run(jinjectors)


def _queue_run(module, queue_cls, clock_cls, seed, **kw):
    q = module.ChaosQueue(queue_cls("chaos", clock=clock_cls()), seed=seed, **kw)
    delivered = []
    for i in range(30):
        q.send({"id": i})
        if i % 4 == 3:
            for msg in q.receive(max_messages=10, visibility_timeout_s=60.0):
                delivered.append(msg.body["id"])
                q.delete(msg.receipt)
    depth = q.approximate_depth()
    flushed = q.flush_held()
    for msg in q.receive(max_messages=100):
        delivered.append(msg.body["id"])
    return delivered, depth, flushed, (q.dropped, q.delayed, q.duplicated)


@needs_jax
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_queue_delivery_order_and_flush_equal_jax(seed):
    kw = dict(drop_rate=0.1, delay_rate=0.2, delay_ops=2, duplicate_rate=0.2, reorder=True)
    mine = _queue_run(injectors, InMemoryQueue, FakeClock, seed, **kw)
    theirs = _queue_run(jinjectors, JInMemoryQueue, JFakeClock, seed, **kw)
    assert mine == theirs
    assert sum(mine[3]) > 0  # the chaos actually struck


def test_chaos_queue_delay_is_operation_deterministic():
    q = injectors.ChaosQueue(InMemoryQueue("t", clock=FakeClock()), seed=0, delay_rate=1.0,
                             delay_ops=2)
    q.send({"id": 1})
    assert q.delayed == 1
    assert q.receive() == []          # op 2: not due yet
    assert [m.body["id"] for m in q.receive()] == [1]  # op 3: released


def test_chaos_queue_flush_held_drains_everything():
    q = injectors.ChaosQueue(InMemoryQueue("t", clock=FakeClock()), seed=0, delay_rate=1.0,
                             delay_ops=100)
    for i in range(5):
        q.send({"id": i})
    assert q.flush_held() == 5
    assert {m.body["id"] for m in q.receive(max_messages=10)} == set(range(5))


def _stacked(module, clock, order, tmp, seed):
    """A torn, a slow and an armed manifest-crash disk over ``CheckpointIO``
    (the port's), outermost first as ``order`` names them; the outcome of
    each of a few writes, the clock, the counters and the files."""
    torn = module.TornDisk(seed=seed, fail_rate=0.5)
    slow = module.SlowDisk(clock, latency_s=3.0)
    crash = module.ManifestCrashDisk()
    crash.arm()
    layers = {"torn": torn, "slow": slow, "crash": crash}
    stack = [layers[k] for k in order]
    for outer, inner in zip(stack, stack[1:]):
        outer.wrap(inner)
    stack[-1].wrap(CheckpointIO())
    out = []
    for i, name in enumerate(["shard-0.bin", "ckpt-1.manifest.json", "shard-1.bin",
                              "ckpt-2.manifest.json", "shard-2.bin", "shard-3.bin"]):
        try:
            stack[0].write_bytes(tmp / name, bytes(range(i, i + 16)))
            out.append("ok")
        except OSError as exc:
            out.append(str(exc))
    files = {p.name: p.read_bytes() for p in sorted(tmp.iterdir())}
    return out, clock.now(), (torn.writes, torn.torn, slow.writes, crash.writes,
                              crash.crashes), files


@needs_jax
@pytest.mark.parametrize("order", [("torn", "slow", "crash"), ("crash", "slow", "torn"),
                                   ("slow", "crash", "torn")], ids="-".join)
@pytest.mark.parametrize("seed", [0, 5])
def test_disk_stacks_over_checkpoint_io_equal_jax(order, seed, tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mine = _stacked(injectors, FakeClock(), order, tmp_path / "a", seed)
    theirs = _stacked(jinjectors, JFakeClock(), order, tmp_path / "b", seed)
    assert mine == theirs
    assert any(o != "ok" for o in mine[0]) and "ok" in mine[0]


def test_disk_injectors_stack_deterministically(tmp_path):
    # wrap() order IS the fault order, outermost first.
    clock = FakeClock()
    crash = injectors.ManifestCrashDisk()
    crash.arm()
    stack = injectors.SlowDisk(clock, latency_s=5.0).wrap(crash.wrap(CheckpointIO()))
    with pytest.raises(OSError, match="manifest"):
        stack.write_bytes(tmp_path / "ckpt-1.manifest.json", b"m")
    assert clock.now() == 5.0 and crash.crashes == 1
    clock2 = FakeClock()
    crash2 = injectors.ManifestCrashDisk()
    crash2.arm()
    stack2 = crash2.wrap(injectors.SlowDisk(clock2, latency_s=5.0).wrap(CheckpointIO()))
    with pytest.raises(OSError, match="manifest"):
        stack2.write_bytes(tmp_path / "ckpt-2.manifest.json", b"m")
    assert clock2.now() == 0.0 and crash2.crashes == 1


def test_torn_over_slow_stack_counts_both_layers(tmp_path):
    clock = FakeClock()
    slow = injectors.SlowDisk(clock, latency_s=2.0).wrap(CheckpointIO())
    torn = injectors.TornDisk(seed=0, fail_rate=1.0).wrap(slow)
    with pytest.raises(OSError, match="torn"):
        torn.write_bytes(tmp_path / "shard-0.bin", b"x" * 8)
    assert torn.writes == 1 and torn.torn == 1
    assert slow.writes == 1 and clock.now() == 2.0
    assert (tmp_path / "shard-0.bin").read_bytes() == b"x" * 4


def test_manifest_crash_once_disarms_and_recovers(tmp_path):
    disk = injectors.ManifestCrashDisk()
    disk.arm()
    with pytest.raises(OSError):
        disk.write_bytes(tmp_path / "ckpt-3.manifest.json", b"v3")
    disk.write_bytes(tmp_path / "ckpt-4.manifest.json", b"v4")
    assert (tmp_path / "ckpt-4.manifest.json").read_bytes() == b"v4"
    assert disk.crashes == 1


@needs_jax
def test_torn_checkpoints_never_observable_as_jax(tmp_path):
    """The port's ``StateCheckpointer`` over a torn disk lands the same steps
    as JAX's over JAX's injector with the same seed, and only those are
    visible."""
    from deeplearning_cfn_tpu.train.checkpoint import StateCheckpointer as JStateCheckpointer

    def run(ck_cls, disk, root):
        ck = ck_cls(root, max_to_keep=100, io=disk)
        landed = []
        for step in range(1, 21):
            try:
                ck.save(step, {"step": step})
                landed.append(step)
            except OSError:
                pass
        return ck, landed

    ck, landed = run(StateCheckpointer, injectors.TornDisk(seed=0, fail_rate=0.7), tmp_path / "a")
    _, jlanded = run(JStateCheckpointer, jinjectors.TornDisk(seed=0, fail_rate=0.7),
                     tmp_path / "b")
    assert landed == jlanded and 0 < len(landed) < 20
    assert ck.steps() == landed
    state, step = ck.restore_latest()
    assert step == landed[-1] and state == {"step": step}
    assert not list((tmp_path / "a").glob(".state-*"))


def test_atomic_write_survives_interrupted_replace(tmp_path):
    from deeplearning_cfn_tpu_torch.utils.atomicio import atomic_write_bytes

    target = tmp_path / "contract.json"
    atomic_write_bytes(target, b"v1")
    # A crash between write and rename leaves the old contents intact.
    (tmp_path / ".contract.json.tmp-999").write_bytes(b"half-written garb")
    assert target.read_bytes() == b"v1"
    atomic_write_bytes(target, b"v2")
    assert target.read_bytes() == b"v2"


def test_recording_clock_records_every_sleep():
    clock = injectors.RecordingClock()
    for s in (0.1, 0.2, 0.3):
        clock.sleep(s)
    assert clock.sleeps == [0.1, 0.2, 0.3]
    assert clock.now() == (0.0 + 0.1) + 0.2 + 0.3


def test_injectors_import_no_framework():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(injectors.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"torch", "jax", "numpy"}
