"""The port's data-stream plane and async sharded checkpointer against the
JAX package's ``train/datastream``, on the CPU.

- Assignment: ``shard_permutation``, ``record_permutation``,
  ``assign_shards`` and ``reassign_remaining`` equal JAX's for several seeds,
  epochs and host counts.
- Records and streams: ``write_records`` writes JAX's bytes; the port's
  ``HostShardStream`` gives JAX's batches on records the test writes, and a
  ``StreamState`` taken on either side resumes on the other.
- ``DataStreamPlane.reshard`` with a duck-typed contract: every record once.
- ``AsyncShardedCheckpointer``: the JSON codec orders leaves as JAX's
  ``tree_leaves`` (sorted keys) and names dtypes as numpy does, so the shard
  and manifest files of the same f32/bf16/int tree are byte-identical and
  each side restores the other's bit-exact; latest-wins supersession; a
  crash before the manifest leaves the previous step restorable; a save
  followed at once by an in-place step writes the pre-step values.
- ``Trainer.fit(checkpointer=, datastream=)``: the stream state rides the v3
  manifest, and the resumed run consumes the records the lost run never saw
  and reproduces its losses bit for bit.
"""

import json
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.train import datastream as jds  # noqa: E402
from deeplearning_cfn_tpu.train import records as jrecords  # noqa: E402
from deeplearning_cfn_tpu_torch.train import datastream as ds  # noqa: E402
from deeplearning_cfn_tpu_torch.train import records  # noqa: E402
from deeplearning_cfn_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from deeplearning_cfn_tpu_torch.train.checkpoint import CheckpointIO, TopologyMismatch  # noqa: E402

torch.set_num_threads(1)

SPEC = records.RecordSpec((records.Field("x", "uint8", (2,)), records.Field("y", "int32", ())))
JSPEC = jrecords.RecordSpec((jrecords.Field("x", "uint8", (2,)), jrecords.Field("y", "int32", ())))
TOPO = {"devices": 2, "axes": {"fsdp": 2}}


def _shards(tmp_path, sizes, spec=SPEC, writer=records.write_records):
    """DLC1 shard files whose y field is the global record id."""
    paths, gid = [], 0
    for sid, n in enumerate(sizes):
        recs = []
        for _ in range(n):
            recs.append(spec.encode(x=np.full((2,), gid % 256, np.uint8), y=np.int32(gid)))
            gid += 1
        path = tmp_path / f"shard-{sid:02d}.dlc"
        writer(path, spec, recs)
        paths.append(path)
    return paths, gid


class FakeContract:
    def __init__(self, hosts):
        self._hosts = tuple(hosts)

    def datastream_hosts(self):
        return self._hosts


# --- assignment --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("n_hosts,n_shards", [(1, 5), (3, 7), (4, 4), (5, 3)])
def test_assignment_equals_jax(seed, n_hosts, n_shards):
    hosts = [f"h{i}" for i in range(n_hosts)]
    for epoch in range(3):
        assert ds.shard_permutation(seed, epoch, n_shards) == jds.shard_permutation(seed, epoch,
                                                                                    n_shards)
        assert ds.assign_shards(hosts, n_shards, seed, epoch) == jds.assign_shards(
            hosts, n_shards, seed, epoch)
        for shard in range(n_shards):
            np.testing.assert_array_equal(ds.record_permutation(seed, epoch, shard, 17),
                                          jds.record_permutation(seed, epoch, shard, 17))
    sizes = {s: 10 + s for s in range(n_shards)}
    progress = {s: (s * 3) % (10 + s) for s in range(0, n_shards, 2)}
    ours = ds.reassign_remaining(seed, 1, n_shards, progress, sizes, hosts[:2] or hosts)
    theirs = jds.reassign_remaining(seed, 1, n_shards, progress, sizes, hosts[:2] or hosts)
    assert {h: [w.to_json() for w in ws] for h, ws in ours.items()} == {
        h: [w.to_json() for w in ws] for h, ws in theirs.items()}


def test_assignment_validation():
    with pytest.raises(ValueError, match="at least one host"):
        ds.assign_shards([], 4, 0, 0)
    with pytest.raises(ValueError, match="duplicate"):
        ds.assign_shards(["a", "a"], 4, 0, 0)
    with pytest.raises(ValueError, match="exceeds size"):
        ds.reassign_remaining(0, 0, 1, {0: 9}, {0: 4}, ["a"])


# --- records and streams -----------------------------------------------------


def test_write_records_bytes_equal_jax(tmp_path):
    ours, _ = _shards(tmp_path / "a", [5, 3])
    theirs, _ = _shards(tmp_path / "b", [5, 3], JSPEC, jrecords.write_records)
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()
    assert records.read_header(ours[0]) == (SPEC.record_size, 5)
    got = records.read_all(ours[0], SPEC)
    assert got["y"].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("hosts", [("h0",), ("h0", "h1", "h2")])
def test_stream_batches_equal_jax_across_a_state_round_trip(tmp_path, hosts):
    paths, _ = _shards(tmp_path, [10, 14, 7])
    for host in hosts:
        kw = dict(batch_size=4, host=host, hosts=hosts, seed=9, loop=True)
        want = [b.y.tolist() for b in jds.HostShardStream(paths, JSPEC, **kw).batches(12)]
        head = ds.HostShardStream(paths, SPEC, **kw)
        got = [b.y.tolist() for b in head.batches(5)]
        doc = json.loads(json.dumps(head.stream_state().to_json()))
        theirs = jds.HostShardStream(paths, JSPEC, state=doc, **kw)  # JAX resumes ours
        got += [b.y.tolist() for b in theirs.batches(3)]
        doc = json.loads(json.dumps(theirs.stream_state().to_json()))
        got += [b.y.tolist() for b in ds.HostShardStream(paths, SPEC, state=doc, **kw).batches(4)]
        assert got == want


def test_plane_reshard_is_exactly_once(tmp_path):
    paths, total = _shards(tmp_path, [9, 12, 7, 10, 8])
    plane = ds.DataStreamPlane(FakeContract(("h0", "h1", "h2", "h3")), paths, SPEC,
                               batch_size=4, seed=2, loop=False)
    seen: list[int] = []
    iters = {h: plane.stream(h).batches() for h in plane.hosts}
    for _ in range(2):
        for it in iters.values():
            batch = next(it, None)
            if batch is not None:
                seen.extend(int(y) for y in batch.y)
    work = plane.reshard(FakeContract(("h0", "h2")))
    assert set(work) == {"h0", "h2"}
    for host in ("h0", "h2"):
        seen.extend(int(y) for b in iters[host] for y in b.y)
    assert sorted(seen) == list(range(total))
    assert plane.reshards == 1 and plane.snapshot()["records_total"] == total


# --- the codec and the async checkpointer -----------------------------------


def _trees():
    """The same tree for each side: JAX's numpy (ml_dtypes bf16), ours torch."""
    w = np.array([[0.1, 1 / 3, -2.5e-8], [3.4e38, -0.0, 7.0]], np.float32)
    b = np.array([1.0, -0.00731, 3.0e-5], np.float64).astype(ml_dtypes.bfloat16)
    jtree = {"w": w, "b": b, "step": np.int32(17), "ids": np.arange(4, dtype=np.int64),
             "a": [np.float32(2.5), {"z": np.array([True, False])}]}
    ttree = {"step": torch.tensor(17, dtype=torch.int32), "w": torch.from_numpy(w.copy()),
             "ids": torch.arange(4), "b": torch.from_numpy(b.astype(np.float32)).bfloat16(),
             "a": [torch.tensor(2.5), {"z": torch.tensor([True, False])}]}
    return jtree, ttree


def test_encode_tree_equals_jax_and_decodes_bit_exact():
    jtree, ttree = _trees()
    ours, theirs = ds.encode_tree(ttree), jds.encode_tree(jtree)
    assert json.dumps(ours) == json.dumps(theirs)
    assert [d["dtype"] for d in ours] == ["float32", "bool", "bfloat16", "int64", "int32",
                                          "float32"]
    out = ds.decode_tree(ttree, json.loads(json.dumps(theirs)))
    for key in ("w", "b", "ids", "step"):
        assert out[key].dtype == ttree[key].dtype and torch.equal(out[key], ttree[key]), key
    with pytest.raises(ValueError, match="leaves"):
        ds.decode_tree({"a": torch.zeros(3)}, ours)


def _files(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())}


def test_async_checkpoint_files_exchange_with_jax(tmp_path):
    jtree, ttree = _trees()
    stream = {"host": "h0", "epoch": 1, "work": [[2, 5]]}
    with ds.AsyncShardedCheckpointer(tmp_path / "ours", n_shards=3) as ck:
        ck.save(4, ttree, mesh_topology=TOPO, stream_state=stream)
        ck.wait()
    with jds.AsyncShardedCheckpointer(tmp_path / "theirs", n_shards=3) as jck:
        jck.save(4, jtree, mesh_topology=TOPO, stream_state=stream)
        jck.wait()
    assert _files(tmp_path / "ours") == _files(tmp_path / "theirs")
    # Each side restores the other's files.
    jck = jds.AsyncShardedCheckpointer(tmp_path / "ours", n_shards=3)
    state, step = jck.restore_latest(template=jtree, expected_topology=TOPO)
    jck.close()
    assert step == 4 and jck.last_stream_state == stream
    assert state["b"].dtype == jtree["b"].dtype and state["b"].tobytes() == jtree["b"].tobytes()
    assert state["w"].tobytes() == jtree["w"].tobytes()
    with ds.AsyncShardedCheckpointer(tmp_path / "theirs", n_shards=3) as ck:
        state, step = ck.restore_latest(template=ttree, expected_topology=TOPO)
        assert ck.last_stream_state == stream
        with pytest.raises(TopologyMismatch):
            ck.restore_latest(expected_topology={"devices": 4, "axes": {"fsdp": 4}})
    for key in ("w", "b", "ids", "step"):
        assert state[key].dtype == ttree[key].dtype and torch.equal(state[key], ttree[key]), key


class _GatedDisk(CheckpointIO):
    """Parks the writer inside its first write until released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def write_bytes(self, path, data):
        self.entered.set()
        assert self.release.wait(timeout=30.0)
        Path(path).write_bytes(data)


def test_async_save_never_blocks_and_latest_wins(tmp_path):
    disk = _GatedDisk()
    ck = ds.AsyncShardedCheckpointer(tmp_path, n_shards=2, io=disk)
    try:
        ck.save(1, {"w": torch.arange(4.0)})
        assert disk.entered.wait(timeout=30.0)
        ck.save(2, {"w": torch.arange(4.0) + 2})
        ck.save(3, {"w": torch.arange(4.0) + 3})
        assert ck.superseded_total == 1
        assert not list(tmp_path.glob("*.manifest.json"))
        disk.release.set()
        ck.wait(timeout_s=60.0)
    finally:
        disk.release.set()
        ck.close()
    assert ck.steps() == [1, 3]
    restored, step = ck.restore_latest(template={"w": torch.zeros(4)})
    assert step == 3 and torch.equal(restored["w"], torch.arange(4.0) + 3)


class _ManifestCrash(CheckpointIO):
    """Raises when the manifest is written: a writer dying at the commit."""

    def __init__(self):
        self.armed = False

    def write_bytes(self, path, data):
        if self.armed and "manifest" in Path(path).name:
            raise OSError("crash at the manifest")
        super().write_bytes(path, data)


def test_crash_before_the_manifest_keeps_the_previous_step(tmp_path):
    disk = _ManifestCrash()
    w = torch.arange(12.0).reshape(3, 4)
    with ds.AsyncShardedCheckpointer(tmp_path, n_shards=2, io=disk) as ck:
        ck.save(1, {"w": w}, mesh_topology=TOPO, stream_state={"host": "h0"})
        ck.wait()
        disk.armed = True
        ck.save(2, {"w": w + 1})
        ck.wait()
        assert ck.write_failures == 1 and ck.steps() == [1]
        assert list(tmp_path.glob("ckpt-00000002.shard-*.json"))  # litter, never read
        restored, step = ck.restore_latest(template={"w": torch.zeros(3, 4)})
        assert step == 1 and torch.equal(restored["w"], w)
        assert ck.last_stream_state == {"host": "h0"}


def _tiny_trainer():
    def model_fn(gen):
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(64, 10))

    return trainer_lib.Trainer(model_fn, trainer_lib.TrainerConfig(
        optimizer="adamw", learning_rate=1e-2, weight_decay=0.1, log_every=1), device="cpu")


def test_a_save_then_an_in_place_step_writes_the_pre_step_values(tmp_path, monkeypatch):
    from deeplearning_cfn_tpu_torch.train.datastream import async_ckpt

    t = _tiny_trainer()
    state = t.init(seed=0)
    x, y = torch.randn(4, 8, 8, 1, generator=torch.Generator().manual_seed(1)), torch.arange(4)
    state, _ = t.train_step(state, x, y)
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    release = threading.Event()
    encode = async_ckpt.encode_tree

    def gated_encode(tree):  # the writer reads nothing before the next step is done
        assert release.wait(timeout=30.0)
        return encode(tree)

    monkeypatch.setattr(async_ckpt, "encode_tree", gated_encode)
    with ds.AsyncShardedCheckpointer(tmp_path, n_shards=2) as ck:
        ck.save(state.step, state)
        state, _ = t.train_step(state, x, y)  # in place, at once
        assert not torch.equal(state.model[1].weight, want["1.weight"])
        release.set()
        ck.wait()
        fresh = _tiny_trainer().init(seed=0)
        restored, step = ck.restore_latest(template=fresh)
    assert restored is fresh and step == 1 and fresh.step == 1
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, want[n]), n


def test_fit_with_datastream_resumes_the_records_the_lost_run_never_saw(tmp_path):
    spec = records.RecordSpec.classification((8, 8, 1), "float32")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):  # 2 shards x 64 records = 8 batches of 16
        recs = [spec.encode(x=rng.standard_normal((8, 8, 1)).astype(np.float32),
                            y=np.int32(rng.integers(10))) for _ in range(64)]
        paths.append(tmp_path / f"train-{i}.dlc")
        records.write_records(paths[-1], spec, recs)

    def stream(state=None):
        return ds.HostShardStream(paths, spec, 16, host="h0", hosts=("h0",), seed=5, loop=True,
                                  state=state)

    total, stop = 8, 3
    _, straight = _tiny_trainer().fit(_tiny_trainer().init(seed=0), stream().batches(),
                                      steps=total, prefetch=0)
    t_b = _tiny_trainer()
    s_b = stream()
    ck = ds.AsyncShardedCheckpointer(tmp_path / "ckpt", every_steps=1, n_shards=3)
    _, first = t_b.fit(t_b.init(seed=0), s_b.batches(), steps=stop, prefetch=0,
                       checkpointer=ck, datastream=s_b)
    ck.wait()
    assert first == straight[:stop] and ck.latest_step() == stop
    t_c = _tiny_trainer()
    state_c, step = ck.restore_latest(template=t_c.init(seed=1))
    ck.close()
    assert step == stop and ck.last_stream_state["host"] == "h0"
    s_c = stream(state=ck.last_stream_state)
    assert s_c.records_total == stop * 16  # no replay, no skip
    _, rest = t_c.fit(state_c, s_c.batches(), steps=total - stop, prefetch=0)
    assert first + rest == straight  # bit for bit
