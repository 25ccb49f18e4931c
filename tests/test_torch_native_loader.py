"""The port's binding to ``native/dataloader`` against the JAX package's.

Both bind the same C++ source (the port builds its own library under
``build/torch_native/``), so over the same files with the same arguments
they must deliver the same bytes in the same order: shuffle on and off, one
and four threads (ticket order), two shards of records, ``start_batch`` in
the middle of an epoch, the last partial batch kept.  ``PythonRecordLoader``
is held to JAX's the same way.  Then the typed shard errors, the journaled
fall back to the Python loader, the reuse-buffer traps of
``tests/test_native_loader.py`` and the build itself (a clean directory,
several builds at once, a compiler error).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from deeplearning_cfn_tpu.train import native_loader as jax_loader
    from deeplearning_cfn_tpu.train import records as jax_records
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax_loader = None

from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder  # noqa: E402
from deeplearning_cfn_tpu_torch.train import native_loader  # noqa: E402
from deeplearning_cfn_tpu_torch.train.datasets import token_batches, token_spec  # noqa: E402
from deeplearning_cfn_tpu_torch.train.records import (  # noqa: E402
    Field,
    RecordSpec,
    write_records,
)

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax_loader is None, reason="needs JAX, the reference")

SPEC = RecordSpec.classification((3, 2, 1), "uint8")


def _shard(path, ids):
    """One shard of records whose bytes say which record they are."""
    recs = [SPEC.encode(x=np.full((3, 2, 1), i % 256, np.uint8), y=np.int32(i)) for i in ids]
    write_records(path, SPEC, recs)
    return path


@pytest.fixture()
def shards(tmp_path):
    return [_shard(tmp_path / "a.dlc", range(0, 23)), _shard(tmp_path / "b.dlc", range(23, 41))]


def _drain(loader, n: int) -> list[bytes]:
    out = []
    for _ in range(n):
        raw = loader.next_raw()
        if raw is None:
            break
        out.append(raw.tobytes())
    return out


def _jax_spec():
    return jax_records.RecordSpec.classification((3, 2, 1), "uint8")


CASES = {
    "shuffle-1thread": dict(shuffle=True, n_threads=1),
    "shuffle-4threads": dict(shuffle=True, n_threads=4),
    "ordered-4threads": dict(shuffle=False, n_threads=4),
    "shuffle-seed7": dict(shuffle=True, n_threads=2, seed=7),
    "resume-mid-epoch": dict(shuffle=True, n_threads=4, start_batch=5),
    "resume-next-epoch": dict(shuffle=True, n_threads=1, start_batch=11),
    "shard-1-of-3": dict(shuffle=True, n_threads=4, shard_index=1, shard_count=3),
    "keep-remainder": dict(shuffle=True, n_threads=4, drop_remainder=False, loop=False),
    "ordered-remainder": dict(shuffle=False, n_threads=1, drop_remainder=False, loop=False),
}


@needs_jax
@pytest.mark.parametrize("case", list(CASES))
def test_native_loader_delivers_the_jax_bindings_bytes(shards, case):
    kw = dict(batch_size=4, **CASES[case])
    with native_loader.NativeRecordLoader(shards, SPEC, **kw) as ours, \
            jax_loader.NativeRecordLoader(shards, _jax_spec(), **kw) as ref:
        assert ours.shard_records == ref.shard_records
        assert ours.batches_per_epoch == ref.batches_per_epoch
        records = ours.shard_records
        got, want = _drain(ours, 25), _drain(ref, 25)
    assert got == want and len(got) > 0
    if not kw.get("loop", True):  # one pass, every record once
        assert sum(len(b) for b in got) == SPEC.record_size * records


@needs_jax
@pytest.mark.parametrize("case", ["shuffle-1thread", "resume-mid-epoch", "shard-1-of-3",
                                  "keep-remainder"])
def test_python_loader_matches_jax_python_loader(shards, case):
    kw = dict(batch_size=4, **CASES[case])
    with native_loader.PythonRecordLoader(shards, SPEC, **kw) as ours, \
            jax_loader.PythonRecordLoader(shards, _jax_spec(), **kw) as ref:
        assert (ours.shard_records, ours.batches_per_epoch) == \
            (ref.shard_records, ref.batches_per_epoch)
        assert _drain(ours, 25) == _drain(ref, 25)


def test_an_epoch_reads_every_record_once_and_resume_continues_it(shards):
    """Within the first epoch ``start_batch`` resumes the stream exactly, and
    the resumed loader goes on into the next epoch as the straight one does.
    (Past the first epoch it does not: the C++ loader shuffles its index in
    place each epoch, so epoch e's order depends on the epochs before it,
    and a loader opened in epoch e >= 1 shuffles from the identity once.
    The JAX binding reads the same bytes there, which the parity cases
    ``resume-next-epoch`` hold.)"""
    with native_loader.NativeRecordLoader(shards, SPEC, batch_size=4, n_threads=4) as full:
        straight = [b.y.tolist() for b in full.batches(13)]
    epoch = [y for b in straight[:10] for y in b]
    # 41 records: 10 batches of distinct records, a random one left out.
    assert len(set(epoch)) == 40 and set(epoch) < set(range(41))
    with native_loader.NativeRecordLoader(shards, SPEC, batch_size=4, n_threads=1,
                                          start_batch=7) as resumed:
        assert [b.y.tolist() for b in resumed.batches(6)] == straight[7:13]


def test_shard_errors_are_typed(tmp_path, shards):
    with pytest.raises(native_loader.ShardFileError) as missing:
        native_loader.NativeRecordLoader([tmp_path / "nope.dlc"], SPEC, batch_size=2)
    assert missing.value.reason == "missing"
    cut = tmp_path / "cut.dlc"
    cut.write_bytes(shards[0].read_bytes()[:-5])
    for cls in (native_loader.NativeRecordLoader, native_loader.PythonRecordLoader):
        with pytest.raises(native_loader.ShardFileError) as truncated:
            cls([cut], SPEC, batch_size=2)
        assert truncated.value.reason == "truncated" and truncated.value.path == cut
    with pytest.raises(native_loader.LoaderError, match="record_size"):
        native_loader.NativeRecordLoader(shards, RecordSpec.classification((2, 2, 1), "uint8"),
                                         batch_size=2)
    with pytest.raises(native_loader.LoaderError, match="no record files"):
        native_loader.validate_shards([], SPEC)


def test_open_record_loader_falls_back_and_journals(shards, monkeypatch):
    recorder = FlightRecorder()
    monkeypatch.setattr("deeplearning_cfn_tpu_torch.obs.recorder._default", recorder)

    def broken(*a, **kw):
        raise native_loader.LoaderError("building the native loader failed: no compiler")

    monkeypatch.setattr(native_loader, "_load_library", broken)
    loader = native_loader.open_record_loader(shards, SPEC, 4, shuffle=False)
    assert isinstance(loader, native_loader.PythonRecordLoader)
    events = [e for e in recorder.tail() if e["kind"] == "datastream"]
    assert len(events) == 1 and events[0]["event"] == "native_fallback"
    assert "no compiler" in events[0]["error"]
    assert [int(y) for y in next(loader.batches(1)).y] == [0, 1, 2, 3]
    # A data failure is not a loader failure: no fall back.
    with pytest.raises(native_loader.ShardFileError):
        native_loader.open_record_loader([shards[0].with_name("gone.dlc")], SPEC, 4)
    assert isinstance(native_loader.open_record_loader(shards, SPEC, 4, force_python=True),
                      native_loader.PythonRecordLoader)


def test_open_record_loader_prefers_the_native_loader(shards):
    with native_loader.open_record_loader(shards, SPEC, 4) as loader:
        assert isinstance(loader, native_loader.NativeRecordLoader)


def test_decode_batch_never_aliases_the_reuse_buffer(tmp_path):
    spec = RecordSpec((Field("x", "int32", (6,)),))
    path = tmp_path / "tok.dlc"
    write_records(path, spec, [spec.encode(x=np.full((6,), i, np.int32)) for i in range(8)])
    with native_loader.NativeRecordLoader([path], spec, batch_size=4, n_threads=1,
                                          shuffle=False) as loader:
        raw = loader.next_raw(copy=False)
        decoded = spec.decode_batch(raw)["x"]
        assert not np.shares_memory(decoded, raw)
        snapshot = decoded.copy()
        loader.next_raw(copy=False)  # overwrites the reuse buffer
        np.testing.assert_array_equal(decoded, snapshot)


def test_token_batches_survive_buffer_reuse(tmp_path):
    spec = token_spec(5)
    path = tmp_path / "tok.dlc"
    write_records(path, spec, [spec.encode(x=np.full((5,), i, np.int32)) for i in range(12)])
    with native_loader.NativeRecordLoader([path], spec, batch_size=4, n_threads=1,
                                          shuffle=False) as loader:
        it = token_batches(loader, spec)
        first = next(it)
        x0, y0 = first.x.copy(), first.y.copy()
        next(it)
        next(it)
        np.testing.assert_array_equal(first.x, x0)
        np.testing.assert_array_equal(first.y, y0)


def test_next_raw_copies_by_default_and_a_closed_loader_raises(shards):
    loader = native_loader.NativeRecordLoader(shards, SPEC, batch_size=4, shuffle=False)
    first = loader.next_raw()
    snapshot = first.copy()
    loader.next_raw()
    np.testing.assert_array_equal(first, snapshot)
    loader.close()
    loader.close()
    with pytest.raises(native_loader.LoaderError, match="closed"):
        loader.next_raw()


def test_the_loader_builds_into_a_clean_directory(tmp_path):
    """Four builds at once into an empty directory: one library, no
    temporary file left, and it loads and reads."""
    built, errors = [], []

    def build():
        try:
            built.append(native_loader.build_library(tmp_path / "torch_native"))
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(built)) == 1 and built[0].exists()
    assert built[0] == native_loader.library_path(tmp_path / "torch_native")
    assert sorted(p.name for p in built[0].parent.iterdir()) == ["build.lock", built[0].name]
    lib = native_loader._load_library(tmp_path / "torch_native")
    assert lib.dlcfn_loader_open.restype is not None


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native_loader, "LOADER_SRC", bad)
    with pytest.raises(native_loader.LoaderError, match="error") as failed:
        native_loader.build_library(tmp_path / "out")
    assert "building the native loader failed" in str(failed.value)
    assert not list((tmp_path / "out").glob("*.so*"))
