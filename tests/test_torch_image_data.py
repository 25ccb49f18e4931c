"""The port's image input stage against the JAX package's, on the CPU.

- ``SyntheticDataset``: byte-identical batches for the same arguments
  (fresh and pooled streams, f32 and uint8, ``template_seed``), and equal
  ``input_stats``.
- ``dequantize_normalize``: the same f32 ops in the same order, so within
  one f32 ulp of |x| <= ~4 (1e-6 absolute); bf16 results within one bf16 ulp.
- ``DeviceAugment.apply`` on the JAX stage's own decisions (its
  ``fold_in``/``split``/``bernoulli``/``randint`` calls replayed here):
  flips, random and centre crops and pad-and-crop are gathers and selects,
  so equal.  The port's own decisions are drawn from a ``torch.Generator``
  (other bits): held to be deterministic in (seed, step) and in range.
- ``DevicePrefetcher``: source order at 1 and 3 workers, a source exception
  at its position, ``close()`` stopping every producer, and
  ``PipelineStats`` snapshot keys and fold equal to the JAX package's.
- ``stack_batches`` equal to the JAX package's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.train import augment as jax_augment  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train import pipeline as jax_pipeline  # noqa: E402
from deeplearning_cfn_tpu_torch.models import resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.train import augment, data, pipeline, trainer  # noqa: E402

torch.set_num_threads(1)


# --- SyntheticDataset --------------------------------------------------------

DATASETS = {
    "fresh-f32": dict(shape=(8, 8, 3), num_classes=5, batch_size=4),
    "fresh-uint8": dict(shape=(8, 8, 3), num_classes=5, batch_size=4, dtype="uint8", seed=3),
    "pooled-uint8": dict(shape=(6, 6, 3), num_classes=7, batch_size=3, dtype="uint8",
                         pool_batches=2),
    "held-out": dict(shape=(8, 8, 1), num_classes=4, batch_size=2, seed=10_000, template_seed=0),
    "noise": dict(shape=(4, 4, 2), batch_size=5, noise_scale=0.25, pool_batches=3,
                  dtype="float32"),
}


@pytest.mark.parametrize("case", list(DATASETS))
def test_synthetic_dataset_is_byte_identical_to_jax(case):
    ours = data.SyntheticDataset(**DATASETS[case])
    ref = jax_data.SyntheticDataset(**DATASETS[case])
    assert ours.input_stats == ref.input_stats
    n = 0
    for a, b in zip(ours.batches(5), ref.batches(5)):
        assert a.x.dtype == b.x.dtype and a.x.shape == b.x.shape and a.x.tobytes() == b.x.tobytes()
        assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()
        n += 1
    assert n == 5


def test_synthetic_dataset_constructors_match_jax():
    kw = dict(batch_size=2, image_size=16, dtype="uint8", pool_batches=2)
    a = next(iter(data.SyntheticDataset.imagenet_like(**kw).batches(1)))
    b = next(iter(jax_data.SyntheticDataset.imagenet_like(**kw).batches(1)))
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()


# --- dequantize_normalize ------------------------------------------------------


def _uint8_images(seed=0, shape=(2, 5, 5, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_dequantize_normalize_matches_jax(dtype):
    x = _uint8_images()
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = jax_pipeline.dequantize_normalize(jnp.asarray(x), mean, std,
                                             jnp.bfloat16 if dtype else None)
    got = pipeline.dequantize_normalize(torch.from_numpy(x), mean, std,
                                        torch.bfloat16 if dtype else None)
    assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype:
        got32 = got.float().numpy()
        assert np.all(np.abs(got32 - want) <= 2**-8 * np.abs(want) + 1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_dequantize_normalize_passes_float_through():
    x = torch.randn(2, 3, 3, 3)
    assert pipeline.dequantize_normalize(x, (0.5,) * 3, (0.1,) * 3) is x
    assert pipeline.dequantize_normalize(x, (0.5,) * 3, (0.1,) * 3, torch.bfloat16).dtype == \
        torch.bfloat16


def test_nbytes_of_matches_jax():
    tree = (np.zeros((3, 4), np.uint8), {"a": np.zeros(5, np.float32), "b": [np.zeros(2)]})
    assert pipeline.nbytes_of(tree) == jax_pipeline.nbytes_of(tree)
    assert pipeline.nbytes_of(torch.zeros(3, 4)) == 48


# --- DeviceAugment -------------------------------------------------------------


def _jax_decisions(aug, step, b, h, w):
    """The JAX stage's own flips and windows for ``step``, by replaying its
    key derivation (train/augment.py)."""
    key = jax.random.fold_in(jax.random.key(aug.seed), step)
    crop_key, flip_key = jax.random.split(key)
    ys = xs = flips = None
    if aug.crop is not None:
        th, tw = aug.crop
        if (h, w) == (th, tw) and aug.pad:
            h, w = h + 2 * aug.pad, w + 2 * aug.pad
        if (h, w) != (th, tw):
            if aug.random_crop:
                ky, kx = jax.random.split(crop_key)
                ys = jax.random.randint(ky, (b,), 0, h - th + 1)
                xs = jax.random.randint(kx, (b,), 0, w - tw + 1)
            else:
                ys = jnp.full((b,), (h - th) // 2)
                xs = jnp.full((b,), (w - tw) // 2)
    if aug.flip:
        flips = jax.random.bernoulli(flip_key, 0.5, (b,))
    return tuple(None if d is None else torch.from_numpy(np.asarray(d).astype(
        bool if d.dtype == jnp.bool_ else np.int64)) for d in (flips, ys, xs))


AUGMENTS = {
    "flip": (dict(flip=True, seed=1), (8, 8)),
    "random-crop": (dict(crop=(5, 6), seed=2), (8, 9)),
    "centre-crop": (dict(crop=(5, 6), random_crop=False), (8, 9)),
    "pad-and-crop": (dict(crop=(8, 8), pad=2, seed=3), (8, 8)),
    "flip-and-crop": (dict(flip=True, crop=(6, 6), seed=4), (9, 7)),
    "same-size-no-pad": (dict(crop=(8, 8), seed=5), (8, 8)),
}


@pytest.mark.parametrize("x_dtype", ["uint8", "f32"])
@pytest.mark.parametrize("case", list(AUGMENTS))
def test_augment_apply_matches_jax_on_its_decisions(case, x_dtype):
    kw, (h, w) = AUGMENTS[case]
    x = _uint8_images(seed=6, shape=(6, h, w, 3))
    if x_dtype == "f32":
        x = np.random.default_rng(7).standard_normal((6, h, w, 3)).astype(np.float32)
    jaug, taug = jax_augment.DeviceAugment(**kw), augment.DeviceAugment(**kw)
    assert jaug.is_identity == taug.is_identity
    for step in (0, 5):
        want = np.asarray(jaug(jnp.asarray(step), jnp.asarray(x)))
        got = taug.apply(torch.from_numpy(x), *_jax_decisions(jaug, step, 6, h, w))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_augment_decisions_are_deterministic_per_step_and_in_range():
    aug = augment.DeviceAugment(flip=True, crop=(5, 6), seed=9)
    first = aug.decisions(3, 64, 8, 9)
    again = aug.decisions(3, 64, 8, 9)
    other = aug.decisions(4, 64, 8, 9)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(first, other))
    flips, ys, xs = first
    assert flips.dtype == torch.bool and 0 < int(flips.sum()) < 64
    assert ys.min() >= 0 and ys.max() <= 3 and xs.min() >= 0 and xs.max() <= 3
    out = aug(3, torch.from_numpy(_uint8_images(shape=(64, 8, 9, 3))))
    assert out.shape == (64, 5, 6, 3) and out.dtype == torch.uint8
    with pytest.raises(ValueError, match="cannot crop"):
        augment.DeviceAugment(crop=(9, 9)).decisions(0, 1, 8, 8)
    assert augment.DeviceAugment().is_identity


def test_trainer_augments_train_steps_only():
    """A crop to 28x28 reaches the model in train steps; eval sees 32x32."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, 10))

        def forward(self, x, train=True):
            seen.append((tuple(x.shape), x.dtype, train))
            return x.mean(dim=(1, 2)) @ self.w

    cfg = trainer.TrainerConfig(has_train_arg=True, input_stats=((0.5,) * 3, (0.125,) * 3),
                                augment=augment.DeviceAugment(flip=True, crop=(28, 28)))
    ttrainer = trainer.Trainer(lambda g: Probe(), cfg, device="cpu")
    state = ttrainer.init()
    x = torch.from_numpy(_uint8_images(shape=(2, 32, 32, 3)))
    y = torch.zeros(2, dtype=torch.int32)
    ttrainer.train_step(state, x, y)
    ttrainer.eval_step(state, x, y)
    assert seen == [((2, 28, 28, 3), torch.float32, True), ((2, 32, 32, 3), torch.float32, False)]


def test_trainer_bf16_compute_casts_the_normalised_input():
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, 10))

        def forward(self, x):
            seen.append(x.dtype)
            return x.float().mean(dim=(1, 2)) @ self.w

    cfg = trainer.TrainerConfig(bf16_compute=True, input_stats=((0.5,) * 3, (0.125,) * 3))
    ttrainer = trainer.Trainer(lambda g: Probe(), cfg, device="cpu")
    x = torch.from_numpy(_uint8_images(shape=(2, 4, 4, 3)))
    ttrainer.train_step(ttrainer.init(), x, torch.zeros(2, dtype=torch.int32))
    assert seen == [torch.bfloat16]


# --- stack_batches ---------------------------------------------------------------


def test_stack_batches_matches_jax():
    ds = dict(shape=(4, 4, 3), num_classes=3, batch_size=2, dtype="uint8")
    ours = list(data.stack_batches(data.SyntheticDataset(**ds).batches(7), 3))
    ref = list(jax_data.stack_batches(jax_data.SyntheticDataset(**ds).batches(7), 3))
    assert len(ours) == len(ref) == 2  # the ragged tail is not yielded
    for a, b in zip(ours, ref):
        assert a.x.shape == (3, 2, 4, 4, 3) and a.x.tobytes() == np.asarray(b.x).tobytes()
        assert a.y.tobytes() == np.asarray(b.y).tobytes()
    trees = [data.Batch(x=np.full(2, i), y={"a": np.full(1, i)}) for i in range(2)]
    (stacked,) = data.stack_batches(iter(trees), 2)
    assert stacked.y["a"].tolist() == [[0], [1]]
    with pytest.raises(ValueError):
        next(data.stack_batches(iter(trees), 0))


# --- DevicePrefetcher and PipelineStats -------------------------------------------


def _slow_source(n, fail_at=None):
    rng = np.random.default_rng(0)
    for i in range(n):
        if i == fail_at:
            raise RuntimeError(f"source failed at {i}")
        time.sleep(float(rng.uniform(0, 0.003)))
        yield data.Batch(x=np.full((2, 3), i, np.float32), y=np.full(2, i, np.int32))


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_keeps_source_order(workers):
    stats = pipeline.PipelineStats(name="test")
    with data.DevicePrefetcher(_slow_source(20), "cpu", size=2, workers=workers,
                               stats=stats) as pf:
        got = [int(b.x[0, 0]) for b in pf]
    assert got == list(range(20))
    snap = stats.snapshot()
    assert snap["batches"] == 20 and snap["bytes_transferred"] == 20 * (24 + 8)
    assert snap["host_input_seconds"] > 0 and 0.0 <= snap["overlap_fraction"] <= 1.0


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_raises_at_the_failing_position(workers):
    got = []
    with pytest.raises(RuntimeError, match="source failed at 7"):
        for b in data.DevicePrefetcher(_slow_source(20, fail_at=7), "cpu", workers=workers):
            got.append(int(b.y[0]))
    assert got == list(range(7))


def test_prefetcher_close_stops_every_producer():
    def endless():
        i = 0
        while True:
            yield data.Batch(x=np.full(2, i), y=np.full(2, i))
            i += 1

    pf = data.DevicePrefetcher(endless(), "cpu", size=2, workers=3)
    it = iter(pf)
    assert [int(next(it).x[0]) for _ in range(3)] == [0, 1, 2]
    pf.close()
    for t in pf._threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in pf._threads)
    before = threading.active_count()
    with data.DevicePrefetcher(endless(), "cpu", workers=2) as pf2:
        next(iter(pf2))
    for t in pf2._threads:
        t.join(timeout=5)
    assert threading.active_count() <= before


def test_pipeline_stats_snapshot_keys_and_fold_match_jax():
    ours, ref = pipeline.PipelineStats("fit"), jax_pipeline.PipelineStats("fit")
    for s in (ours, ref):
        s.add_transfer(100)
        s.add_host_input(0.5)
        s.add_producer_stall(0.25)
        s.add_consumer_wait(0.125)
    a, b = ours.snapshot(), ref.snapshot()
    assert list(a) == list(b)
    for key in ("name", "source", "batches", "bytes_transferred", "host_input_seconds",
                "producer_stall_seconds", "consumer_wait_seconds"):
        assert a[key] == b[key], key
    events = [dict(a, elapsed_seconds=2.0), dict(b, name="eval", source="records"),
              dict(a, elapsed_seconds=1.0), {"name": 3}]
    assert pipeline.fold_pipeline_events(events) == jax_pipeline.fold_pipeline_events(events)


def test_pipeline_stats_journal_once(tmp_path):
    rec = recorder.FlightRecorder(path=tmp_path / "journal.jsonl")
    stats = pipeline.PipelineStats("fit")
    assert stats.journal(rec) is None  # nothing flowed
    stats.add_transfer(10)
    snap = stats.journal(rec)
    assert snap is not None and stats.journal(rec) is None
    events = [e for e in rec.tail() if e["kind"] == "input_pipeline"]
    assert len(events) == 1 and events[0]["bytes_transferred"] == 10
    rec.close()


def test_fit_records_the_pipeline_counters():
    cfg = trainer.TrainerConfig(has_train_arg=True, learning_rate=0.01,
                                input_stats=((0.5,) * 3, (0.125,) * 3))
    ttrainer = trainer.Trainer(
        lambda g: resnet.ResNet(stage_sizes=(1,), num_filters=4, num_classes=3, generator=g),
        cfg, device="cpu")
    ds = data.SyntheticDataset(shape=(16, 16, 3), num_classes=3, batch_size=2, dtype="uint8")
    state, losses = ttrainer.fit(ttrainer.init(), ds.batches(4), steps=4, prefetch_workers=2)
    snap = ttrainer.last_pipeline_stats.snapshot()
    assert len(losses) == 4 and snap["batches"] == 4
    assert snap["bytes_transferred"] == 4 * (2 * 16 * 16 * 3 + 2 * 4)
    state, _ = ttrainer.fit(state, ds.batches(2), steps=2, prefetch=0)
    assert ttrainer.last_pipeline_stats.snapshot()["batches"] == 0  # inline copies
