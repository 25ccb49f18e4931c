"""The throughput record after a restore, on the CPU.

A run resumed at step s used to count its first interval from step 0, so
its first ``examples_per_sec`` (and MFU) read about s + 1 times too high
(the JAX logger does the same; the port's is a deliberate difference).
``Trainer.fit`` now calls ``ThroughputLogger.resume(state.step)``: a logger
not yet driven to that step re-anchors there, and one that was (a new run,
a later ``fit`` of the same run) keeps JAX's count and clock.  The clock is
a fake ``perf_counter`` inside ``train.metrics`` that moves one second a
call, so the rates are exact.
"""

import types

import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch.examples import cifar10_train, lenet_mnist  # noqa: E402
from deeplearning_cfn_tpu_torch.train import metrics  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture()
def fake_time(monkeypatch):
    """``train.metrics``' clock: one second a ``perf_counter`` call."""
    import time as real

    ticks = {"n": 0.0}

    def perf_counter():
        ticks["n"] += 1.0
        return ticks["n"]

    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(perf_counter=perf_counter,
                                                               time=real.time))
    return ticks


def test_logger_resumes_only_where_it_was_not_driven(fake_time):
    log = metrics.ThroughputLogger(global_batch_size=8, log_every=1,
                                   flops_per_step=1.0, peak_flops=4.0)
    log.resume(0)  # a new run: the clock from construction
    log.step(1, torch.tensor(1.0))  # one step in one second
    log.resume(1)  # driven there: nothing moves
    log.resume(5)  # a restored step: count from 5, the clock from now
    log.step(7, torch.tensor(1.0))  # two steps in one second
    assert [(r["step"], r["examples_per_sec"], r["mfu"]) for r in log.history] == [
        (1, 8.0, 0.25), (7, 16.0, 0.5)]
    # A step seen but not logged still counts as driven.
    log = metrics.ThroughputLogger(global_batch_size=8, log_every=2)
    log.step(1, torch.tensor(1.0))
    log.resume(1)
    log.step(2, torch.tensor(1.0))  # two steps in one second (a re-anchor: one)
    assert [(r["step"], r["examples_per_sec"]) for r in log.history] == [(2, 16.0)]


@pytest.mark.parametrize("example, batch", [(lenet_mnist, 32), (cifar10_train, 4)],
                         ids=["lenet", "cifar10"])
def test_resumed_run_counts_only_its_own_steps(tmp_path, fake_time, example, batch):
    """2 steps and a save, then 2 resumed steps: the resumed run's first
    record is the straight run's (one step a second), not 3x it."""
    extra = ["--model", "vgg11"] if example is cifar10_train else []
    argv = ["--device", "cpu", "--log_every", "1", "--global_batch_size", str(batch), *extra]
    straight = example.main(argv + ["--steps", "4"])
    ckpt = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    first = example.main(argv + ["--steps", "2", *ckpt])
    resumed = example.main(argv + ["--steps", "2", *ckpt])
    assert (first["end_step"], resumed["start_step"], resumed["end_step"]) == (2, 2, 4)
    rates = [r["examples_per_sec"] for r in straight["history"]]
    assert rates == [float(batch)] * 4
    assert [r["step"] for r in resumed["history"]] == [3, 4]
    assert [r["examples_per_sec"] for r in resumed["history"]] == rates[2:]


def test_fit_reanchors_a_logger_made_before_the_restore(fake_time):
    """A logger built at step 0 handed to ``fit`` with a state at step 3, as
    after a restore, counts from step 3."""
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=16, dtype=torch.float32)
    trainer = llama.make_trainer(cfg, TrainerConfig(log_every=1), device="cpu")
    state = trainer.init(seed=0)
    state.step = 3
    log = metrics.ThroughputLogger(global_batch_size=4, log_every=1)
    ds = SyntheticTokenDataset(seq_len=16, vocab_size=64, batch_size=4)
    state, _ = trainer.fit(state, ds.batches(2), steps=2, logger=log, prefetch=0)
    assert [(r["step"], r["examples_per_sec"]) for r in log.history] == [(4, 4.0), (5, 4.0)]


def test_a_later_fit_of_the_same_run_keeps_its_clock(fake_time):
    """Two ``fit`` calls on one logger, as ``resnet_imagenet
    --target_accuracy`` makes them: the time between them (its eval) counts
    in the next record, as in JAX's logger."""
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=16, dtype=torch.float32)
    trainer = llama.make_trainer(cfg, TrainerConfig(log_every=1), device="cpu")
    state = trainer.init(seed=0)
    log = metrics.ThroughputLogger(global_batch_size=4, log_every=1)
    ds = SyntheticTokenDataset(seq_len=16, vocab_size=64, batch_size=4)
    state, _ = trainer.fit(state, ds.batches(2), steps=2, logger=log, prefetch=0)
    fake_time["n"] += 3.0  # three seconds between the calls
    state, _ = trainer.fit(state, ds.batches(1), steps=1, logger=log, prefetch=0)
    assert [(r["step"], r["examples_per_sec"]) for r in log.history] == [
        (1, 4.0), (2, 4.0), (3, 1.0)]
