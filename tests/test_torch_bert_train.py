"""The port's BERT training against the JAX package's, on the CPU.

- The synthetic MLM and classification streams are byte-identical to the
  JAX package's for the same seeds.
- Three adamw steps of ``BertConfig.tiny`` (f32) from the same weights on the
  same MLM batches, through the JAX trainer on a 1-device mesh and the port's
  ``bert.make_trainer``, with the MLP dense and fused.  Tolerance: as the
  Llama trainer test (tests/test_torch_trainer.py): losses to 1e-5 relative;
  parameters to 2e-6 absolute after three steps at lr 1e-3, except that Adam
  divides by sqrt(nu), so an element whose gradient sits at the rounding
  level of its tensor gets a direction decided by rounding: at most 0.1% of
  a tensor's elements may differ by more, and none by more than Adam's own
  bound, lr per step.  The key third of each ``qkv`` bias is such a tensor
  throughout: a softmax is unchanged by a shift of its scores, so that
  bias's true gradient is 0 and both frameworks see rounding noise; it is
  held to Adam's bound alone.
- The default classification objective against the JAX trainer's.
- ``bert_pretrain.main`` and ``bert_finetune.main`` end to end at the tiny
  size on the CPU, and their boundaries.
"""

import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import bert as jax_bert  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import softmax_xent as jax_softmax_xent  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples import bert_finetune, bert_pretrain  # noqa: E402
from deeplearning_cfn_tpu_torch.models import bert  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402

torch.set_num_threads(1)

SEQ, VOCAB, BATCH, STEPS, LR = 32, 256, 4, 3, 1e-3


@pytest.mark.parametrize(
    "kw", [{}, {"seed": 3, "structure_seed": 7, "mask_prob": 0.3}, {"mask_token": 5}])
def test_synthetic_mlm_stream_is_byte_identical_to_jax(kw):
    ours = data.SyntheticMLMDataset(seq_len=16, vocab_size=100, batch_size=3, **kw)
    ref = jax_data.SyntheticMLMDataset(seq_len=16, vocab_size=100, batch_size=3, **kw)
    for a, b in zip(ours.batches(3), ref.batches(3)):
        assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
        assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("kw", [{}, {"seed": 10_000, "template_seed": 0}])
def test_synthetic_classification_stream_is_byte_identical_to_jax(kw):
    ours = data.SyntheticSeqClassificationDataset(batch_size=5, seq_len=8, **kw)
    ref = jax_data.SyntheticSeqClassificationDataset(batch_size=5, seq_len=8, **kw)
    for a, b in zip(ours.batches(3), ref.batches(3)):
        assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
        assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("pallas", [False, True], ids=["dense", "fused"])
def test_three_adamw_steps_match_jax_trainer(pallas):
    kwargs = dict(optimizer="adamw", learning_rate=LR, weight_decay=0.01, grad_clip_norm=1.0,
                  log_every=1, strategy="fsdp")
    jcfg = dataclasses.replace(jax_bert.BertConfig.tiny(vocab_size=VOCAB, seq_len=SEQ),
                               use_pallas_mlp=pallas)
    tcfg = dataclasses.replace(bert.BertConfig.tiny(vocab_size=VOCAB, seq_len=SEQ),
                               use_pallas_mlp=pallas)
    model = jax_bert.BertEncoder(jcfg)
    jtrainer = JaxTrainer(model, build_mesh(MeshSpec(), jax.devices()[:1]),
                          JaxTrainerConfig(**kwargs), loss_fn=jax_bert.mlm_loss(model))
    jds = jax_data.SyntheticMLMDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    jstate = jtrainer.init(jax.random.key(0), jnp.asarray(next(iter(jds.batches(1))).x))
    init_params = jax.device_get(jstate.params)  # before fit donates the state
    jstate, jlosses = jtrainer.fit(jstate, jds.batches(STEPS), steps=STEPS, prefetch=0)
    jfinal = jax.device_get(jstate.params)

    ttrainer = bert.make_trainer(tcfg, trainer.TrainerConfig(**kwargs), device="cpu")
    tstate = ttrainer.init(seed=0)
    tstate.model.load_state_dict(interop.bert_params_from_jax(tcfg, init_params))
    tds = data.SyntheticMLMDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    tstate, tlosses = ttrainer.fit(tstate, tds.batches(STEPS), steps=STEPS)

    assert tstate.step == STEPS and len(tlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = interop.bert_params_from_jax(tcfg, jfinal)
    d = tcfg.dim
    for name, p in tstate.model.state_dict().items():
        diff = np.abs(p.numpy() - final[name].numpy())
        assert diff.max() <= LR * STEPS, name
        if name.endswith("qkv.bias"):
            diff = np.concatenate([diff[:d], diff[2 * d:]])  # the q and v parts
        assert np.mean(diff > 2e-6) <= 1e-3, (name, diff.max())


def test_default_objective_matches_jax_softmax_xent():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    got = trainer.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    loss, aux = trainer.Trainer(lambda g: None, trainer.TrainerConfig(), device="cpu")._loss(
        lambda x: x, torch.from_numpy(logits), torch.from_numpy(labels))
    assert loss.item() == got.item()
    assert aux["accuracy"].item() == pytest.approx(np.mean(logits.argmax(-1) == labels))


def test_label_smoothing_is_out_of_slice():
    """Label smoothing came into the port with the image slice: the default
    objective's smoothed cross-entropy equals the JAX trainer's."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    got = trainer.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), 0.1)
    want = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 0.1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    trainer.Trainer(lambda g: None, trainer.TrainerConfig(label_smoothing=0.1), device="cpu")


@pytest.mark.parametrize("pallas", [False, True], ids=["dense", "fused"])
def test_pretrain_main_runs_tiny_on_cpu_and_the_loss_falls(pallas):
    result = bert_pretrain.main(
        ["--tiny", "--device", "cpu", "--steps", "30", "--seq_len", "32",
         "--global_batch_size", "8", "--log_every", "1", "--learning_rate", "1e-3",
         "--eval_steps", "1", *(["--use_pallas_mlp"] if pallas else [])]
    )
    losses = [h["loss"] for h in result["history"]]
    assert result["steps"] == 30 and result["device"] == "cpu" and len(losses) == 30
    assert all(np.isfinite(losses)) and result["final_loss"] == losses[-1]
    assert statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    assert result["params"] == bert.param_count(bert.BertConfig.tiny(seq_len=32))
    assert "mfu" not in result["history"][0]  # no device peak on the CPU
    assert result["eval"]["split"] == "heldout-synthetic" and result["eval"]["examples"] == 8
    assert set(result["eval"]) >= {"loss", "masked_accuracy", "perplexity"}


def test_pretrain_main_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bert_pretrain.main(["--tiny", "--steps", "1"])


@pytest.mark.parametrize("flags", [["--data_dir", "/nonexistent"]])
def test_pretrain_out_of_slice_flags_raise(flags):
    # --data_dir is ported: a directory that does not exist is the user's error.
    with pytest.raises(SystemExit, match="none of"):
        bert_pretrain.main(["--tiny", "--steps", "1", "--device", "cpu", *flags])


def test_pretrain_vocab_size_needs_tiny():
    with pytest.raises(SystemExit):
        bert_pretrain.main(["--vocab_size", "300", "--steps", "1", "--device", "cpu"])


def test_finetune_main_runs_tiny_on_cpu():
    result = bert_finetune.main(
        ["--tiny", "--device", "cpu", "--pretrain_steps", "3", "--steps", "20",
         "--seq_len", "16", "--global_batch_size", "8", "--log_every", "5", "--eval_steps", "2"]
    )
    assert result["pretrained"] and result["steps"] == 20
    assert np.isfinite(result["final_loss"])
    assert result["eval"]["examples"] == 16 and 0.0 <= result["eval"]["accuracy"] <= 1.0
