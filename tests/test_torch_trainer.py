"""The port's trainer against the JAX package's, on the CPU.

Three optimizer steps of ``LlamaConfig.tiny`` at f32 from the same weights on
the same synthetic batches: the JAX side is ``llama.make_trainer`` on a
1-device mesh, the port's is its ``make_trainer``.  Tolerance: the step is
f32 throughout; the two sides sum gradients and the global norm in another
order, so losses agree to 1e-5 relative and parameters (O(0.1), moved by
~lr per step) to 2e-6 absolute after three steps.  The one exception is
Adam's: its update divides by sqrt(nu), so an element whose gradient sits
at the rounding level of the gradient's scale gets a direction decided by
rounding.  At most 0.1% of a tensor's elements may differ by more than
2e-6, and none by more than Adam's own bound, lr per step.

Also: the schedules against optax's, the clip against optax's, the decay
mask, the synthetic data stream, and the metric helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train import schedules as jax_schedules  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, metrics, schedules, trainer  # noqa: E402

torch.set_num_threads(1)

SEQ, VOCAB, BATCH, STEPS = 32, 256, 4, 3

# (optimizer, grad_accum_steps, lr schedule kind)
CASES = {
    "adamw": ("adamw", 1, "constant"),
    "adamw-accum2": ("adamw", 2, "constant"),
    "adamw-cosine": ("adamw", 1, "cosine"),
    "momentum": ("momentum", 1, "constant"),
}


def _trainer_kwargs(optimizer, accum, lr_schedule):
    lr = 1e-3 if optimizer == "adamw" else 1e-2
    return dict(
        optimizer=optimizer,
        learning_rate=lr,
        weight_decay=0.1,
        grad_clip_norm=1.0,
        grad_accum_steps=accum,
        log_every=1,
        strategy="fsdp",
    ), lr, lr_schedule


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_trainer(case):
    kwargs, lr, kind = _trainer_kwargs(*CASES[case])
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32)
    tcfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)

    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    jtrainer = jax_llama.make_trainer(
        jcfg, mesh,
        JaxTrainerConfig(lr_schedule=jax_schedules.build_schedule(kind, lr, STEPS, 1), **kwargs),
    )
    jds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    jstate = jtrainer.init(jax.random.key(0), jnp.asarray(next(iter(jds.batches(1))).x))
    init_params = jax.device_get(jstate.params)  # before fit donates the state
    jstate, jlosses = jtrainer.fit(jstate, jds.batches(STEPS), steps=STEPS, prefetch=0)
    jfinal = jax.device_get(jstate.params)

    ttrainer = llama.make_trainer(
        tcfg,
        trainer.TrainerConfig(lr_schedule=schedules.build_schedule(kind, lr, STEPS, 1), **kwargs),
        device="cpu",
    )
    tstate = ttrainer.init(seed=0)
    tstate.model.load_state_dict(interop.llama_params_from_jax(tcfg, init_params))
    tds = data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    tstate, tlosses = ttrainer.fit(tstate, tds.batches(STEPS), steps=STEPS)

    assert tstate.step == STEPS and len(tlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = interop.llama_params_from_jax(tcfg, jfinal)
    for name, p in tstate.model.state_dict().items():
        diff = np.abs(p.numpy() - final[name].numpy())
        assert diff.max() <= lr * STEPS, name
        assert np.mean(diff > 2e-6) <= 1e-3, (name, diff.max())


def test_decay_mask_reads_leaf_names():
    model = llama.Llama(llama.LlamaConfig.tiny(dtype=torch.float32))
    mask = trainer.decay_mask(model.named_parameters())
    assert mask["embed"] and mask["layers.0.wq"] and mask["layers.1.w_down"]
    assert not mask["final_norm"] and not mask["layers.0.attn_norm"] and not mask["layers.1.mlp_norm"]
    fake = [("proj.bias", torch.zeros(2, 2)), ("normalizer_proj", torch.zeros(2, 2)),
            ("layer_scale", torch.zeros(3, 3)), ("w", torch.zeros(3))]
    assert trainer.decay_mask(fake) == {
        "proj.bias": False, "normalizer_proj": True, "layer_scale": False, "w": False,
    }


@pytest.mark.parametrize("above", [True, False])
def test_clip_matches_optax(above):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) * (1.0 if above else 0.01) for s in ((3, 4), (5,))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = trainer.clip_by_global_norm(params, 1.0)
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for p, c in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize(
    "kind,warmup,boundaries",
    [("cosine", None, None), ("cosine", 0, None), ("cosine", 3, None),
     ("step", None, None), ("step", 2, [5, 8]), ("step", 0, [4])],
)
def test_schedules_match_optax_from_step_zero(kind, warmup, boundaries):
    total = 10
    ours = schedules.build_schedule(kind, 0.1, total, warmup, boundaries)
    ref = jax_schedules.build_schedule(kind, 0.1, total, warmup, boundaries)
    for step in range(total + 3):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-9)
    assert schedules.build_schedule("constant", 0.1, total) is None


def test_synthetic_tokens_are_byte_identical_to_jax():
    ours = data.SyntheticTokenDataset(seq_len=16, vocab_size=100, batch_size=3, seed=5)
    ref = jax_data.SyntheticTokenDataset(seq_len=16, vocab_size=100, batch_size=3, seed=5)
    for a, b in zip(ours.batches(3), ref.batches(3)):
        assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
        assert a.y.tobytes() == b.y.tobytes()


def test_gpu_peaks_tell_the_parts_apart():
    assert metrics.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert metrics.peak_hbm_bytes_per_chip("NVIDIA H100 80GB HBM3") == 3.35e12
    assert metrics.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    assert metrics.peak_flops_per_chip("NVIDIA H100 NVL") == 835e12
    assert metrics.peak_f32_flops_per_chip("NVIDIA H100 80GB HBM3") == 67e12
    assert metrics.peak_flops_per_chip("TPU v5 lite") is None
    assert metrics.utilization(1.0, None) is None and metrics.utilization(1.0, 4.0) == 0.25
    assert metrics.json_safe({"a": float("nan"), "b": torch.tensor(2.0)}) == {"a": None, "b": 2.0}


def test_throughput_logger_and_sink(tmp_path):
    sink = metrics.JsonlMetricsSink.for_run(tmp_path, "llama")
    log = metrics.ThroughputLogger(global_batch_size=8, log_every=2, sink=sink,
                                   flops_per_step=1e9, peak_flops=1e12)
    for step in (1, 2, 3, 4):
        log.step(step, torch.tensor(float(step)))
    sink.close()
    assert [r["step"] for r in log.history] == [2, 4] and "mfu" in log.history[0]
    lines = (tmp_path / "llama" / "worker0.jsonl").read_text().splitlines()
    assert len(lines) == 2


@pytest.mark.parametrize("kw", [{"profiler": object()}, {"reshard": object()}])
def test_out_of_slice_fit_options_raise(kw):
    ttrainer = llama.make_trainer(llama.LlamaConfig.tiny(dtype=torch.float32),
                                  trainer.TrainerConfig(), device="cpu")
    if "profiler" in kw:  # ported (tests/test_torch_profiler.py): a step profiler is taken
        from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler

        assert ttrainer.fit(None, iter(()), steps=1, profiler=StepProfiler()) == (None, [])
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        ttrainer.fit(None, iter(()), steps=1, **kw)


def test_out_of_slice_trainer_options_raise():
    """comms_overlap is ported (``tests/test_torch_overlap.py``): without a
    mesh there is one data rank, which JAX's gate refuses with this message;
    overlap_compress alone changes nothing, as in JAX (it rides the overlap)."""
    with pytest.raises(ValueError, match="more than one device"):
        trainer.Trainer(lambda g: None, trainer.TrainerConfig(comms_overlap=True),
                        loss_fn=None, device="cpu")
    trainer.Trainer(lambda g: None, trainer.TrainerConfig(overlap_compress=True),
                    loss_fn=None, device="cpu")
