"""The port's ResNet training against the JAX package's, on the CPU.

- Three Nesterov-momentum steps (lr 0.1, ``weight_decay=1e-4`` masked to
  conv and dense kernels) of ``ResNet(stage_sizes=(1, 1), num_filters=8,
  num_classes=10)`` in f32 on 32x32 uint8 images, from the same weights on
  the same batch, through the JAX ``Trainer`` on a 1-device mesh and the
  port's, with ``input_stats``, ``label_smoothing=0.1``, ``has_train_arg``
  and ``grad_accum_steps`` 1 and 2, each head.  Tolerances: both sides are
  f32 and sum the convolutions, the batch statistics and the gradients in
  another order, so losses agree to 1e-5 relative; parameters (O(0.1),
  moved by up to ~lr·|g| a step) and BatchNorm statistics to 1e-5 absolute
  after three steps.
- ``evaluate`` against the JAX ``evaluate`` on two held-out batches
  (eval mode, running statistics): loss to 1e-5 relative, accuracy equal.
- ``multi_step_fn(2)`` on the CPU against two ``train_step``s, and
  ``fit(steps_per_call=k)`` (k 2, 3, 6 over 5 batches) against single
  steps: bitwise (the same ops).
- ``resnet_imagenet.main`` end to end at a tiny size on the CPU, and its
  boundaries.

On the card (``cuda``-marked, skipped here): the kernel head's forward and
backward inside a ResNet step against ``force_reference()``, and a captured
``multi_step_fn(2)`` against eager steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import resnet as jax_resnet
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.train import data as jax_data
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples import resnet_imagenet  # noqa: E402
from deeplearning_cfn_tpu_torch.models import resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import _kernels  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import fused_dense as fd  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

F32_SPLITK = "wgmma_tma_bf16x6_splitk_128x192"


ARCH = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
SHAPE, BATCH, STEPS, LR = (32, 32, 3), 8, 3, 0.1


def _dataset(seed=0, template_seed=None, jax_side=False):
    cls = jax_data.SyntheticDataset if jax_side else data.SyntheticDataset
    return cls(shape=SHAPE, num_classes=10, batch_size=BATCH, seed=seed, dtype="uint8",
               template_seed=template_seed)


def _config_kwargs(accum: int):
    return dict(learning_rate=LR, has_train_arg=True, label_smoothing=0.1, weight_decay=1e-4,
                input_stats=_dataset().input_stats, grad_accum_steps=accum, log_every=1)


def _jax_trainer(pallas: bool, accum: int):
    model = jax_resnet.ResNet(**ARCH, use_pallas_head=pallas)
    jtrainer = JaxTrainer(model, build_mesh(MeshSpec(), jax.devices()[:1]),
                          JaxTrainerConfig(**_config_kwargs(accum)))
    state = jtrainer.init(jax.random.key(0), jnp.asarray(next(iter(_dataset().batches(1))).x))
    return jtrainer, state


def _port_trainer(pallas: bool, accum: int, init_state):
    ttrainer = trainer.Trainer(lambda g: resnet.ResNet(**ARCH, use_pallas_head=pallas, generator=g),
                               trainer.TrainerConfig(**_config_kwargs(accum)), device="cpu")
    state = ttrainer.init(seed=0)
    variables = jax.device_get({"params": init_state.params, **init_state.model_state})
    state.model.load_state_dict(interop.resnet_params_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return ttrainer, state


@needs_jax
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("pallas", [False, True], ids=["dense-head", "fused-head"])
def test_three_momentum_steps_match_jax_trainer(pallas, accum):
    jtrainer, jstate = _jax_trainer(pallas, accum)
    ttrainer, tstate = _port_trainer(pallas, accum, jstate)
    jstate, jlosses = jtrainer.fit(jstate, _dataset(jax_side=True).batches(STEPS), steps=STEPS,
                                   prefetch=0)
    tstate, tlosses = ttrainer.fit(tstate, _dataset().batches(STEPS), steps=STEPS)
    assert tstate.step == STEPS and len(tlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = jax.device_get({"params": jstate.params, **jstate.model_state})
    want = interop.resnet_params_from_jax(final["params"], final["batch_stats"])
    got = tstate.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@needs_jax
def test_evaluate_matches_jax_evaluate():
    jtrainer, jstate = _jax_trainer(True, 1)
    ttrainer, tstate = _port_trainer(True, 1, jstate)
    # One train step first, so that the running statistics are not the initial ones.
    jstate, _ = jtrainer.fit(jstate, _dataset(jax_side=True).batches(1), steps=1, prefetch=0)
    tstate, _ = ttrainer.fit(tstate, _dataset().batches(1), steps=1)
    held_out = dict(seed=10_000, template_seed=0)
    want = jtrainer.evaluate(jstate, _dataset(jax_side=True, **held_out).batches(2), steps=2)
    buffers = {k: v.clone() for k, v in tstate.model.named_buffers()}
    got = ttrainer.evaluate(tstate, _dataset(**held_out).batches(2), steps=2)
    assert got["examples"] == want["examples"] == 2 * BATCH
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == want["accuracy"]
    assert all(torch.equal(v, buffers[k]) for k, v in tstate.model.named_buffers())


def test_multi_step_fn_on_cpu_is_two_train_steps():
    ttrainer = trainer.Trainer(lambda g: resnet.ResNet(**ARCH, generator=g),
                               trainer.TrainerConfig(**_config_kwargs(1)), device="cpu")
    stack = next(data.stack_batches(_dataset().batches(2), 2))
    xs, ys = data.device_put_batch(stack, torch.device("cpu"))
    one, two = ttrainer.init(seed=0), ttrainer.init(seed=0)
    losses = []
    for i in range(2):
        one, m = ttrainer.train_step(one, xs[i], ys[i])
        losses.append(m["loss"])
    two, got = ttrainer.multi_step_fn(2)(two, xs, ys)
    assert two.step == one.step == 2
    assert torch.equal(got, torch.stack(losses))
    for (name, a), b in zip(two.model.state_dict().items(), one.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("k,log_every", [(2, 1), (3, 2), (6, 1)])
def test_fit_steps_per_call_matches_single_steps(k, log_every):
    """``fit(steps_per_call=k)`` over 5 batches: ``5 // k`` stacked calls,
    then the remainder one step a call through the same prefetcher, the same
    losses and state as five single steps (k 6: no stacked call)."""
    kwargs = {**_config_kwargs(1), "log_every": log_every}
    ttrainer = trainer.Trainer(lambda g: resnet.ResNet(**ARCH, generator=g),
                               trainer.TrainerConfig(**kwargs), device="cpu")
    one, two = ttrainer.init(seed=0), ttrainer.init(seed=0)
    one, single = ttrainer.fit(one, _dataset().batches(5), steps=5)
    two, stacked = ttrainer.fit(two, _dataset().batches(5), steps=5, steps_per_call=k)
    assert stacked == single and two.step == 5
    assert ttrainer.last_pipeline_stats.snapshot()["batches"] == 5 // k + 5 % k
    for (name, a), b in zip(two.model.state_dict().items(), one.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_captured_steps_refuse_adamw_without_a_card():
    """The CPU runs multi_step_fn eagerly for any optimizer; the CUDA graph
    path, which takes AdamW too, refuses a CPU device before any capture."""
    cfg = trainer.TrainerConfig(optimizer="adamw", **{k: v for k, v in _config_kwargs(1).items()})
    ttrainer = trainer.Trainer(lambda g: resnet.ResNet(**ARCH, generator=g), cfg, device="cpu")
    state = ttrainer.init(seed=0)
    stack = next(data.stack_batches(_dataset().batches(2), 2))
    state, losses = ttrainer.multi_step_fn(2)(state, stack.x, stack.y)
    assert state.step == 2 and torch.isfinite(losses).all()
    captured = trainer.CapturedSteps(ttrainer, 2)
    with pytest.raises(RuntimeError, match="on the card only"):
        captured._capture(state, torch.from_numpy(stack.x), torch.from_numpy(stack.y))


def test_resnet_imagenet_main_runs_tiny_on_cpu():
    result = resnet_imagenet.main(
        ["--device", "cpu", "--depth", "50", "--image_size", "32", "--global_batch_size", "4",
         "--steps", "3", "--log_every", "1", "--eval_steps", "1", "--use_pallas_head",
         "--augment_flip", "--augment_crop", "--prefetch_workers", "2", "--no-bf16"])
    assert result["steps"] == 3 and result["device"] == "cpu" and len(result["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in result["history"])
    assert result["eval"]["split"] == "heldout-synthetic" and result["eval"]["examples"] == 4
    assert 0.0 <= result["eval"]["accuracy"] <= 1.0
    assert result["params"] == 25_557_032  # ResNet-50 at 1000 classes
    assert "mfu" not in result["history"][0]  # no device peak on the CPU


def test_resnet_imagenet_target_accuracy_mode_on_cpu():
    result = resnet_imagenet.main(
        ["--device", "cpu", "--depth", "50", "--image_size", "32", "--global_batch_size", "2",
         "--steps", "2", "--eval_every", "1", "--eval_steps", "1", "--target_accuracy", "2.0"])
    assert [e["step"] for e in result["eval_history"]] == [1, 2]
    assert result["target_reached"] is False and result["steps"] == 2


@pytest.mark.parametrize("flags", [["--data_dir", "/nonexistent"]])
def test_resnet_imagenet_out_of_slice_flags_raise(flags):
    # --data_dir is ported: a directory that does not exist is the user's error.
    with pytest.raises(SystemExit, match="none of"):
        resnet_imagenet.main(["--device", "cpu", "--steps", "1", *flags])


def test_resnet_imagenet_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet_imagenet.main(["--steps", "1"])


# --- on the card -------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_trainer(pallas: bool, dtype, device):
    """A four-stage ResNet whose head has ResNet-50's shape (K 2048, N 1000;
    M is the batch) on 32x32 uint8 images, bench.py's step configuration."""
    arch = dict(stage_sizes=(1, 1, 1, 1), num_filters=64, num_classes=1000, dtype=dtype,
                use_pallas_head=pallas)
    ds = data.SyntheticDataset(shape=(32, 32, 3), num_classes=1000, batch_size=128, dtype="uint8",
                               pool_batches=2)
    cfg = trainer.TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                                input_stats=ds.input_stats, weight_decay=1e-4)
    return trainer.Trainer(lambda g: resnet.ResNet(**arch, generator=g), cfg, device=device), ds


@pytest.mark.cuda
def test_kernel_head_step_matches_plain_head_on_card(cuda_device):
    """One f32 train step with the kernel head (split-K variant, one launch)
    against the same step under ``force_reference()``: loss, the head's
    gradients and every updated parameter at the f32 fused dense's
    tolerance (the backward is the same torch ops on forwards within f32
    rounding)."""
    ttrainer, ds = _card_trainer(True, torch.float32, cuda_device)
    x, y = data.device_put_batch(next(iter(ds.batches(1))), cuda_device)
    states = [ttrainer.init(seed=0), ttrainer.init(seed=0)]
    _kernels.reset_launch_counts()
    states[0], m_kernel = ttrainer.train_step(states[0], x, y)
    torch.cuda.synchronize()
    assert _kernels.launch_counts.get(f"fused_dense/{F32_SPLITK}") == 1, _kernels.launch_counts
    with fd.force_reference():
        states[1], m_plain = ttrainer.train_step(states[1], x, y)
    assert _kernels.launch_counts["fused_dense"] == 1
    torch.testing.assert_close(m_kernel["loss"], m_plain["loss"], rtol=1e-5, atol=1e-5)
    for name in ("kernel", "bias"):
        torch.testing.assert_close(getattr(states[0].model.head, name).grad,
                                   getattr(states[1].model.head, name).grad,
                                   rtol=1e-4, atol=1e-4)
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            states[1].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", [True, False], ids=["kernel-head", "plain-head"])
def test_captured_multi_step_matches_eager_steps_on_card(cuda_device, pallas):
    """``multi_step_fn(2)`` is one CUDA graph (the kernel head launched by the
    warm-up and the capture only), and its losses, parameters and BatchNorm
    statistics match two eager bf16 steps from the same state to 1e-3
    relative (cuDNN's backward may sum in another order from run to run)."""
    ttrainer, ds = _card_trainer(pallas, torch.bfloat16, cuda_device)
    stack = next(data.stack_batches(ds.batches(2), 2))
    xs, ys = data.device_put_batch(stack, cuda_device)
    eager = ttrainer.init(seed=0)
    losses = []
    for i in range(2):
        eager, m = ttrainer.train_step(eager, xs[i], ys[i])
        losses.append(m["loss"])
    captured = ttrainer.init(seed=0)
    kfn = ttrainer.multi_step_fn(2)
    _kernels.reset_launch_counts()
    captured, closses = kfn(captured, xs, ys)
    assert kfn.captures == 1 and captured.step == 2
    assert _kernels.launch_counts["fused_dense"] == (3 if pallas else 0)
    torch.testing.assert_close(closses, torch.stack(losses), rtol=1e-3, atol=0)
    for (name, a), b in zip(captured.model.state_dict().items(),
                            eager.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3, msg=name)
    captured, again = kfn(captured, xs, ys)  # a replay: no new capture, no launch counted
    assert kfn.captures == 1 and captured.step == 4 and torch.isfinite(again).all()
    assert _kernels.launch_counts["fused_dense"] == (3 if pallas else 0)
