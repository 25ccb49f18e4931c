"""The port's VGG, ``cifar10_train`` and ``lenet_mnist`` against the JAX
package's, on the CPU.

- ``VGG`` (every config) on the JAX weights (``interop.vgg_params_from_jax``,
  every norm variable drawn at random), f32, eval and train mode: logits at
  ``rtol`` 1e-4 / ``atol`` 1e-5 (train mode: 1e-4 absolute, as the ResNet
  test holds train-mode logits: the batch statistics are computed in one
  pass here and as ``E[x²] − E[x]²`` in Flax), the running statistics at
  1e-5.
- Three Nesterov-momentum steps (lr 0.05, the example's) of VGG-11 in f32 on
  the synthetic CIFAR stream through the JAX ``Trainer`` and the port's:
  losses to 1e-5 relative; parameters and statistics after the first step
  to 1e-5 absolute, as the ResNet trainer test holds them.  After three
  steps they are held to 1e-3 only: this network at batch 8 amplifies f32
  rounding (a ReLU input within rounding of 0 flips after a small-batch
  BatchNorm), so that both the JAX run and the port's drift up to 2e-4
  from the same steps computed in float64, at lr 0.05 and at 0.001 alike
  (measured on this tree); a wrong update rule moves them by lr·|g|, 1e-2.
- ``fit(stop_fn=)``: called at each ``log_every`` boundary and after the last
  step with the metrics, and True ends the run, as in the JAX ``fit`` (the
  same steps taken, the same losses returned).
- ``cifar10_train.main`` (with ``--target_accuracy``, ``--eval_steps``) and
  ``lenet_mnist.main`` end to end on the CPU; their boundaries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import lenet as jax_lenet
    from deeplearning_cfn_tpu.models import vgg as jax_vgg
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.train import data as jax_data
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples import cifar10_train, lenet_mnist  # noqa: E402
from deeplearning_cfn_tpu_torch.models import vgg  # noqa: E402
from deeplearning_cfn_tpu_torch.models.lenet import LeNet  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data  # noqa: E402
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

BATCH, STEPS = 8, 3


def _images(seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((BATCH, 32, 32, 3)).astype(np.float32)


def _randomise_norms(node, rng, path=()):
    for key, child in node.items():
        if isinstance(child, dict):
            _randomise_norms(child, rng, path + (key,))
        elif any(p.startswith("bn") for p in path):
            shape = np.shape(child)
            node[key] = (rng.uniform(0.5, 1.5, shape) if key in ("scale", "var")
                         else 0.2 * rng.standard_normal(shape)).astype(np.float32)


@needs_jax
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(vgg.CONFIGS))
def test_vgg_logits_match_jax(name, train):
    jmodel = jax_vgg.VGG(config=jax_vgg.CONFIGS[name])
    x = _images()
    v = jax.tree_util.tree_map(np.array, jax.device_get(
        jmodel.init(jax.random.key(0), jnp.asarray(x), train=False)))
    rng = np.random.default_rng(3)
    for tree in v.values():
        _randomise_norms(tree, rng)
    tmodel = vgg.VGG(config=vgg.CONFIGS[name])
    tmodel.load_state_dict(interop.vgg_params_from_jax(v["params"], v["batch_stats"]), strict=True)
    got = tmodel(torch.from_numpy(_images(1)), train=train)
    if train:
        want, new = jmodel.apply(v, jnp.asarray(_images(1)), train=True, mutable=["batch_stats"])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
        stats = interop.vgg_params_from_jax({}, jax.device_get(new["batch_stats"]))
        buffers = dict(tmodel.named_buffers())
        assert set(stats) == set(buffers)
        for k, value in stats.items():
            np.testing.assert_allclose(buffers[k].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    else:
        want = jmodel.apply(v, jnp.asarray(_images(1)), train=False)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)


def test_vgg_names_and_f32_norms():
    model = vgg.VGG11(num_classes=10, dtype=torch.bfloat16)
    convs = [n for n, _ in model.named_children() if n.startswith("conv")]
    assert len(convs) == 8  # VGG-11: 8 convs, the FC stack replaced by GAP and one head
    assert model.bn1.mean.dtype == torch.float32 and model.bn1.dtype == torch.float32
    assert model(torch.zeros(2, 32, 32, 3), train=False).dtype == torch.float32


def _cifar(jax_side=False, **kw):
    cls = jax_data.SyntheticDataset if jax_side else data.SyntheticDataset
    return cls(shape=(32, 32, 3), num_classes=10, batch_size=BATCH, noise_scale=1.0, **kw)


TRAIN = dict(learning_rate=0.05, has_train_arg=True, optimizer="momentum", log_every=1)


@needs_jax
def test_three_momentum_steps_match_jax_trainer():
    jmodel = jax_vgg.VGG(config=jax_vgg.CONFIGS["vgg11"])
    jt = JaxTrainer(jmodel, build_mesh(MeshSpec(), jax.devices()[:1]), JaxTrainerConfig(**TRAIN))
    jstate = jt.init(jax.random.key(0), jnp.asarray(next(iter(_cifar().batches(1))).x))
    tt = Trainer(lambda g: vgg.VGG(generator=g), TrainerConfig(**TRAIN), device="cpu")
    tstate = tt.init(seed=0)
    v = jax.device_get({"params": jstate.params, **jstate.model_state})
    tstate.model.load_state_dict(interop.vgg_params_from_jax(v["params"], v["batch_stats"]),
                                 strict=True)
    jlosses, tlosses = [], []
    for step, (jb, tb) in enumerate(zip(_cifar(jax_side=True).batches(STEPS),
                                        _cifar().batches(STEPS))):
        jstate, jm = jt.train_step(jstate, jnp.asarray(jb.x), jnp.asarray(jb.y))
        tstate, tm = tt.train_step(tstate, torch.from_numpy(tb.x), torch.from_numpy(tb.y))
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
        v = jax.device_get({"params": jstate.params, **jstate.model_state})
        want = interop.vgg_params_from_jax(v["params"], v["batch_stats"])
        atol = 1e-5 if step == 0 else 1e-3
        for name, value in want.items():
            np.testing.assert_allclose(tstate.model.state_dict()[name].numpy(), value.numpy(),
                                       rtol=0, atol=atol, err_msg=f"{name} after {step + 1}")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)


@needs_jax
def test_fit_stop_fn_ends_the_run_where_jax_does():
    """Both stop at the second ``log_every`` boundary (step 6 of 20) and
    return the losses of the steps taken; each saw the metrics dict."""
    def stopper(seen):
        def stop_fn(metrics):
            seen.append(float(metrics["accuracy"]))
            return len(seen) == 2
        return stop_fn

    cfg = dict(learning_rate=0.05, log_every=3)
    jt = JaxTrainer(jax_lenet.LeNet(), build_mesh(MeshSpec(), jax.devices()[:1]),
                    JaxTrainerConfig(**cfg))
    ds = dict(shape=(28, 28, 1), num_classes=10, batch_size=BATCH)
    jstate = jt.init(jax.random.key(0), jnp.zeros((BATCH, 28, 28, 1)))
    jseen, tseen = [], []
    jstate, jlosses = jt.fit(jstate, jax_data.SyntheticDataset(**ds).batches(20), steps=20,
                             stop_fn=stopper(jseen), prefetch=0)
    tt = Trainer(lambda g: LeNet(generator=g), TrainerConfig(**cfg), device="cpu")
    tstate, tlosses = tt.fit(tt.init(seed=0), data.SyntheticDataset(**ds).batches(20), steps=20,
                             stop_fn=stopper(tseen))
    assert len(jlosses) == len(tlosses) == 6 and tstate.step == 6
    assert len(jseen) == len(tseen) == 2
    # A run that never stops calls it at each boundary and after the last step.
    seen = []
    tt.fit(tt.init(seed=0), data.SyntheticDataset(**ds).batches(7), steps=7,
           stop_fn=lambda m: seen.append(m) and False)
    assert len(seen) == 3


def test_cifar10_train_main_stops_at_the_target_and_evaluates():
    out = cifar10_train.main(["--device", "cpu", "--global_batch_size", "32", "--steps", "6",
                              "--log_every", "2", "--target_accuracy", "1e-6", "--eval_steps",
                              "1", "--no-bf16"])
    # Stopped at the first check: some of the 32 examples are right.
    assert out["steps"] == 2 and out["end_step"] == 2 and out["final_accuracy"] > 0
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["final_accuracy"] <= 1.0
    assert out["eval"]["split"] == "heldout" and out["eval"]["examples"] == 32
    out = cifar10_train.main(["--device", "cpu", "--global_batch_size", "8", "--steps", "3",
                              "--log_every", "1", "--model", "vgg13"])
    assert out["steps"] == 3 and all(np.isfinite(h["loss"]) for h in out["history"])


def test_lenet_mnist_main_learns():
    out = lenet_mnist.main(["--device", "cpu", "--steps", "12", "--log_every", "1"])
    losses = [h["loss"] for h in out["history"]]
    assert out["steps"] == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("argv", [["--data_dir", "/nonexistent"],
                                  ["--eval_data_dir", "/nonexistent"]])
def test_cifar10_record_inputs_raise(argv):
    # The record inputs are ported: a directory that does not exist is the
    # user's error, raised where the eval opens it.
    with pytest.raises(SystemExit, match="none of"):
        cifar10_train.main(["--device", "cpu", "--steps", "1", "--global_batch_size", "4",
                            "--eval_steps", "1", *argv])


def test_examples_raise_without_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (cifar10_train.main, lenet_mnist.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--steps", "1"])
