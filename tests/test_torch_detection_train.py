"""The port's detection training against the JAX package's, on the CPU.

- ``SyntheticDetectionDataset`` byte-identical to the JAX one (with masks,
  ``template_seed`` and ``mask_stride``).
- Three Nesterov-momentum steps (lr 0.01, global-norm clip 10, the JAX
  example's recipe) of ``RetinaNet(backbone_stages=(1, 1, 1, 1),
  fpn_channels=32, with_masks=True)`` in f32 on 64-px synthetic batches,
  from the same weights, through the JAX ``Trainer`` (the example's
  stateful loss) and the port's, with ``--freeze_backbone_norm`` off and on:
  losses and the loss terms to 1e-5 relative, parameters and BatchNorm
  statistics to 1e-5 absolute, as the ResNet trainer test holds them.
- ``detection_train.main`` on the CPU at the tiny backbone, 64 px, with
  ``--masks``, ``--eval_steps 1`` and ``--backbone_ckpt`` (a classifier saved
  by the port's ``Checkpointer``); its boundaries (``--data_dir``, no card).
- The JAX ``test_pretrained_backbone_speeds_loss_descent`` replayed on the
  port from the JAX run's initial weights: from a classifier trained on the
  same synthetic world, detection's loss descends faster than from scratch.
  (From the port's own seeded weights the claim does not hold on this tree:
  12 steps' losses are noisy, and the JAX run's own margin is 3.59 against
  3.67.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import retinanet as jr
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.train import data as jax_data
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples import detection_train  # noqa: E402
from deeplearning_cfn_tpu_torch.models import resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.models import retinanet as tr  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data  # noqa: E402
from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger  # noqa: E402
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

SIZE, CLASSES, BATCH, STEPS = 64, 4, 4, 3
ARCH = dict(num_classes=CLASSES, backbone_stages=(1, 1, 1, 1), fpn_channels=32, with_masks=True)
TRAIN = dict(learning_rate=0.01, has_train_arg=True, grad_clip_norm=10.0, log_every=1)


def _dataset(jax_side=False, **kw):
    cls = jax_data.SyntheticDetectionDataset if jax_side else data.SyntheticDetectionDataset
    return cls(**{**dict(image_size=SIZE, num_classes=CLASSES, max_boxes=3, batch_size=BATCH,
                         with_masks=True), **kw})


@needs_jax
@pytest.mark.parametrize("kw", [dict(), dict(seed=7, template_seed=0, mask_stride=4),
                                dict(with_masks=False)])
def test_synthetic_detection_stream_is_byte_identical(kw):
    for got, want in zip(_dataset(**kw).batches(3), _dataset(jax_side=True, **kw).batches(3)):
        assert got.x.tobytes() == want.x.tobytes()
        assert set(got.y) == set(want.y)
        for k in want.y:
            assert got.y[k].dtype == want.y[k].dtype and got.y[k].tobytes() == want.y[k].tobytes()


def _jax_trainer(freeze: bool):
    model = jr.RetinaNet(**ARCH, freeze_backbone_norm=freeze)
    anchors = jnp.asarray(jr.generate_anchors(SIZE))

    def loss_fn(params, model_state, x, y):  # the JAX example's
        variables = {"params": params, **model_state}
        outputs, new_state = model.apply(variables, x, train=True, mutable=list(model_state))
        cls_out, box_out, coeff_out, protos = outputs
        loss, aux = jr.detection_loss_with_masks(cls_out, box_out, coeff_out, protos, anchors,
                                                 y["boxes"], y["classes"], y["masks"], CLASSES)
        return loss, (aux, new_state)

    jt = JaxTrainer(model, build_mesh(MeshSpec(), jax.devices()[:1]), JaxTrainerConfig(**TRAIN),
                    stateful_loss_fn=loss_fn)
    return jt, jt.init(jax.random.key(0), jnp.asarray(next(iter(_dataset().batches(1))).x))


def _port_loss(model, x, y):
    outputs = model(x, train=True)
    return tr.detection_loss_with_masks(*outputs, torch.from_numpy(tr.generate_anchors(SIZE)),
                                        y["boxes"], y["classes"], y["masks"], CLASSES)


def _as_numpy_state(jstate) -> dict:
    v = jax.device_get({"params": jstate.params, **jstate.model_state})
    return interop.retinanet_params_from_jax(v["params"], v["batch_stats"])


@needs_jax
@pytest.mark.parametrize("freeze", [False, True], ids=["bn-train", "bn-frozen"])
def test_three_momentum_steps_match_jax_trainer(freeze):
    jt, jstate = _jax_trainer(freeze)
    tt = Trainer(lambda g: tr.RetinaNet(**ARCH, freeze_backbone_norm=freeze, generator=g),
                 TrainerConfig(**TRAIN), loss_fn=_port_loss, device="cpu")
    tstate = tt.init(seed=0)
    tstate.model.load_state_dict(_as_numpy_state(jstate), strict=True)
    stats_before = {k: v.clone() for k, v in tstate.model.backbone.named_buffers()}
    for jb, tb in zip(_dataset(jax_side=True).batches(STEPS), _dataset().batches(STEPS)):
        jstate, jm = jt.train_step(jstate, jnp.asarray(jb.x),
                                   {k: jnp.asarray(v) for k, v in jb.y.items()})
        x, y = data.device_put_batch(tb, torch.device("cpu"))
        tstate, tm = tt.train_step(tstate, x, y)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(jm["num_pos"]) > 1 and float(jm["mask_slots"]) > 1
    want = _as_numpy_state(jstate)
    got = tstate.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    moved = [not torch.equal(v, stats_before[k]) for k, v in tstate.model.backbone.named_buffers()]
    assert (not any(moved)) if freeze else all(moved)


def _classifier_checkpoint(root):
    """A saved classifier TrainState of the port's ResNet at the tiny
    detector's backbone depths."""
    trainer = Trainer(lambda g: resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=8,
                                              generator=g),
                      TrainerConfig(has_train_arg=True), device="cpu")
    ck = Checkpointer(root, interval_s=None, async_save=False)
    ck.save(1, trainer.init(seed=0))
    ck.close()


COMMON = ["--device", "cpu", "--backbone", "tiny", "--image_size", "64", "--num_classes", "8"]


def test_detection_train_main_with_masks_backbone_ckpt_and_eval(tmp_path):
    _classifier_checkpoint(tmp_path / "cls")
    out = detection_train.main(COMMON + [
        "--global_batch_size", "4", "--steps", "2", "--log_every", "1", "--masks",
        "--eval_steps", "1", "--backbone_ckpt", str(tmp_path / "cls")])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"]) and out["device"] == "cpu"
    twin = tr.RetinaNet(backbone_stages=(1, 1, 1, 1), num_classes=8)
    assert out["backbone_tensors_transferred"] == len(twin.backbone.state_dict())
    ev = out["eval"]
    assert ev["images"] == 4 and 0.0 <= ev["mAP"] <= 1.0
    assert 0.0 <= ev["mask_mAP"] <= 1.0 and 0.0 <= ev["mask_mAP_stride"] <= 1.0


def test_detection_train_boundaries(tmp_path):
    # --data_dir is ported: a directory without records is the user's error.
    with pytest.raises(SystemExit, match="no .dlc record files"):
        detection_train.main(COMMON + ["--steps", "1", "--data_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="does not exist"):
        detection_train.main(COMMON + ["--steps", "1", "--backbone_ckpt",
                                       str(tmp_path / "missing")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            detection_train.main(["--backbone", "tiny", "--image_size", "64", "--steps", "1"])


@needs_jax
def test_pretrained_backbone_speeds_loss_descent(tmp_path):
    """The JAX test of the same name, replayed on the port from the JAX
    initial weights (its ``jax.random.key(0)`` draws, through ``interop``):
    a classifier trained 60 AdamW steps on the same synthetic world (label =
    the one box's class) and saved, then 12 detection steps (the example's
    trainer: momentum lr 0.01, clip 10, f32, batch 16, log every 4) from
    scratch and from the transferred backbone; the transferred one's loss
    descends faster.  The example's own ``--backbone_ckpt`` path is
    exercised above; this replays the claim on the JAX run's weights."""
    from deeplearning_cfn_tpu.models.resnet import ResNet as JaxResNet

    cls_ds = data.SyntheticDetectionDataset(image_size=64, num_classes=8, max_boxes=1,
                                            batch_size=16, seed=1, template_seed=0)

    def cls_batches(steps):
        for b in cls_ds.batches(steps):
            yield data.Batch(x=b.x, y=b.y["classes"][:, 0].astype(np.int32))

    x0 = jnp.zeros((16, 64, 64, 3))
    cls_init = jax.device_get(jax.jit(lambda k: JaxResNet(
        stage_sizes=(1, 1, 1, 1), num_filters=64, num_classes=8).init(k, x0, train=False))(
        jax.random.key(0)))
    trainer = Trainer(lambda g: resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=8,
                                              generator=g),
                      TrainerConfig(learning_rate=1e-3, optimizer="adamw", has_train_arg=True,
                                    matmul_precision="float32"), device="cpu")
    state = trainer.init(seed=0)
    state.model.load_state_dict(interop.resnet_params_from_jax(cls_init["params"],
                                                               cls_init["batch_stats"]))
    state, cls_losses = trainer.fit(state, cls_batches(60), steps=60)
    assert np.mean(cls_losses[-5:]) < np.mean(cls_losses[:5])
    ck = Checkpointer(tmp_path / "cls", interval_s=None, async_save=False)
    ck.save(40, state)
    ck.close()
    raw, _ = Checkpointer(tmp_path / "cls", async_save=False).restore_raw()

    arch = dict(num_classes=8, backbone_stages=(1, 1, 1, 1))
    det_ds = data.SyntheticDetectionDataset(image_size=64, num_classes=8, max_boxes=3,
                                            batch_size=16)
    det_init = jax.device_get(jax.jit(lambda k: jr.RetinaNet(**arch).init(
        k, jnp.zeros((16, 64, 64, 3)), train=False))(jax.random.key(0)))
    anchors = torch.from_numpy(tr.generate_anchors(64))

    def loss_fn(model, x, y):
        return tr.detection_loss(*model(x, train=True), anchors, y["boxes"], y["classes"], 8)

    def run(pretrained: bool) -> float:
        def model_fn(generator):
            model = tr.RetinaNet(**arch, generator=generator)
            model.load_state_dict(interop.retinanet_params_from_jax(
                det_init["params"], det_init["batch_stats"]))
            if pretrained:
                assert tr.load_pretrained_backbone(model, raw) == len(
                    model.backbone.state_dict())
            return model

        t = Trainer(model_fn, TrainerConfig(learning_rate=0.01, has_train_arg=True,
                                            grad_clip_norm=10.0, log_every=4),
                    loss_fn=loss_fn, device="cpu")
        logger = ThroughputLogger(global_batch_size=16, log_every=4)
        t.fit(t.init(seed=0), det_ds.batches(12), steps=12, logger=logger)
        return float(np.mean([h["loss"] for h in logger.history]))

    mean_scratch, mean_pre = run(False), run(True)
    assert mean_pre < mean_scratch, (mean_pre, mean_scratch)
