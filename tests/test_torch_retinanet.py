"""The port's RetinaNet (``models/retinanet.py``) against the JAX package's, on
the CPU, on the same numpy inputs and the same weights (``interop``).

- ``generate_anchors``: the port's numpy copy equal to the original.
- ``box_iou``, ``encode_boxes``, ``decode_boxes``: f32, ``rtol`` 1e-4 /
  ``atol`` 1e-5 (IoU equal).
- ``match_anchors`` batched against ``vmap`` of the JAX per-image one:
  targets, foreground, matched index and IoU exactly equal, the box targets
  at the f32 tolerance; with tied IoUs (a duplicated box, anchors placed
  symmetrically about a box) the first maximum wins on both sides.
- ``focal_loss`` with background (−1) and ignore (−2) targets: 1e-5.
- The forward of ``RetinaNet(backbone_stages=(1, 1, 1, 1), fpn_channels=32)``
  at 64 and 96 px (P6 and P7 even, then odd), box-only and with masks, in
  train and eval mode, every norm variable and bias drawn at random (no
  symmetric weights): eval mode ``rtol`` 1e-4 / ``atol`` 1e-5 of JAX.  In
  train mode the two compute the batch statistics differently (PyTorch's
  one pass, Flax's ``E[x²] − E[x]²``) and differ by up to 3e-5 on outputs of
  O(1); so each output is held at ``rtol`` 1e-4 / ``atol`` 1e-5 to the same
  network evaluated in float64 (the port's modules in f64), and no farther
  from it than JAX's output is (JAX's is 2-4x farther); the running
  statistics at ``rtol`` 1e-4 / ``atol`` 1e-5 of JAX's.
- The losses (with masks) and their gradients with respect to the head
  outputs: 1e-5; the mask loss on tied IoUs picks the same anchors.
- ``nms_fixed`` against ``vmap`` of the JAX function: equal, ties included.
  ``predict`` on JAX's own head outputs: scores, classes, valid slots and
  masks equal; the boxes within 3e-5 px (two f32 ulps at the coordinates'
  scale, up to 128 px: they are decoded through ``exp``, which XLA and
  PyTorch round differently in the last place).
- ``load_pretrained_backbone`` from a saved classifier: the same tensors
  transferred as JAX's transfer counts, the backbone equal to the
  classifier's, the head dropped; nothing to transfer raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import retinanet as jr
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.models import retinanet as tr  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

ARCH = dict(num_classes=4, backbone_stages=(1, 1, 1, 1), fpn_channels=32)
BATCH = 2
F32 = dict(rtol=1e-4, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _random_boxes(rng, n, size=64.0):
    pts = rng.uniform(0, size, size=(n, 2, 2))
    return np.concatenate([pts.min(1), pts.max(1) + 1.0], -1).astype(np.float32)


@pytest.mark.parametrize("size", [64, 96, 256])
@needs_jax
def test_anchors_equal_jax(size):
    np.testing.assert_array_equal(tr.generate_anchors(size), jr.generate_anchors(size))
    assert tr.generate_anchors(256).shape == (12276, 4)


@needs_jax
def test_iou_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 7)
    b[3] = b[2]  # a duplicate
    np.testing.assert_array_equal(tr.box_iou(_t(a), _t(b)).numpy(),
                                  np.asarray(jr.box_iou(jnp.asarray(a), jnp.asarray(b))))
    anchors = tr.generate_anchors(64)[:40]
    enc = tr.encode_boxes(_t(anchors), _t(a))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jr.encode_boxes(anchors, a)), **F32)
    deltas = rng.normal(0, 2.0, size=(40, 4)).astype(np.float32)  # some hit the clip
    np.testing.assert_allclose(tr.decode_boxes(_t(anchors), _t(deltas)).numpy(),
                               np.asarray(jr.decode_boxes(anchors, deltas)), **F32)
    np.testing.assert_allclose(tr.decode_boxes(_t(anchors), enc).numpy(), a, rtol=1e-4, atol=1e-3)


def _tied_ground_truth(size=64):
    """Padded ground truth for 2 images, with ties: image 0 holds one box
    twice (its anchors' IoU ties across the two, and the first must win) and
    a box centred on an anchor cell, so that the anchors of the cell placed
    symmetrically about it (ratios 0.5 and 2) tie; image 1 random boxes."""
    rng = np.random.default_rng(3)
    boxes = np.zeros((2, 5, 4), np.float32)
    classes = np.full((2, 5), -1, np.int32)
    boxes[0, 0] = boxes[0, 1] = (8.0, 8.0, 40.0, 40.0)
    boxes[0, 2] = (20.0, 20.0, 44.0, 44.0)  # centred on the stride-8 cell at (32, 32)
    classes[0, :3] = (1, 2, 3)
    boxes[1, :4] = _random_boxes(rng, 4, size - 1)
    classes[1, :4] = rng.integers(0, 4, 4)
    return boxes, classes


@needs_jax
def test_match_anchors_matches_jax_including_ties():
    anchors = tr.generate_anchors(64)
    boxes, classes = _tied_ground_truth()
    want = jax.vmap(lambda b, c: jr.match_anchors(jnp.asarray(anchors), b, c))(
        jnp.asarray(boxes), jnp.asarray(classes))
    got = tr.match_anchors(_t(anchors), _t(boxes), _t(classes))
    cls_t, box_t, fg, best_gt, best_iou = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), cls_t)
    np.testing.assert_array_equal(got[2].numpy(), fg)
    np.testing.assert_array_equal(got[3].numpy(), best_gt)
    np.testing.assert_array_equal(got[4].numpy(), best_iou)
    np.testing.assert_allclose(got[1].numpy(), box_t, **F32)
    # The ties are there, and the first maximum won them.
    iou = tr.box_iou(_t(anchors), _t(boxes))[0]
    dup = (iou[:, 0] == iou[:, 1]) & (iou[:, 0] > 0)
    assert dup.any() and (got[3][0][dup] != 1).all()
    assert (fg.sum(1) > 0).all() and (cls_t == -2).any() and (cls_t == -1).any()


@needs_jax
def test_focal_loss_with_background_and_ignored_targets():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, size=(2, 30, 5)).astype(np.float32)
    target = rng.integers(-2, 5, size=(2, 30)).astype(np.int32)
    assert {-2, -1} <= set(target.ravel().tolist())
    want = np.asarray(jr.focal_loss(jnp.asarray(logits), jnp.asarray(target), 5))
    got = tr.focal_loss(_t(logits), _t(target), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[target == -2] == 0).all()


def _randomise(node, rng, path=()):
    """Every norm's scale/bias and mean/var drawn at random, and every other
    bias too, in place (Flax's zeros and the zero ``bn3`` scale would hide
    branches and biases)."""
    for key, child in node.items():
        if isinstance(child, dict):
            _randomise(child, rng, path + (key,))
            continue
        shape = np.shape(child)
        if key in ("scale", "var"):
            node[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key in ("bias", "mean"):
            node[key] = (0.2 * rng.standard_normal(shape)).astype(np.float32)


_VARS: dict = {}


def _variables(size: int, masks: bool):
    key = (size, masks)
    if key not in _VARS:
        model = jr.RetinaNet(**ARCH, with_masks=masks)
        x = jnp.asarray(_images(size))
        v = jax.tree_util.tree_map(np.array, jax.device_get(model.init(jax.random.key(0), x,
                                                                        train=False)))
        rng = np.random.default_rng(7)
        for tree in v.values():
            _randomise(tree, rng)
        _VARS[key] = v
    return _VARS[key]


def _images(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((BATCH, size, size, 3)).astype(np.float32)


def _pair(size: int, masks: bool, **kw):
    v = _variables(size, masks)
    jmodel = jr.RetinaNet(**ARCH, with_masks=masks, **kw)
    tmodel = tr.RetinaNet(**ARCH, with_masks=masks, **kw)
    tmodel.load_state_dict(interop.retinanet_params_from_jax(v["params"], v["batch_stats"]),
                           strict=True)
    return jmodel, v, tmodel


@needs_jax
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("masks", [False, True], ids=["boxes", "masks"])
@pytest.mark.parametrize("size", [64, 96])
def test_forward_matches_jax(size, masks, train):
    jmodel, v, tmodel = _pair(size, masks)
    x = _images(size, seed=1)
    if train:
        jout, new_state = jmodel.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        jout = jmodel.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tmodel(_t(x), train=train)
    assert len(tout) == (4 if masks else 2)
    n = len(tr.generate_anchors(size))
    assert tout[0].shape == (BATCH, n, 4) and tout[1].shape == (BATCH, n, 4)
    exact = _float64_forward(size, masks, x) if train else None
    for i, (name, a, b) in enumerate(zip(("cls", "box", "coeff", "protos"), jout, tout)):
        assert b.dtype == torch.float32
        if exact is None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32, err_msg=name)
            continue
        np.testing.assert_allclose(b.numpy(), exact[i], **F32, err_msg=name)
        port_err = np.abs(b.numpy() - exact[i]).max()
        assert port_err <= np.abs(np.asarray(a, np.float64) - exact[i]).max(), name
    if train:
        want = interop.retinanet_params_from_jax(v["params"], jax.device_get(new_state["batch_stats"]))
        for k, t in tmodel.state_dict().items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(t.numpy(), want[k].numpy(), **F32, err_msg=k)


def _float64_forward(size: int, masks: bool, x: np.ndarray) -> list[np.ndarray]:
    """Train-mode outputs of the same weights computed in float64 by the
    port's modules (every module's compute dtype set to f64)."""
    _, _, model = _pair(size, masks)
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    with torch.no_grad():
        return [o.numpy() for o in model(_t(x).double(), train=True)]


@needs_jax
def test_frozen_backbone_norm_reads_running_statistics_in_train_mode():
    jmodel, v, tmodel = _pair(64, False, freeze_backbone_norm=True)
    x = _images(64, seed=2)
    before = {k: t.clone() for k, t in tmodel.state_dict().items()}
    jout = jmodel.apply(v, jnp.asarray(x), train=True)  # nothing mutable: the stats are frozen
    tout = tmodel(_t(x), train=True)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **F32)
    assert all(torch.equal(t, before[k]) for k, t in tmodel.state_dict().items())
    assert tmodel.backbone.bn_init.weight.requires_grad  # scale and bias still train


def test_head_layout_is_nhwc_per_cell_per_anchor():
    """A pred bias that differs per (anchor, class) channel reads back in the
    [cell, anchor, class] order ``generate_anchors`` assumes."""
    head = tr.HeadSubnet(3, channels=8, depth=0)
    with torch.no_grad():
        head.pred.weight.zero_()
        head.pred.bias.copy_(torch.arange(tr.NUM_ANCHORS_PER_CELL * 3, dtype=torch.float32))
    out = head(torch.zeros(1, 8, 2, 3))
    assert out.shape == (1, 2 * 3 * tr.NUM_ANCHORS_PER_CELL, 3)
    want = torch.arange(tr.NUM_ANCHORS_PER_CELL * 3, dtype=torch.float32).reshape(-1, 3)
    assert torch.equal(out[0].reshape(6, tr.NUM_ANCHORS_PER_CELL, 3), want.expand(6, -1, -1))


def test_class_bias_starts_at_the_focal_prior():
    model = tr.RetinaNet(**ARCH, generator=torch.Generator().manual_seed(0))
    prior = -np.log((1 - 0.01) / 0.01)
    np.testing.assert_allclose(model.cls_head.pred.bias.detach().numpy(), prior, rtol=1e-6)
    assert (model.box_head.pred.bias == 0).all()


def _world(size=64):
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(image_size=size, num_classes=4, max_boxes=3,
                                   batch_size=BATCH, with_masks=True)
    return next(iter(ds.batches(1)))


def _head_outputs(size=64, seed=5):
    """Random head outputs at the model's shapes (f32 numpy)."""
    rng = np.random.default_rng(seed)
    n, h = len(tr.generate_anchors(size)), size // 8
    return (rng.normal(-2, 2, (BATCH, n, 4)).astype(np.float32),
            rng.normal(0, 0.3, (BATCH, n, 4)).astype(np.float32),
            np.tanh(rng.normal(0, 1, (BATCH, n, 16))).astype(np.float32),
            np.maximum(rng.normal(0, 1, (BATCH, h, h, 16)), 0).astype(np.float32))


def _jax_loss(outs, anchors, y):
    cls, box, coeff, protos = (jnp.asarray(o) for o in outs)
    return jr.detection_loss_with_masks(cls, box, coeff, protos, jnp.asarray(anchors),
                                        jnp.asarray(y["boxes"]), jnp.asarray(y["classes"]),
                                        jnp.asarray(y["masks"]), 4)


def _check_losses(outs, anchors, y):
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda *o: _jax_loss(o, anchors, y), argnums=(0, 1, 2, 3), has_aux=True)(*outs)
    touts = [_t(o).requires_grad_() for o in outs]
    tloss, taux = tr.detection_loss_with_masks(
        *touts[:2], touts[2], touts[3], _t(anchors), _t(y["boxes"]), _t(y["classes"]),
        _t(y["masks"]), 4)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    for name, g, t in zip(("cls", "box", "coeff", "protos"), jgrads, touts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-8,
                                   err_msg=name)
    return taux


@needs_jax
def test_losses_and_gradients_match_jax():
    batch = _world()
    aux = _check_losses(_head_outputs(), tr.generate_anchors(64), batch.y)
    assert aux["num_pos"] > 1 and aux["mask_slots"] > 1


@needs_jax
def test_mask_loss_picks_the_same_anchors_among_tied_ious():
    """Equal IoUs among the positive anchors (a duplicated box and a box
    centred on a cell): the stable sort keeps the lower index first, as
    ``lax.top_k``; another pick would weigh another anchor's coefficients."""
    boxes, classes = _tied_ground_truth()
    masks = np.zeros((2, 5, 8, 8), np.uint8)
    for b in range(2):
        for m in range(5):
            if classes[b, m] >= 0:
                y0, x0, y1, x1 = (boxes[b, m] // 8).astype(int)
                masks[b, m, y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)] = 1
    y = {"boxes": boxes, "classes": classes, "masks": masks}
    anchors = tr.generate_anchors(64)
    _, _, fg, _, best_iou = tr.match_anchors(_t(anchors), _t(boxes), _t(classes))
    score = torch.where(fg, best_iou, -1.0)[0]
    pos = score[score > 0]
    assert len(pos) > 1 and len(pos.unique()) < len(pos)  # ties among the positives
    _check_losses(_head_outputs(seed=6), anchors, y)
    # With at most max_pos picks, the pick among tied scores is the lower index.
    _, _, fg, _, best_iou = tr.match_anchors(_t(anchors), _t(boxes), _t(classes))
    score = torch.where(fg, best_iou, -1.0)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :4]
    want = np.asarray(jax.lax.top_k(jnp.asarray(score.numpy()), 4)[1])
    np.testing.assert_array_equal(top.numpy(), want)


def _jax_predict(outs, anchors, masks, max_det):
    cls, box = jnp.asarray(outs[0]), jnp.asarray(outs[1])
    a = jnp.asarray(anchors)
    if masks:
        coeff, protos = jnp.asarray(outs[2]), jnp.asarray(outs[3])
        return jax.vmap(lambda c, b, co, pr: jr.predict(c, b, a, max_detections=max_det,
                                                        coeffs=co, protos=pr))(
            cls, box, coeff, protos)
    return jax.vmap(lambda c, b: jr.predict(c, b, a, max_detections=max_det))(cls, box)


@needs_jax
@pytest.mark.parametrize("masks", [False, True], ids=["boxes", "masks"])
def test_predict_on_jax_head_outputs_equals_jax(masks):
    jmodel, v, _ = _pair(64, masks)
    outs = [np.asarray(o) for o in jmodel.apply(v, jnp.asarray(_images(64, seed=4)),
                                                train=False)]
    # Scores above the threshold on many anchors, so that NMS has work.
    outs[0] = outs[0] + 3.0
    anchors = tr.generate_anchors(64)
    want = jax.device_get(_jax_predict(outs, anchors, masks, 200))
    kw = dict(coeffs=_t(outs[2]), protos=_t(outs[3])) if masks else {}
    got = tr.predict(_t(outs[0]), _t(outs[1]), _t(anchors), max_detections=200, **kw)
    assert set(got) == set(want)
    for k in want:
        if k == "boxes":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=3e-5)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() > 4 and not got["valid"].all()


@needs_jax
def test_nms_fixed_equals_jax_with_ties():
    rng = np.random.default_rng(9)
    boxes = np.stack([_random_boxes(rng, 60, 100.0) for _ in range(3)])
    boxes[:, 5] = boxes[:, 4]  # duplicated boxes
    scores = rng.uniform(0, 1, (3, 60)).astype(np.float32)
    scores[:, 10:14] = 0.75  # equal scores: the first index goes first
    scores[:, 40:] = 0.0
    want = jax.vmap(lambda b, s: jr.nms_fixed(b, s, 30, 0.5))(jnp.asarray(boxes),
                                                              jnp.asarray(scores))
    got = tr.nms_fixed(_t(boxes), _t(scores), 30, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _classifier_checkpoint(tmp_path):
    """A saved classifier TrainState of the port's ResNet at the tiny
    detector's backbone depths, and its model."""
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(lambda g: resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=8,
                                              generator=g),
                      TrainerConfig(learning_rate=1e-3, has_train_arg=True), device="cpu")
    state = trainer.init(seed=3)
    ck = Checkpointer(tmp_path / "cls", interval_s=None, async_save=False)
    ck.save(1, state)
    ck.close()
    return tmp_path / "cls", state.model


@needs_jax
def test_load_pretrained_backbone_transfers_what_jax_transfers(tmp_path):
    from deeplearning_cfn_tpu.models.resnet import ResNet as JaxResNet
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer

    path, classifier = _classifier_checkpoint(tmp_path)
    raw, step = Checkpointer(path, async_save=False).restore_raw()
    assert step == 1
    det = tr.RetinaNet(**ARCH, generator=torch.Generator().manual_seed(0))
    fpn_before = {k: t.clone() for k, t in det.state_dict().items()
                  if not k.startswith("backbone.")}
    n = tr.load_pretrained_backbone(det, raw)
    src = classifier.state_dict()
    for k, t in det.backbone.state_dict().items():
        assert torch.equal(t, src[k]), k
    assert all(torch.equal(det.state_dict()[k], t) for k, t in fpn_before.items())
    # JAX's transfer on the same architectures counts the same leaves.
    x = jnp.zeros((1, 64, 64, 3))
    cls_vars = jax.jit(lambda k: JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=8).init(
        k, x, train=False))(jax.random.key(0))
    det_vars = jax.jit(lambda k: jr.RetinaNet(**ARCH).init(k, x, train=False))(
        jax.random.key(1))
    _, _, jn = jr.load_pretrained_backbone(
        det_vars["params"], {"batch_stats": det_vars["batch_stats"]},
        {"params": cls_vars["params"], "model_state": {"batch_stats": cls_vars["batch_stats"]}})
    assert n == jn == len(det.backbone.state_dict())
    with pytest.raises(ValueError, match="no backbone parameters transferred"):
        tr.load_pretrained_backbone(det, {"model": {"something_else": torch.zeros(1)}})


def test_train_flops_counts_the_network():
    arch = dict(ARCH, with_masks=True)
    flops = tr.train_flops(arch, (4, 64, 64, 3))
    assert flops > 0 and flops == 4 * tr.train_flops(arch, (1, 64, 64, 3))


def test_bf16_stride2_conv_of_one_pixel_has_a_finite_weight_gradient():
    """PyTorch's CPU bf16 convolution returns a non-finite weight gradient at
    random for a 1×1 input at stride 2 with the padding inside the
    convolution (the FPN's p7 at 64 px); the port's Conv pads first there."""
    conv = resnet.Conv(16, 16, 3, 2, bias=True, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    for seed in range(10):
        conv.zero_grad()
        x = torch.randn(4, 16, 1, 1, generator=torch.Generator().manual_seed(seed))
        conv(x.contiguous(memory_format=torch.channels_last)).float().sum().backward()
        assert torch.isfinite(conv.weight.grad).all() and torch.isfinite(conv.bias.grad).all()
