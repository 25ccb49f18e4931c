"""The port's copy of the detection evaluator
(``deeplearning_cfn_tpu_torch/train/detection_eval.py``) against the
original (``deeplearning_cfn_tpu/train/detection_eval.py``, numpy only), on
the same random detections: every function's output equal, and the
accumulators' results equal (box mAP, mask mAP at stride and at image
resolution, per-class AP, image and ground-truth counts)."""

import numpy as np
import pytest

from deeplearning_cfn_tpu_torch.train import detection_eval as port

# The original's package imports JAX, which the card's host does not have.
orig = pytest.importorskip("deeplearning_cfn_tpu.train.detection_eval")


def _boxes(rng, n, size=64.0):
    pts = rng.uniform(0, size, size=(n, 2, 2))
    return np.concatenate([pts.min(1), pts.max(1) + 1.0], -1).astype(np.float32)


def test_geometry_and_ap_equal_the_original():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 9), _boxes(rng, 5)
    np.testing.assert_array_equal(port.box_iou_np(a, b), orig.box_iou_np(a, b))
    assert port.box_iou_np(a[:0], b).shape == (0, 5)
    ma = rng.integers(0, 2, (4, 8, 8)).astype(np.uint8)
    mb = rng.integers(0, 2, (3, 8, 8)).astype(np.uint8)
    np.testing.assert_array_equal(port.mask_iou_np(ma, mb), orig.mask_iou_np(ma, mb))
    for hw in ((8, 8), (64, 64), (20, 28)):
        np.testing.assert_array_equal(port.upsample_masks(ma, hw), orig.upsample_masks(ma, hw))
    recall = np.sort(rng.uniform(0, 1, 12))
    precision = rng.uniform(0, 1, 12)
    assert port.average_precision(recall, precision) == orig.average_precision(recall, precision)


@pytest.mark.parametrize("iou_kind", ["box", "mask"])
def test_accumulator_equals_the_original_on_random_detections(iou_kind):
    rng = np.random.default_rng(1)
    accs = [m.DetectionAccumulator(num_classes=5, iou_kind=iou_kind) for m in (port, orig)]
    for _ in range(6):
        n_gt, n_det = int(rng.integers(1, 6)), 12
        gt_boxes, gt_classes = _boxes(rng, n_gt), rng.integers(0, 5, n_gt)
        # Detections near the ground truth (some hits) and random ones.
        near = gt_boxes[rng.integers(0, n_gt, n_det)] + rng.normal(0, 3, (n_det, 4))
        pred = np.where(rng.uniform(size=(n_det, 1)) < 0.6, near, _boxes(rng, n_det))
        pred = np.concatenate([pred[:, :2], np.maximum(pred[:, 2:], pred[:, :2] + 1)], -1)
        scores = rng.uniform(0, 1, n_det).astype(np.float32)
        classes = np.where(rng.uniform(size=n_det) < 0.7, gt_classes[rng.integers(0, n_gt, n_det)],
                           rng.integers(0, 5, n_det))
        valid = rng.uniform(size=n_det) < 0.8
        kw = {}
        if iou_kind == "mask":
            gt_m = rng.integers(0, 2, (n_gt, 8, 8)).astype(np.uint8)
            pred_m = np.where(rng.uniform(size=(n_det, 1, 1)) < 0.5,
                              gt_m[rng.integers(0, n_gt, n_det)],
                              rng.integers(0, 2, (n_det, 8, 8))).astype(bool)
            kw = dict(pred_masks=port.upsample_masks(pred_m, (64, 64)),
                      gt_masks=port.upsample_masks(gt_m, (64, 64)))
        for acc in accs:
            acc.add_image(pred.astype(np.float32), scores, classes, valid, gt_boxes,
                          gt_classes, **kw)
    got, want = (acc.result() for acc in accs)
    assert got == want
    assert 0.0 < got["mAP"] < 1.0 and got["images"] == 6
