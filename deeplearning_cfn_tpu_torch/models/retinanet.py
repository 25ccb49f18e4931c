"""RetinaNet-style dense detector with the prototype-mask head — counterpart
of ``deeplearning_cfn_tpu/models/retinanet.py``.

The same network, objectives and inference, every shape static:

- the port's ResNet (``models/resnet.py``, ``return_features=True``) and an
  FPN over {C3, C4, C5} -> {P3..P7}; ``p6`` reads C5 (not P5), ``p6`` and
  ``p7`` are 3×3 stride-2 convolutions with Flax's ``SAME`` pads
  (asymmetric on an even input, ``models/resnet.same_pads``); the upsample
  is a nearest-neighbour 2× repeat;
- one ``HeadSubnet`` per head shared over the five levels; its output is
  reshaped from **NHWC** ``[b, h, w, A·K]`` to ``[b, h·w·A, K]``, the order
  :func:`generate_anchors` lays the anchors out in (the port's convolutions
  are channels-last NCHW tensors, so the output is permuted to NHWC first);
- with ``--bf16`` the backbone, the FPN and the towers compute in bf16, the
  ``pred`` convolutions and the protonet's ``proto`` in f32 on the bf16
  tower output promoted; the class ``pred`` bias starts at
  ``-log((1 - 0.01) / 0.01)``;
- ``freeze_backbone_norm`` calls the backbone with ``train=False``: its
  BatchNorm statistics freeze, its scale and bias still train;
- matching, losses, NMS and ``predict`` are batched over images and equal
  to ``vmap`` of the JAX per-image functions: ``argmax`` takes the first
  maximum on both sides, the mask loss's ``top_k`` is a stable descending
  sort (the lower index first among equal IoUs, as ``lax.top_k``), the
  focal loss's one-hot is built by comparison with ``arange(K)`` (the
  −1 background and −2 ignore targets give zero rows, as
  ``jax.nn.one_hot``); nothing reads a value back to the host.

The counts the losses divide by (positive anchors, mask slots) are the whole
batch's over several data ranks (``parallel/data_ranks.py``), as JAX's
global normaliser under GSPMD.  No kernel of the port runs here: the JAX
model is plain XLA, and the port's convolutions go to cuDNN.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.models.resnet import Conv, ResNet
from deeplearning_cfn_tpu_torch.parallel.data_ranks import global_count

ANCHOR_SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS_PER_CELL = len(ANCHOR_SCALES) * len(ANCHOR_RATIOS)

# ---------------------------------------------------------------------------
# Anchors and box geometry
# ---------------------------------------------------------------------------


def generate_anchors(
    image_size: int,
    levels: Sequence[int] = (3, 4, 5, 6, 7),
    anchor_size: float = 4.0,
) -> np.ndarray:
    """All anchors over the pyramid as [N, 4] (y1, x1, y2, x2), float32: per
    level, per cell, per anchor, the order of the head's output.  Level l
    has stride 2**l and base side ``anchor_size * stride``."""
    boxes = []
    for level in levels:
        stride = 2**level
        feat = int(math.ceil(image_size / stride))
        base = anchor_size * stride
        cy = (np.arange(feat) + 0.5) * stride
        cx = (np.arange(feat) + 0.5) * stride
        cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
        for scale in ANCHOR_SCALES:
            for ratio in ANCHOR_RATIOS:
                h = base * scale * math.sqrt(ratio)
                w = base * scale / math.sqrt(ratio)
                level_boxes = np.stack(
                    [cyg - h / 2, cxg - w / 2, cyg + h / 2, cxg + w / 2], axis=-1
                ).reshape(-1, 4)
                boxes.append(level_boxes)
    per_level = []
    idx = 0
    for level in levels:
        stride = 2**level
        feat = int(math.ceil(image_size / stride))
        n_cells = feat * feat
        level_group = boxes[idx: idx + NUM_ANCHORS_PER_CELL]
        idx += NUM_ANCHORS_PER_CELL
        per_level.append(np.stack(level_group, axis=1).reshape(n_cells * NUM_ANCHORS_PER_CELL, 4))
    return np.concatenate(per_level, axis=0).astype(np.float32)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes ``a [..., N, 4]`` against ``b [..., M, 4]`` (y1, x1, y2,
    x2), leading axes broadcast: ``[..., N, M]``."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Anchor-relative (dy, dx, dh, dw) regression targets, elementwise over
    broadcast leading axes."""
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    acy = anchors[..., 0] + ah / 2
    acx = anchors[..., 1] + aw / 2
    bh = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    bw = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    bcy = boxes[..., 0] + bh / 2
    bcx = boxes[..., 1] + bw / 2
    return torch.stack([(bcy - acy) / ah, (bcx - acx) / aw, torch.log(bh / ah),
                        torch.log(bw / aw)], dim=-1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`."""
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    acy = anchors[..., 0] + ah / 2
    acx = anchors[..., 1] + aw / 2
    cy = deltas[..., 0] * ah + acy
    cx = deltas[..., 1] * aw + acx
    h = torch.exp(deltas[..., 2].clamp(-10.0, 4.0)) * ah
    w = torch.exp(deltas[..., 3].clamp(-10.0, 4.0)) * aw
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[b, idx[b, j]]`` for ``t [B, N, ...]`` and ``idx [B, J]``."""
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[rows, idx]


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    fg_iou: float = 0.5,
    bg_iou: float = 0.4,
):
    """Per-anchor targets from padded ground truth, batched over images:
    ``gt_boxes [B, M, 4]`` padded with zeros, ``gt_classes [B, M]`` padded
    with -1.  Returns (cls_target [B, N] in {-2 ignore, -1 background,
    0..K-1}, box_target [B, N, 4], fg_mask [B, N], best_gt [B, N], best_iou
    [B, N])."""
    valid = (gt_classes >= 0).to(torch.float32)
    iou = box_iou(anchors, gt_boxes) * valid[:, None, :]
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    matched_class = torch.gather(gt_classes.long(), 1, best_gt)
    fg = best_iou >= fg_iou
    ignore = (best_iou > bg_iou) & (best_iou < fg_iou)
    cls_target = torch.where(fg, matched_class, -1)
    cls_target = torch.where(ignore, -2, cls_target)
    box_target = encode_boxes(anchors, _take(gt_boxes, best_gt))
    return cls_target, box_target, fg, best_gt, best_iou


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def focal_loss(
    logits: torch.Tensor,
    cls_target: torch.Tensor,
    num_classes: int,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-anchor sigmoid focal loss summed over classes, ``[B, N]``; the
    ignored anchors (-2) contribute 0."""
    logits = logits.to(torch.float32)
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (cls_target[..., None] == classes).to(torch.float32)
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, onehot)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    not_ignored = (cls_target != -2).to(torch.float32)
    return loss.sum(dim=-1) * not_ignored


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    err = pred - target
    abs_err = err.abs()
    quad = abs_err.clamp_max(delta)
    return (0.5 * quad**2 + delta * (abs_err - quad)).sum(dim=-1)


def detection_loss(
    cls_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    num_classes: int,
    box_loss_weight: float = 50.0,
):
    """Batched focal + box loss on padded ground truth, normalised by the
    batch's positive-anchor count."""
    cls_t, box_t, fg, _, _ = match_anchors(anchors, gt_boxes, gt_classes)
    fg = fg.to(torch.float32)
    num_pos, denom = global_count(fg.sum())
    cls_loss = focal_loss(cls_logits, cls_t, num_classes).sum() / denom
    per_anchor_box = huber_loss(box_deltas.to(torch.float32), box_t)
    box_loss = (per_anchor_box * fg).sum() / denom
    total = cls_loss + box_loss_weight * box_loss
    return total, {"cls_loss": cls_loss, "box_loss": box_loss, "num_pos": num_pos}


def _inside(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[..., h, w]`` bool: the cells of an ``h × w`` grid inside each of
    ``boxes [..., 4]`` (grid units; the YOLACT crop)."""
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, :]
    b = boxes[..., None, None, :]
    return (ys >= b[..., 0]) & (ys < b[..., 2]) & (xs >= b[..., 1]) & (xs < b[..., 3])


def mask_loss(
    protos: torch.Tensor,      # [B, h, w, P] (stride-8 prototypes)
    coeffs: torch.Tensor,      # [B, N, P]
    anchors: torch.Tensor,     # [N, 4] (image pixels)
    gt_boxes: torch.Tensor,    # [B, M, 4]
    gt_classes: torch.Tensor,  # [B, M] (-1 = padding)
    gt_masks: torch.Tensor,    # [B, M, h, w] uint8 at prototype stride
    max_pos: int = 32,
    mask_stride: int = 8,
):
    """Prototype-mask BCE on a fixed budget of positive anchors: per image
    the ``max_pos`` best-IoU foreground anchors (a stable descending sort,
    the lower index first among ties), their masks ``protos @ coeff``, BCE
    against the matched instance's mask inside its box, over the box area.
    Normalised by the batch's count of valid slots."""
    _, h, w, P = protos.shape
    _, _, fg, best_gt, best_iou = match_anchors(anchors, gt_boxes, gt_classes)
    score = torch.where(fg, best_iou, -1.0)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :max_pos]
    valid = (torch.gather(score, 1, top) > 0.0).to(torch.float32)
    coeff = _take(coeffs, top)                                    # [B, S, P]
    pred = torch.einsum("bhwk,bsk->bshw", protos, coeff)
    gt_idx = torch.gather(best_gt, 1, top)
    target = _take(gt_masks, gt_idx).to(torch.float32)            # [B, S, h, w]
    inside = _inside(_take(gt_boxes, gt_idx) / mask_stride, h, w).to(torch.float32)
    bce = sigmoid_bce(pred, target) * inside
    area = inside.sum(dim=(2, 3)).clamp_min(1.0)
    per_slot = bce.sum(dim=(2, 3)) / area
    n, denom = global_count(valid.sum())
    loss = (per_slot * valid).sum() / denom
    return loss, {"mask_loss": loss, "mask_slots": n}


def detection_loss_with_masks(
    cls_logits, box_deltas, coeffs, protos, anchors,
    gt_boxes, gt_classes, gt_masks, num_classes,
    box_loss_weight: float = 50.0, mask_loss_weight: float = 6.125,
    max_pos: int = 32, mask_stride: int = 8,
):
    """Box and class losses plus the prototype mask BCE."""
    total, aux = detection_loss(cls_logits, box_deltas, anchors, gt_boxes, gt_classes,
                                num_classes, box_loss_weight)
    m_loss, m_aux = mask_loss(protos, coeffs, anchors, gt_boxes, gt_classes, gt_masks,
                              max_pos=max_pos, mask_stride=mask_stride)
    return total + mask_loss_weight * m_loss, {**aux, **m_aux}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class FPN(nn.Module):
    """Feature pyramid over {C3, C4, C5} -> [P3..P7], NCHW tensors."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        c3, c4, c5 = in_channels

        def conv(i, k, s=1):
            return Conv(i, channels, k, s, bias=True, dtype=dtype, generator=generator)

        self.lat5, self.lat4, self.lat3 = conv(c5, 1), conv(c4, 1), conv(c3, 1)
        self.post3, self.post4, self.post5 = (conv(channels, 3) for _ in range(3))
        self.p6, self.p7 = conv(c5, 3, 2), conv(channels, 3, 2)

    def forward(self, feats: dict[str, torch.Tensor]) -> list[torch.Tensor]:
        c3, c4, c5 = (_nchw(feats[k]) for k in ("C3", "C4", "C5"))
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5)
        p3 = self.lat3(c3) + _upsample2(p4)
        p6 = self.p6(c5)
        return [self.post3(p3), self.post4(p4), self.post5(p5), p6, self.p7(torch.relu(p6))]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× over H and W (each value repeated, exact)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class HeadSubnet(nn.Module):
    """``depth`` conv-``channels`` towers and an f32 prediction conv, shared
    across the pyramid levels: ``[b, C, h, w]`` -> ``[b, h·w·A, out]``."""

    def __init__(self, out_per_anchor: int, channels: int = 256, depth: int = 4,
                 dtype: torch.dtype = torch.float32, bias_prior: float | None = None,
                 generator=None):
        super().__init__()
        self.out_per_anchor, self.depth = out_per_anchor, depth
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(channels, channels, 3, bias=True, dtype=dtype,
                                             generator=generator))
        self.pred = Conv(channels, NUM_ANCHORS_PER_CELL * out_per_anchor, 3, bias=True,
                         dtype=torch.float32, generator=generator)
        if bias_prior is not None:  # the focal-loss prior: p ≈ bias_prior at the start
            with torch.no_grad():
                self.pred.bias.fill_(-math.log((1 - bias_prior) / bias_prior))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = self.pred(x).permute(0, 2, 3, 1)  # NHWC, the anchors' order
        b, h, w, _ = x.shape
        return x.reshape(b, h * w * NUM_ANCHORS_PER_CELL, self.out_per_anchor)


class ProtoNet(nn.Module):
    """Prototype-mask generator (YOLACT): a conv tower over P3 and an f32 1×1
    conv to ``num_prototypes`` full-scene mask bases at stride 8, ReLU'd;
    NHWC out ``[B, S/8, S/8, P]``."""

    def __init__(self, num_prototypes: int = 16, channels: int = 256, depth: int = 3,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(channels, channels, 3, bias=True, dtype=dtype,
                                             generator=generator))
        self.proto = Conv(channels, num_prototypes, 1, bias=True, dtype=torch.float32,
                          generator=generator)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        x = p3
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return torch.relu(self.proto(x)).permute(0, 2, 3, 1)


class RetinaNet(nn.Module):
    """``forward(images [B, S, S, 3], train=True)`` -> (class_logits [B, N,
    K], box_deltas [B, N, 4]), f32, N the anchors over P3..P7; with
    ``with_masks`` also (mask_coeffs [B, N, P] (tanh, f32), prototypes
    [B, S/8, S/8, P])."""

    def __init__(
        self,
        num_classes: int = 80,
        backbone_stages: Sequence[int] = (3, 4, 6, 3),
        fpn_channels: int = 256,
        dtype: torch.dtype = torch.float32,
        freeze_backbone_norm: bool = False,
        with_masks: bool = False,
        num_prototypes: int = 16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.freeze_backbone_norm, self.with_masks = freeze_backbone_norm, with_masks
        self.backbone = ResNet(stage_sizes=tuple(backbone_stages), num_filters=64, dtype=dtype,
                               return_features=True, generator=generator)
        feats = [64 * 2**i * 4 for i in (1, 2, 3)]  # C3, C4, C5 channels
        self.fpn = FPN(feats, fpn_channels, dtype, generator)
        self.cls_head = HeadSubnet(num_classes, fpn_channels, dtype=dtype, bias_prior=0.01,
                                   generator=generator)
        self.box_head = HeadSubnet(4, fpn_channels, dtype=dtype, generator=generator)
        if with_masks:
            self.coeff_head = HeadSubnet(num_prototypes, fpn_channels, dtype=dtype,
                                         generator=generator)
            self.protonet = ProtoNet(num_prototypes, fpn_channels, dtype=dtype,
                                     generator=generator)

    def forward(self, images: torch.Tensor, train: bool = True):
        # The freeze comes from the train argument, not the module's .training.
        feats = self.backbone(images, train=train and not self.freeze_backbone_norm)
        pyramid = self.fpn(feats)
        cls_out = torch.cat([self.cls_head(p) for p in pyramid], dim=1)
        box_out = torch.cat([self.box_head(p) for p in pyramid], dim=1)
        if not self.with_masks:
            return cls_out, box_out
        coeff_out = torch.tanh(torch.cat([self.coeff_head(p) for p in pyramid], dim=1))
        return cls_out, box_out, coeff_out.to(torch.float32), self.protonet(pyramid[0])


def train_flops(arch: dict, x_shape: Sequence[int]) -> float:
    """FLOPs of one training step (forward and backward of the network) of
    ``RetinaNet(**arch)`` on a batch of shape ``x_shape`` (NHWC), as
    ``FlopCounterMode`` counts them: one image on a twin built on the
    ``meta`` device, times the batch.  The losses' own products (the mask
    loss's ``[32, P] @ [P, h·w]`` an image) are not in it."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        twin = RetinaNet(**arch)
        x = torch.empty((1, *x_shape[1:]), dtype=torch.float32)
    with FlopCounterMode(display=False) as counter:
        sum(o.sum() for o in twin(x, train=True)).backward()
    return float(counter.get_total_flops()) * int(x_shape[0])


# ---------------------------------------------------------------------------
# Pretrained-backbone transfer
# ---------------------------------------------------------------------------


@torch.no_grad()
def load_pretrained_backbone(model: RetinaNet, classifier_ckpt: dict) -> int:
    """A ResNet classifier's checkpoint (``Checkpointer.restore_raw()[0]``
    of a ``resnet_imagenet`` run: ``{"model": state dict, ...}``) into the
    detector's ``backbone``, in place: every tensor whose name and shape
    both sides have, the BatchNorm statistics included; the classifier's
    ``head`` has no counterpart and is dropped, the FPN and heads keep their
    initialisation.  Returns the number of tensors copied; raises when none
    transfers."""
    src = classifier_ckpt.get("model", {})
    dst = model.backbone.state_dict()
    copied = 0
    for key, value in src.items():
        if key in dst and tuple(value.shape) == tuple(dst[key].shape):
            dst[key].copy_(value.to(dst[key].dtype))
            copied += 1
    if not copied:
        raise ValueError("no backbone parameters transferred — the checkpoint does not look "
                         "like a ResNet classifier's state (or the backbone depths differ)")
    return copied


# ---------------------------------------------------------------------------
# Inference: static-shape decode and NMS
# ---------------------------------------------------------------------------


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_detections: int = 100,
    iou_threshold: float = 0.5,
):
    """Greedy NMS with a fixed iteration count, batched over images (``boxes
    [B, N, 4]``, ``scores [B, N]``): each step emits the argmax-score box
    and zeroes the scores of the boxes it overlaps at ``iou_threshold`` or
    more.  Returns (boxes [B, D, 4], scores [B, D], valid [B, D])."""
    b = boxes.shape[0]
    rows = torch.arange(b, device=boxes.device)
    scores_left = scores.clone()
    out_boxes = boxes.new_zeros((b, max_detections, 4))
    out_scores = scores.new_zeros((b, max_detections))
    for i in range(max_detections):
        best = scores_left.argmax(dim=1)
        best_score = scores_left[rows, best]
        best_box = boxes[rows, best]
        iou = box_iou(best_box[:, None, :], boxes)[:, 0]
        suppress = (iou >= iou_threshold) & (best_score[:, None] > 0)
        scores_left = torch.where(suppress, 0.0, scores_left)
        scores_left[rows, best] = 0.0
        out_boxes[:, i] = best_box
        out_scores[:, i] = best_score
    return out_boxes, out_scores, out_scores > 0


def predict(
    cls_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    anchors: torch.Tensor,
    max_detections: int = 100,
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    coeffs: torch.Tensor | None = None,
    protos: torch.Tensor | None = None,
    mask_stride: int = 8,
) -> dict:
    """The batch's head outputs decoded into final detections: class-agnostic
    NMS over each anchor's best class.  With ``coeffs [B, N, P]`` and
    ``protos [B, h, w, P]`` also ``masks [B, D, h, w]`` (sigmoid > 0.5,
    cropped to the detected box, at prototype stride)."""
    probs = torch.sigmoid(cls_logits.to(torch.float32))
    best_class = probs.argmax(dim=-1)
    best_score = probs.amax(dim=-1)
    best_score = torch.where(best_score >= score_threshold, best_score, 0.0)
    decoded = decode_boxes(anchors, box_deltas.to(torch.float32))
    boxes, scores, valid = nms_fixed(decoded, best_score, max_detections, iou_threshold)
    # Emitted boxes are rows of `decoded`: the IoU argmax finds their anchor.
    src = box_iou(boxes, decoded).argmax(dim=2)
    out = {"boxes": boxes, "scores": scores, "classes": torch.gather(best_class, 1, src),
           "valid": valid}
    if coeffs is not None and protos is not None:
        h, w = protos.shape[1:3]
        pred = torch.einsum("bhwk,bdk->bdhw", protos, _take(coeffs, src))
        out["masks"] = (torch.sigmoid(pred) > 0.5) & _inside(boxes / mask_stride, h, w)
    return out
