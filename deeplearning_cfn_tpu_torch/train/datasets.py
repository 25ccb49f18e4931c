"""Public datasets in their standard on-disk layouts -> DLC1 records: the
port's own copy of ``deeplearning_cfn_tpu/train/datasets.py`` (the port
imports nothing of the JAX package), byte for byte the same records,
sidecars and batch streams.

Each ``convert_*`` reads one layout and writes record files
(``train/records.py``) that the native loader (``train/native_loader.py``)
reads:

- **CIFAR-10** python pickles (``cifar-10-batches-py/data_batch_*`` and
  ``test_batch``);
- **MNIST** idx files (``train-images-idx3-ubyte[.gz]`` etc.);
- **ImageFolder** trees (``<root>/<class_name>/*.jpg``, ImageNet's layout):
  decoded with PIL, the shorter side resized and centre-cropped to a fixed
  square, optionally with a ``margin`` kept for random crops;
- **COCO** detection (``instances_*.json`` and an image directory):
  letterboxed fixed-size images, boxes scaled and padded to ``max_boxes``,
  optionally the instance masks rasterised at a stride;
- **text**: fixed windows of token ids, byte-level (256 bytes and a BOS,
  vocabulary 257) or through a local tokenizer directory.

Images are stored as uint8 and normalised in the train step
(``TrainerConfig.input_stats``) or on the host (:func:`normalize_images`);
the per-channel statistics live here, and each converter pins its own in a
``stats.json`` sidecar.  PIL and ``transformers`` are imported inside the
functions that need them: a host without them can still read records.
"""

from __future__ import annotations

import gzip
import json
import pickle
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from deeplearning_cfn_tpu_torch.train.batch import Batch
from deeplearning_cfn_tpu_torch.train.records import Field, RecordSpec, write_records
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.datasets")

# Per-channel statistics (uint8 domain /255) — the standard published
# values, used by both the converter-side docs and normalize_images.
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
MNIST_MEAN = np.array([0.1307], np.float32)
MNIST_STD = np.array([0.3081], np.float32)


class DatasetFormatError(ValueError):
    pass


def write_stats_sidecar(
    out_dir: str | Path, dataset: str, mean: np.ndarray, std: np.ndarray
) -> None:
    """``stats.json`` next to the records: pins the normalization identity
    at convert time so loaders never have to guess it from image shape."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stats.json").write_text(
        json.dumps(
            {"dataset": dataset, "mean": mean.tolist(), "std": std.tolist()}
        )
    )


def read_stats_sidecar(root: str | Path) -> "ImageStats | None":
    try:
        payload = json.loads((Path(root) / "stats.json").read_text())
        return ImageStats(
            np.asarray(payload["mean"], np.float32),
            np.asarray(payload["std"], np.float32),
        )
    except (FileNotFoundError, json.JSONDecodeError, KeyError, ValueError):
        return None


def normalize_images(
    x_u8: np.ndarray, mean: np.ndarray, std: np.ndarray
) -> np.ndarray:
    """[B, H, W, C] uint8 -> float32, (x/255 - mean)/std per channel."""
    return ((x_u8.astype(np.float32) / 255.0) - mean) / std


def flipped_batches(
    batches: Iterator[Batch], seed: int = 0, copy: bool = False
) -> Iterator[Batch]:
    """Horizontal-flip augmentation (per-image coin flip, [B, H, W, C]
    layout) — the one shared implementation for both the uint8 fast path
    and the host-normalized float path.  ``copy=True`` leaves the source
    batch untouched (required when the source yields reused buffers)."""
    rng = np.random.default_rng(seed)
    for b in batches:
        flips = rng.random(len(b.x)) < 0.5
        x = b.x
        if flips.any():
            if copy:
                x = x.copy()
            x[flips] = x[flips, :, ::-1]
        yield Batch(x=x, y=b.y)


def random_crop_batches(
    batches: Iterator[Batch],
    out_hw: tuple[int, int],
    pad: int = 0,
    seed: int = 0,
) -> Iterator[Batch]:
    """Random-crop augmentation ([B, H, W, C] layout) — the second half of
    the standard vision recipe (flip alone cannot carry ResNet-50 to 76%
    or VGG reliably to the reference's 92%, README.md:141).

    Two source shapes, one behavior — every output is ``out_hw``:

    - records LARGER than ``out_hw`` (converted with a pixel margin,
      ``convert_imagefolder(margin=...)``): a random window per image —
      the fixed-shape-records analog of torchvision's RandomCrop.
    - records EQUAL to ``out_hw`` with ``pad`` > 0: zero-pad then crop,
      the classic CIFAR pad-4 recipe.

    Output arrays are freshly allocated, so downstream in-place transforms
    (flip) are safe without another copy.
    """
    rng = np.random.default_rng(seed)
    th, tw = out_hw
    for b in batches:
        x = b.x
        n, h, w, c = x.shape
        if (h, w) == (th, tw) and pad:
            padded = np.zeros((n, h + 2 * pad, w + 2 * pad, c), x.dtype)
            padded[:, pad : pad + h, pad : pad + w] = x
            x, h, w = padded, h + 2 * pad, w + 2 * pad
        if (h, w) == (th, tw):
            # pad=0 degenerate passthrough still honors the "freshly
            # allocated output" contract: downstream flips work in place
            # and must never reach the source's buffer.
            yield Batch(x=x.copy(), y=b.y)
            continue
        if h < th or w < tw:
            raise ValueError(f"cannot crop {h}x{w} records to {th}x{tw}")
        ys = rng.integers(0, h - th + 1, n)
        xs = rng.integers(0, w - tw + 1, n)
        out = np.empty((n, th, tw, c), x.dtype)
        for i in range(n):
            out[i] = x[i, ys[i] : ys[i] + th, xs[i] : xs[i] + tw]
        yield Batch(x=out, y=b.y)


def center_crop_batches(
    batches: Iterator[Batch], out_hw: tuple[int, int]
) -> Iterator[Batch]:
    """Deterministic center crop to ``out_hw`` — the eval-side counterpart
    of :func:`random_crop_batches` for margin-converted records (train and
    eval must agree on the model's input size, not on augmentation)."""
    th, tw = out_hw
    for b in batches:
        x = b.x
        _, h, w, _ = x.shape
        if (h, w) == (th, tw):
            # Same fresh-allocation contract as random_crop_batches'
            # passthrough: callers treat crop outputs as in-place-safe.
            yield Batch(x=x.copy(), y=b.y)
            continue
        if h < th or w < tw:
            raise ValueError(f"cannot crop {h}x{w} records to {th}x{tw}")
        top, left = (h - th) // 2, (w - tw) // 2
        yield Batch(x=x[:, top : top + th, left : left + tw].copy(), y=b.y)


def write_layout_sidecar(
    out_dir: str | Path, split: str, image_px: int, channels: int
) -> None:
    """``<split>.layout.json`` next to the records: pins the stored image
    geometry/dtype explicitly.  Margin-converted records are LARGER than
    the model's input, and guessing the layout from record_size alone is
    ambiguous — a float32 record of side S has exactly the byte count of
    a uint8 record of side 2S, so inference would silently train on
    reinterpreted garbage where an explicit contract raises."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"{split}.layout.json").write_text(
        json.dumps({"image_px": image_px, "channels": channels, "dtype": "uint8"})
    )


def read_layout_sidecar(record_path: str | Path) -> dict | None:
    """The layout sidecar for one ``.dlc`` file (same stem), or None."""
    try:
        return json.loads(
            Path(record_path).with_suffix("").with_suffix(".layout.json").read_text()
        )
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def margin_spec_from_layout(
    record_path: str | Path, record_size: int, image_shape: Sequence[int]
) -> RecordSpec | None:
    """RecordSpec for a margin-converted record file, built ONLY from its
    explicit layout sidecar (never inferred from record_size — see
    write_layout_sidecar).  None unless the sidecar exists, matches the
    file's record_size exactly, and is at least the model's input size."""
    layout = read_layout_sidecar(record_path)
    if not layout or layout.get("dtype") != "uint8":
        return None
    side = int(layout.get("image_px", 0))
    channels = int(layout.get("channels", 0))
    if channels != int(image_shape[-1]):
        return None
    if side < max(int(image_shape[0]), int(image_shape[1])):
        return None
    spec = RecordSpec.classification((side, side, channels), "uint8")
    if spec.record_size != record_size:
        return None
    return spec


def normalized_batches(
    batches: Iterator[Batch],
    mean: np.ndarray,
    std: np.ndarray,
    flip: bool = False,
    seed: int = 0,
) -> Iterator[Batch]:
    """Wrap a uint8-image batch stream with normalization (+ optional
    horizontal-flip augmentation, host-side and cheap)."""

    def normalized():
        for b in batches:
            yield Batch(x=normalize_images(b.x, mean, std), y=b.y)

    # normalize_images allocates fresh float arrays, so in-place flips are
    # safe without a copy.
    return flipped_batches(normalized(), seed=seed) if flip else normalized()


# --- CIFAR-10 ----------------------------------------------------------------

CIFAR10_SPEC = RecordSpec.classification((32, 32, 3), "uint8")


def _load_cifar_batch(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"], np.uint8)
    labels = np.asarray(d.get(b"labels", d.get(b"fine_labels")), np.int32)
    if data.ndim != 2 or data.shape[1] != 3072:
        raise DatasetFormatError(f"{path}: expected [N, 3072] u8, got {data.shape}")
    # Stored CHW-planar (1024 R, 1024 G, 1024 B per row) -> HWC.
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), labels


def convert_cifar10(src: str | Path, out_dir: str | Path) -> dict:
    """``cifar-10-batches-py`` -> ``train.dlc`` + ``test.dlc``."""
    src = Path(src)
    if (src / "cifar-10-batches-py").is_dir():
        src = src / "cifar-10-batches-py"
    train_files = sorted(src.glob("data_batch_*"))
    if not train_files:
        raise DatasetFormatError(f"no data_batch_* files under {src}")
    out_dir = Path(out_dir)
    counts = {}
    for split, files in (
        ("train", train_files),
        ("test", [src / "test_batch"] if (src / "test_batch").exists() else []),
    ):
        if not files:
            continue

        def gen():
            for path in files:
                images, labels = _load_cifar_batch(path)
                for x, y in zip(images, labels):
                    yield CIFAR10_SPEC.encode(x=x, y=y)

        counts[split] = write_records(out_dir / f"{split}.dlc", CIFAR10_SPEC, gen())
        log.info("cifar10 %s: %d records -> %s", split, counts[split], out_dir)
    write_stats_sidecar(out_dir, "cifar10", CIFAR10_MEAN, CIFAR10_STD)
    return {"spec": "cifar10", "out_dir": str(out_dir), "records": counts}


# --- MNIST (idx) -------------------------------------------------------------

MNIST_SPEC = RecordSpec.classification((28, 28, 1), "uint8")


def _open_maybe_gz(path: Path):
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def _read_idx(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        if dtype_code != 0x08:  # unsigned byte — the only MNIST dtype
            raise DatasetFormatError(f"{path}: unsupported idx dtype {dtype_code:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != int(np.prod(dims)):
        raise DatasetFormatError(f"{path}: payload {data.size} != dims {dims}")
    return data.reshape(dims)


def _find_idx(src: Path, stem: str) -> Path | None:
    for suffix in ("", ".gz"):
        p = src / f"{stem}{suffix}"
        if p.exists():
            return p
    return None


def convert_mnist(src: str | Path, out_dir: str | Path) -> dict:
    """idx files (optionally gzipped) -> ``train.dlc`` + ``test.dlc``."""
    src, out_dir = Path(src), Path(out_dir)
    counts = {}
    for split, img_stem, lbl_stem in (
        ("train", "train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        ("test", "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ):
        img_path, lbl_path = _find_idx(src, img_stem), _find_idx(src, lbl_stem)
        if img_path is None or lbl_path is None:
            continue
        images = _read_idx(img_path)[..., None]  # [N, 28, 28, 1]
        labels = _read_idx(lbl_path).astype(np.int32)
        if len(images) != len(labels):
            raise DatasetFormatError(
                f"{split}: {len(images)} images != {len(labels)} labels"
            )
        counts[split] = write_records(
            out_dir / f"{split}.dlc",
            MNIST_SPEC,
            (MNIST_SPEC.encode(x=x, y=y) for x, y in zip(images, labels)),
        )
        log.info("mnist %s: %d records -> %s", split, counts[split], out_dir)
    if not counts:
        raise DatasetFormatError(f"no idx files found under {src}")
    write_stats_sidecar(out_dir, "mnist", MNIST_MEAN, MNIST_STD)
    return {"spec": "mnist", "out_dir": str(out_dir), "records": counts}


# --- ImageFolder (ImageNet layout) ------------------------------------------


def _load_image_rgb(path: Path, size: int):
    """Resize shorter side to ~1.15*size then center-crop to size x size —
    the standard ImageNet eval transform, baked at ingestion time because
    DLC1 records are fixed-shape."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = (size * 1.15) / min(w, h)
        im = im.resize(
            (max(size, round(w * scale)), max(size, round(h * scale))),
            Image.BILINEAR,
        )
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)


def imagefolder_spec(size: int) -> RecordSpec:
    return RecordSpec.classification((size, size, 3), "uint8")


def convert_imagefolder(
    src: str | Path,
    out_dir: str | Path,
    size: int = 224,
    split: str = "train",
    class_names: Sequence[str] | None = None,
    margin: int = 0,
) -> dict:
    """``<src>/<class>/*.{jpg,jpeg,png}`` -> ``<split>.dlc``.

    ``class_names`` pins the class->index mapping (pass the training
    split's mapping when converting val so labels agree); default is the
    sorted subdirectory names, torchvision's convention.

    ``margin``: extra pixels stored per side beyond ``size`` — records
    become ``(size+margin)``-square so training can random-crop a fresh
    ``size``-window every epoch (:func:`random_crop_batches`) while
    records stay fixed-shape (one static batch shape).  Eval splits
    should convert with ``margin=0`` (the standard center-crop eval
    transform is baked at ingest).
    """
    src, out_dir = Path(src), Path(out_dir)
    classes = list(class_names) if class_names else sorted(
        p.name for p in src.iterdir() if p.is_dir()
    )
    if not classes:
        raise DatasetFormatError(f"no class subdirectories under {src}")
    index = {c: i for i, c in enumerate(classes)}
    stored = size + max(0, margin)
    spec = imagefolder_spec(stored)

    def gen():
        for cls in classes:
            for img in sorted((src / cls).iterdir()):
                if img.suffix.lower() not in (".jpg", ".jpeg", ".png", ".bmp"):
                    continue
                yield spec.encode(
                    x=_load_image_rgb(img, stored), y=np.int32(index[cls])
                )

    n = write_records(out_dir / f"{split}.dlc", spec, gen())
    (out_dir / "classes.json").write_text(json.dumps(classes))
    write_stats_sidecar(out_dir, "imagenet", IMAGENET_MEAN, IMAGENET_STD)
    write_layout_sidecar(out_dir, split, stored, 3)
    log.info("imagefolder %s: %d records (%d classes, stored %dpx) -> %s",
             split, n, len(classes), stored, out_dir)
    return {
        "spec": f"imagefolder{stored}",
        "out_dir": str(out_dir),
        "records": {split: n},
        "classes": len(classes),
        "stored_px": stored,
    }


# --- COCO detection ----------------------------------------------------------


def detection_spec(size: int, max_boxes: int) -> RecordSpec:
    """Fixed-shape detection record: letterboxed uint8 image + padded
    ground truth (boxes y1,x1,y2,x2 in resized-image pixels; class -1 =
    padding) — the shape contract of the RetinaNet trainer
    (models/retinanet.py fixed-shape matching)."""
    return RecordSpec(
        (
            Field("x", "uint8", (size, size, 3)),
            Field("boxes", "float32", (max_boxes, 4)),
            Field("classes", "int32", (max_boxes,)),
        )
    )


def instance_spec(size: int, max_boxes: int, mask_stride: int = 8) -> RecordSpec:
    """Detection record + per-instance masks at ``mask_stride`` (the
    prototype-mask training resolution, models/retinanet.py mask_loss) —
    fixed shapes end to end: [max_boxes, size/stride, size/stride] uint8
    bitmaps, zero where the instance slot is padding."""
    ms = size // mask_stride
    return RecordSpec(
        (
            Field("x", "uint8", (size, size, 3)),
            Field("boxes", "float32", (max_boxes, 4)),
            Field("classes", "int32", (max_boxes,)),
            Field("masks", "uint8", (max_boxes, ms, ms)),
        )
    )


def _rasterize_polygons(
    segmentation, scale: float, size: int, mask_stride: int
) -> np.ndarray | None:
    """COCO polygon list -> uint8 bitmap at the prototype stride (PIL
    polygon fill — the converter already depends on PIL).  None for RLE
    segmentations (crowd regions, already skipped by the caller)."""
    from PIL import Image, ImageDraw

    if not isinstance(segmentation, list) or not segmentation:
        return None
    ms = size // mask_stride
    im = Image.new("L", (ms, ms), 0)
    draw = ImageDraw.Draw(im)
    for poly in segmentation:
        if len(poly) < 6:
            continue
        pts = [
            (poly[i] * scale / mask_stride, poly[i + 1] * scale / mask_stride)
            for i in range(0, len(poly) - 1, 2)
        ]
        draw.polygon(pts, fill=1)
    return np.asarray(im, np.uint8)


def _letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, float]:
    """Scale longest side to ``size``, pad bottom/right; returns (out, scale)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    im = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    out = np.zeros((size, size, 3), np.uint8)
    out[:nh, :nw] = np.asarray(im, np.uint8)
    return out, scale


def convert_coco(
    images_dir: str | Path,
    annotations: str | Path,
    out_dir: str | Path,
    size: int = 512,
    max_boxes: int = 50,
    split: str = "train",
    masks: bool = False,
    mask_stride: int = 8,
) -> dict:
    """COCO ``instances_*.json`` + image dir -> ``<split>.dlc``.

    Category ids are remapped to a dense [0, n) contiguous range (COCO's
    published ids have holes); the mapping is written next to the records
    as ``categories.json``.

    ``masks=True`` additionally rasterizes each instance's segmentation
    polygons into a fixed [max_boxes, size/stride, size/stride] uint8
    bitmap per record (:func:`instance_spec`) — the instance-mask signal
    the reference's flagship trains on (run.sh:86 MODE_MASK=True).
    """
    from PIL import Image

    images_dir, out_dir = Path(images_dir), Path(out_dir)
    ann = json.loads(Path(annotations).read_text())
    cats = sorted(c["id"] for c in ann.get("categories", []))
    cat_index = {cid: i for i, cid in enumerate(cats)}
    by_image: dict[int, list[dict]] = {}
    for a in ann.get("annotations", []):
        if a.get("iscrowd"):
            continue
        by_image.setdefault(a["image_id"], []).append(a)
    spec = (
        instance_spec(size, max_boxes, mask_stride)
        if masks
        else detection_spec(size, max_boxes)
    )

    skipped = 0

    def gen():
        nonlocal skipped
        ms = size // mask_stride
        for info in ann.get("images", []):
            path = images_dir / info["file_name"]
            if not path.exists():
                skipped += 1
                continue
            with Image.open(path) as im:
                img = np.asarray(im.convert("RGB"), np.uint8)
            out, scale = _letterbox(img, size)
            boxes = np.zeros((max_boxes, 4), np.float32)
            classes = np.full((max_boxes,), -1, np.int32)
            inst_masks = np.zeros((max_boxes, ms, ms), np.uint8) if masks else None
            anns = by_image.get(info["id"], [])[:max_boxes]
            for i, a in enumerate(anns):
                x0, y0, w, h = a["bbox"]  # COCO xywh, original pixels
                boxes[i] = (y0 * scale, x0 * scale, (y0 + h) * scale, (x0 + w) * scale)
                classes[i] = cat_index[a["category_id"]]
                if inst_masks is not None:
                    bitmap = _rasterize_polygons(
                        a.get("segmentation"), scale, size, mask_stride
                    )
                    if bitmap is not None:
                        inst_masks[i] = bitmap
            fields = {"x": out, "boxes": boxes, "classes": classes}
            if inst_masks is not None:
                fields["masks"] = inst_masks
            yield spec.encode(**fields)

    n = write_records(out_dir / f"{split}.dlc", spec, gen())
    (out_dir / "categories.json").write_text(
        json.dumps({"coco_ids": cats, "num_classes": len(cats)})
    )
    if skipped:
        log.warning("coco %s: %d annotated images missing on disk", split, skipped)
    log.info("coco %s: %d records (%d classes) -> %s", split, n, len(cats), out_dir)
    return {
        "spec": f"coco{size}",
        "out_dir": str(out_dir),
        "records": {split: n},
        "classes": len(cats),
        "skipped_images": skipped,
    }


def detection_batches(
    loader, spec: RecordSpec, steps: int | None = None, normalize: bool = True
) -> Iterator[Batch]:
    """Decode detection records from a NativeRecordLoader into the
    trainer's ``Batch(x, y={"boxes", "classes"[, "masks"]})`` shape,
    normalizing images with ImageNet statistics.  Instance-mask records
    (:func:`instance_spec`) pass their bitmaps through.

    ``normalize=False`` yields images in the stored dtype (uint8 for
    image records) — the compact-transfer path, where dequantize +
    normalize run inside the train step via
    ``TrainerConfig.input_stats`` (train/pipeline.py)."""
    has_masks = any(f.name == "masks" for f in spec.fields)
    i = 0
    while steps is None or i < steps:
        raw = loader.next_raw(copy=False)
        if raw is None:
            return
        arrays = spec.decode_batch(raw)
        y = {"boxes": arrays["boxes"], "classes": arrays["classes"]}
        if has_masks:
            y["masks"] = arrays["masks"]
        x = arrays["x"]
        if normalize:
            x = normalize_images(x, IMAGENET_MEAN, IMAGENET_STD)
        yield Batch(x=x, y=y)
        i += 1


# --- text -> token records (causal LM) ---------------------------------------


def token_spec(seq_len: int) -> RecordSpec:
    """One fixed-length token window per record; the trainer derives the
    next-token targets by shifting, so only inputs are stored."""
    return RecordSpec((Field("x", "int32", (seq_len,)),))


def convert_text(
    src: str | Path,
    out_dir: str | Path,
    seq_len: int = 2048,
    tokenizer_dir: str | None = None,
    split: str = "train",
    stride: int | None = None,
) -> dict:
    """Plain-text file(s) -> fixed-window DLC1 token records for the
    causal-LM trainers (the LM counterpart of the image converters).

    ``tokenizer_dir``: a local HuggingFace tokenizer directory
    (tokenizer.json etc., loaded offline via AutoTokenizer) — the
    vocabulary the checkpoint being trained/fine-tuned expects.  Without
    one, a byte-level vocabulary (256 + BOS) is used: self-contained and
    reversible, fine for from-scratch small models.  The choice is pinned
    in ``tokenizer.json`` metadata next to the records.
    """
    src = Path(src)
    out_dir = Path(out_dir)
    files = sorted(src.glob("*.txt")) if src.is_dir() else [src]
    if not files:
        raise DatasetFormatError(f"no .txt files under {src}")
    stride = stride or seq_len

    if tokenizer_dir:
        from transformers import AutoTokenizer  # local dir, offline

        tok = AutoTokenizer.from_pretrained(tokenizer_dir)

        def token_stream(path: Path):
            # Whole-file encode: chunking would change tokenization at
            # chunk boundaries for subword vocabularies.
            yield tok.encode(path.read_text(errors="replace"))

        # len(tok), not tok.vocab_size: added/special tokens emit ids
        # beyond the base vocabulary, and the trainer's embedding-bounds
        # check must see the true ceiling.
        vocab_size = len(tok)
        tokenizer_name = str(tokenizer_dir)
    else:
        BOS = 256

        def token_stream(path: Path):
            # Byte-level tokenization is boundary-free: stream the file
            # in chunks instead of materializing it.
            yield [BOS]
            with open(path, "rb") as f:
                while chunk := f.read(1 << 20):
                    yield list(chunk)

        vocab_size = 257
        tokenizer_name = "byte-level"

    spec = token_spec(seq_len)

    def gen():
        buf: list[int] = []
        off = 0
        for path in files:
            for chunk in token_stream(path):
                buf.extend(chunk)
                while len(buf) - off >= seq_len:
                    window = np.asarray(buf[off : off + seq_len], np.int32)
                    yield spec.encode(x=window)
                    off += stride
                # Amortized O(T): drop consumed tokens once per chunk,
                # not once per window (buf = buf[stride:] per window is
                # quadratic on large files).
                if off:
                    del buf[:off]
                    off = 0

    n = write_records(out_dir / f"{split}.dlc", spec, gen())
    (out_dir / "tokenizer.json").write_text(
        json.dumps(
            {
                "tokenizer": tokenizer_name,
                "vocab_size": vocab_size,
                "seq_len": seq_len,
            }
        )
    )
    log.info("text %s: %d windows of %d tokens -> %s", split, n, seq_len, out_dir)
    return {
        "spec": f"tokens{seq_len}",
        "out_dir": str(out_dir),
        "records": {split: n},
        "vocab_size": vocab_size,
        "tokenizer": tokenizer_name,
    }


def token_batches(loader, spec: RecordSpec, steps: int | None = None):
    """Decode token records into causal-LM Batches: targets are the
    inputs shifted left (the SyntheticTokenDataset convention; the loss
    masks the wrapped final position)."""
    i = 0
    while steps is None or i < steps:
        raw = loader.next_raw(copy=False)
        if raw is None:
            return
        tokens = spec.decode_batch(raw)["x"]
        yield Batch(x=tokens, y=np.roll(tokens, -1, axis=1))
        i += 1


def mlm_batches(
    loader,
    spec: RecordSpec,
    steps: int | None = None,
    mask_prob: float = 0.15,
    mask_token: int = 0,
    seed: int = 0,
):
    """Mask token records on the fly for MLM pretraining: ``mask_prob`` of
    positions are replaced with ``mask_token`` in x; y carries the
    original ids at masked positions and -1 (ignore) elsewhere — the
    SyntheticMLMDataset convention, over real text records."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        raw = loader.next_raw(copy=False)
        if raw is None:
            return
        tokens = spec.decode_batch(raw)["x"]
        masked = rng.random(tokens.shape) < mask_prob
        yield Batch(
            x=np.where(masked, mask_token, tokens).astype(np.int32),
            y=np.where(masked, tokens, -1).astype(np.int32),
        )
        i += 1


def read_tokenizer_sidecar(root: str | Path) -> dict | None:
    try:
        return json.loads((Path(root) / "tokenizer.json").read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None


# --- dispatch ----------------------------------------------------------------

CONVERTERS = {
    "cifar10": convert_cifar10,
    "mnist": convert_mnist,
}


@dataclass(frozen=True)
class ImageStats:
    mean: np.ndarray
    std: np.ndarray


STATS = {
    "cifar10": ImageStats(CIFAR10_MEAN, CIFAR10_STD),
    "mnist": ImageStats(MNIST_MEAN, MNIST_STD),
    "imagenet": ImageStats(IMAGENET_MEAN, IMAGENET_STD),
}
