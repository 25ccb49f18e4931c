"""Fixture sources for ``first-network-session.sh``: small datasets in the
exact layouts the session's downloads produce (``DLCFN_FNS_SRC``), so
that every stage after the download (convert, train to a target with a
held-out eval, ImageNet's recipe, COCO detection with mAP) runs without a
network.  The writers draw what the JAX package's test writers draw, from
the same seeds; ``SMOKE_ENV`` holds the sizes the JAX package's
``tests/test_first_network_script.py`` runs its session at.

    python -m deeplearning_cfn_tpu_torch.scripts.fns_fixtures SRC_DIR
"""

from __future__ import annotations

import argparse
import gzip
import json
import pickle
import shutil
import struct
import tempfile
from pathlib import Path

import numpy as np

# The session's knobs at the JAX test's sizes: CIFAR 12 steps at batch 16,
# ImageNet at 32 px (8 px margin) for 2 steps, COCO at 64 px for 2 steps
# with the tiny backbone, targets that the CIFAR run can reach and the
# ImageNet run cannot.
SMOKE_ENV = {
    "DLCFN_FNS_TARGET": "0.05",
    "DLCFN_FNS_STEPS": "12",
    "DLCFN_FNS_DET_STEPS": "2",
    "DLCFN_FNS_SIZE": "64",
    "DLCFN_FNS_BATCH": "16",
    "DLCFN_FNS_DET_BATCH": "2",
    "DLCFN_FNS_DET_BACKBONE": "tiny",
    "DLCFN_FNS_IN_STEPS": "2",
    "DLCFN_FNS_IN_BATCH": "4",
    "DLCFN_FNS_IN_SIZE": "32",
    "DLCFN_FNS_IN_MARGIN": "8",
    "DLCFN_FNS_IN_TARGET": "2.0",
}
COCO_IMAGES = 12
COCO_TRAIN = 9  # the first nine images train, the rest validate


def write_cifar10_fixture(root: Path, n_per_batch: int = 40, n_batches: int = 2,
                          seed: int = 0) -> None:
    """cifar-10-batches-py: pickled dicts with b'data' [N, 3072] CHW-planar
    uint8 and b'labels'; the last batch is test_batch."""
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for b in range(n_batches + 1):
        images = rng.integers(0, 256, (n_per_batch, 3, 32, 32), dtype=np.uint8)
        payload = {b"data": images.reshape(n_per_batch, 3072),
                   b"labels": rng.integers(0, 10, n_per_batch).tolist(),
                   b"batch_label": f"batch {b}".encode()}
        name = "test_batch" if b == n_batches else f"data_batch_{b + 1}"
        with open(d / name, "wb") as f:
            pickle.dump(payload, f)


def write_mnist_fixture(root: Path, n: int = 64, seed: int = 0) -> None:
    """The training idx3/idx1 files, gzipped (the published form)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    with gzip.open(root / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 0x00000803, n, 28, 28) + images.tobytes())
    with gzip.open(root / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 0x00000801, n) + labels.tobytes())


def write_imagefolder_fixture(root: Path, classes=("ant", "bee"), per_class: int = 3,
                              seed: int = 0) -> None:
    """torchvision's ImageFolder layout: ``<root>/<class>/*.png``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img{i}.png")


def write_coco_fixture(root: Path, n_images: int = 4, seed: int = 0) -> tuple[Path, Path, list]:
    """COCO: ``<root>/images/im<i>.jpg`` and an instances file with holey
    category ids and rectangle polygons; returns (image dir, annotation
    file, the images' entries)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    images, annotations = [], []
    categories = [{"id": cid, "name": f"c{cid}"} for cid in (1, 3, 7)]
    aid = 1
    for i in range(n_images):
        h, w = int(rng.integers(60, 100)), int(rng.integers(60, 100))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"im{i}.jpg")
        images.append({"id": i, "file_name": f"im{i}.jpg", "height": h, "width": w})
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(5, w // 2)), int(rng.integers(5, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            annotations.append({
                "id": aid, "image_id": i, "category_id": int(rng.choice([1, 3, 7])),
                "bbox": [x0, y0, bw, bh],
                "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]],
                "iscrowd": 0, "area": bw * bh})
            aid += 1
    ann_path = root / "instances_train.json"
    ann_path.write_text(json.dumps(
        {"images": images, "annotations": annotations, "categories": categories},
        allow_nan=False))
    return img_dir, ann_path, images


def write_sources(src: Path, datasets=("cifar", "mnist", "coco", "imagenet")) -> Path:
    """``src`` laid out as the session's download stage leaves it (ImageNet
    as the ImageFolder tree ``DLCFN_FNS_SRC`` must hold), at the JAX
    test's sizes: CIFAR 2 x 64 training images, MNIST 32, COCO 12 images
    (9 train, 3 val), ImageNet 2 classes x 8 train and x 4 val."""
    src = Path(src)
    if "cifar" in datasets:
        write_cifar10_fixture(src / "cifar", n_per_batch=64, n_batches=2)
    if "mnist" in datasets:
        write_mnist_fixture(src / "mnist", n=32)
    if "coco" in datasets:
        with tempfile.TemporaryDirectory() as tmp:
            img_dir, ann_path, images = write_coco_fixture(Path(tmp), n_images=COCO_IMAGES)
            for split in ("train", "val"):
                (src / "coco" / split).mkdir(parents=True)
            for i, info in enumerate(images):
                split = "train" if i < COCO_TRAIN else "val"
                shutil.copy(img_dir / info["file_name"], src / "coco" / split / info["file_name"])
            shutil.copy(ann_path, src / "coco" / "instances_val2017.json")
    if "imagenet" in datasets:
        write_imagefolder_fixture(src / "imagenet" / "train", per_class=8)
        write_imagefolder_fixture(src / "imagenet" / "val", per_class=4, seed=7)
    return src


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    args = ap.parse_args(argv)
    names = ("cifar", "mnist", "coco", "imagenet")
    write_sources(Path(args.src), names)
    print(json.dumps({"src": args.src, "datasets": list(names), "env": SMOKE_ENV},
                     allow_nan=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
