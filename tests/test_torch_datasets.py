"""The port's dataset converters and batch helpers against the JAX package's.

Every converter runs on the same source, written here in the public layout
(the fixtures of ``tests/test_datasets.py``: CIFAR-10 pickles, gzipped MNIST
idx, an ImageFolder tree, COCO instances with polygons; text files), once
through ``deeplearning_cfn_tpu.train.datasets`` and once through the port's
copy: the ``.dlc`` files and every sidecar must be equal byte for byte, and
the summaries equal but for the output directory.  The batch helpers
(normalise, flip, random and centre crops, detection, token and MLM
batches) run on the same seeded inputs and must give equal arrays: they
draw from ``np.random.default_rng`` in the same order.  ``cli convert``
prints the same JSON and returns the same codes as ``dlcfn convert``.
"""

import gzip
import json
import pickle
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from deeplearning_cfn_tpu import cli as jax_cli
    from deeplearning_cfn_tpu.train import datasets as jax_datasets
    from deeplearning_cfn_tpu.train.data import Batch as JaxBatch
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax_datasets = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.train import datasets  # noqa: E402
from deeplearning_cfn_tpu_torch.train.data import Batch  # noqa: E402
from deeplearning_cfn_tpu_torch.train.records import read_all  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax_datasets is None, reason="needs JAX, the reference")


# --- sources in the public layouts (as tests/test_datasets.py writes them) ---


def write_cifar10_fixture(root, n_per_batch=40, n_batches=2, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for b in range(n_batches + 1):  # the last one is test_batch
        images = rng.integers(0, 256, (n_per_batch, 3, 32, 32), dtype=np.uint8)
        payload = {b"data": images.reshape(n_per_batch, 3072),
                   b"labels": rng.integers(0, 10, n_per_batch).tolist(),
                   b"batch_label": f"batch {b}".encode()}
        name = "test_batch" if b == n_batches else f"data_batch_{b + 1}"
        with open(d / name, "wb") as f:
            pickle.dump(payload, f)


def write_mnist_fixture(root, n=64, seed=0, gz=True):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    opener, suffix = (gzip.open, ".gz") if gz else (open, "")
    for stem in ("train", "t10k"):
        with opener(root / f"{stem}-images-idx3-ubyte{suffix}", "wb") as f:
            f.write(struct.pack(">IIII", 0x00000803, n, 28, 28) + images.tobytes())
        with opener(root / f"{stem}-labels-idx1-ubyte{suffix}", "wb") as f:
            f.write(struct.pack(">II", 0x00000801, n) + labels.tobytes())


def write_imagefolder_fixture(root, classes=("ant", "bee"), per_class=3, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img{i}.png")
        (d / "notes.txt").write_text("not an image")


def write_coco_fixture(root, n_images=4, seed=0):
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
    # A crowd region and an image missing on disk: both skipped.
    annotations.append({"id": aid, "image_id": 0, "category_id": 1, "bbox": [0, 0, 4, 4],
                        "segmentation": {"counts": [1], "size": [4, 4]}, "iscrowd": 1})
    images.append({"id": n_images, "file_name": "missing.jpg", "height": 9, "width": 9})
    ann_path = root / "instances_train.json"
    ann_path.write_text(json.dumps(
        {"images": images, "annotations": annotations, "categories": categories}))
    return img_dir, ann_path


def write_text_fixture(root):
    root.mkdir(parents=True)
    (root / "a.txt").write_text("hello world, " * 50)
    (root / "b.txt").write_text("the quick brown fox. " * 50 + "é ü ñ")
    return root


# --- converters: equal bytes --------------------------------------------------


def _convert(name, src_root, out):
    """(converter name) -> the call on both packages' modules."""
    def call(mod):
        if name == "cifar10":
            return mod.convert_cifar10(src_root, out(mod))
        if name.startswith("mnist"):  # gzipped and raw idx
            return mod.convert_mnist(src_root, out(mod))
        if name == "imagefolder":
            return mod.convert_imagefolder(src_root, out(mod), size=24, split="val",
                                           class_names=["bee", "ant"])
        if name == "imagefolder-margin":
            return mod.convert_imagefolder(src_root, out(mod), size=24, margin=8)
        if name in ("coco", "coco-masks", "coco-masks-stride2"):
            img_dir, ann = src_root
            return mod.convert_coco(img_dir, ann, out(mod), size=64, max_boxes=5,
                                    masks=name != "coco",
                                    mask_stride=2 if name.endswith("stride2") else 8)
        if name == "text":
            return mod.convert_text(src_root, out(mod), seq_len=64)
        if name == "text-stride":
            return mod.convert_text(src_root / "a.txt", out(mod), seq_len=48, stride=20,
                                    split="val")
        raise KeyError(name)
    return call


def _write_source(name, root):
    if name == "cifar10":
        write_cifar10_fixture(root)
        return root
    if name.startswith("mnist"):
        write_mnist_fixture(root, gz=name == "mnist")
        return root
    if name.startswith("imagefolder"):
        write_imagefolder_fixture(root)
        return root
    if name.startswith("coco"):
        return write_coco_fixture(root)
    return write_text_fixture(root)


CONVERSIONS = ["cifar10", "mnist", "mnist-raw", "imagefolder", "imagefolder-margin", "coco",
               "coco-masks", "coco-masks-stride2", "text", "text-stride"]


@needs_jax
@pytest.mark.parametrize("name", CONVERSIONS)
def test_converter_writes_the_jax_converters_bytes(tmp_path, name):
    src = _write_source(name, tmp_path / "src")
    outs = {jax_datasets: tmp_path / "jax", datasets: tmp_path / "port"}
    call = _convert(name, src, outs.__getitem__)
    want, got = call(jax_datasets), call(datasets)
    assert {**got, "out_dir": None} == {**want, "out_dir": None}
    files = sorted(p.name for p in outs[jax_datasets].iterdir())
    assert files == sorted(p.name for p in outs[datasets].iterdir())
    assert any(f.endswith(".dlc") for f in files)
    for f in files:
        assert (outs[datasets] / f).read_bytes() == (outs[jax_datasets] / f).read_bytes(), f


@needs_jax
@pytest.mark.parametrize("name", ["cifar10", "mnist", "text"])
def test_converted_records_decode_to_the_source(tmp_path, name):
    """The bytes are also right, not only JAX's: images in HWC order and
    labels as written, byte tokens with a BOS first."""
    src = _write_source(name, tmp_path / "src")
    out = _convert(name, src, lambda mod: tmp_path / "dlc")(datasets)
    if name == "cifar10":
        recs = read_all(tmp_path / "dlc" / "train.dlc", datasets.CIFAR10_SPEC)
        with open(src / "cifar-10-batches-py" / "data_batch_1", "rb") as f:
            first = pickle.load(f)
        np.testing.assert_array_equal(
            recs["x"][:40], np.asarray(first[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        assert recs["y"][:40].tolist() == first[b"labels"]
        assert out["records"] == {"train": 80, "test": 40}
    elif name == "mnist":
        recs = read_all(tmp_path / "dlc" / "test.dlc", datasets.MNIST_SPEC)
        assert recs["x"].shape == (64, 28, 28, 1)
    else:
        recs = read_all(tmp_path / "dlc" / "train.dlc", datasets.token_spec(64))
        assert recs["x"][0][0] == 256
        assert bytes(recs["x"][0][1:13].astype(np.uint8)).decode() == "hello world,"
        assert datasets.read_tokenizer_sidecar(tmp_path / "dlc") == {
            "tokenizer": "byte-level", "vocab_size": 257, "seq_len": 64}


@needs_jax
@pytest.mark.parametrize("case", ["bad-cifar", "no-mnist", "no-classes", "no-text"])
def test_format_errors_match_jax(tmp_path, case):
    src = tmp_path / "src"
    src.mkdir()
    if case == "bad-cifar":
        with open(src / "data_batch_1", "wb") as f:
            pickle.dump({b"data": np.zeros((2, 10), np.uint8), b"labels": [0, 1]}, f)
    calls = {"bad-cifar": lambda m: m.convert_cifar10(src, tmp_path / "o"),
             "no-mnist": lambda m: m.convert_mnist(src, tmp_path / "o"),
             "no-classes": lambda m: m.convert_imagefolder(src, tmp_path / "o"),
             "no-text": lambda m: m.convert_text(src, tmp_path / "o")}
    with pytest.raises(jax_datasets.DatasetFormatError) as want:
        calls[case](jax_datasets)
    with pytest.raises(datasets.DatasetFormatError) as got:
        calls[case](datasets)
    assert str(got.value) == str(want.value)


@needs_jax
def test_tables_and_sidecars_match_jax(tmp_path):
    assert sorted(datasets.CONVERTERS) == sorted(jax_datasets.CONVERTERS)
    assert sorted(datasets.STATS) == sorted(jax_datasets.STATS)
    for k, v in jax_datasets.STATS.items():
        np.testing.assert_array_equal(datasets.STATS[k].mean, v.mean)
        np.testing.assert_array_equal(datasets.STATS[k].std, v.std)
    assert datasets.read_stats_sidecar(tmp_path) is None
    (tmp_path / "stats.json").write_text("{not json")
    assert datasets.read_stats_sidecar(tmp_path) is None
    assert datasets.read_tokenizer_sidecar(tmp_path) is None


@needs_jax
@pytest.mark.parametrize("layout,record_size,want", [
    ({"image_px": 40, "channels": 3, "dtype": "uint8"}, 40 * 40 * 3 + 4, (40, 40, 3)),
    ({"image_px": 40, "channels": 3, "dtype": "uint8"}, 40 * 40 * 3, None),  # size disagrees
    ({"image_px": 24, "channels": 3, "dtype": "uint8"}, 24 * 24 * 3 + 4, None),  # below 32
    ({"image_px": 40, "channels": 1, "dtype": "uint8"}, 40 * 40 + 4, None),  # channels
    ({"image_px": 40, "channels": 3, "dtype": "float32"}, 40 * 40 * 12 + 4, None),
    (None, 40 * 40 * 3 + 4, None),  # no sidecar: never inferred from the size
])
def test_margin_spec_comes_from_the_layout_sidecar_only(tmp_path, layout, record_size, want):
    if layout is not None:
        (tmp_path / "train.layout.json").write_text(json.dumps(layout))
    args = (tmp_path / "train.dlc", record_size, (32, 32, 3))
    got = datasets.margin_spec_from_layout(*args)
    ref = jax_datasets.margin_spec_from_layout(*args)
    assert (got is None) == (ref is None) == (want is None)
    if want is not None:
        assert got.fields[0].shape == ref.fields[0].shape == want
        assert got.record_size == ref.record_size


# --- batch helpers: equal arrays ----------------------------------------------


def _image_batches(n, shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        x = rng.integers(0, 256, (6, *shape)).astype(dtype)
        yield x, rng.integers(0, 10, 6).astype(np.int32)


def _pair(n, shape, seed=0):
    """The same batches as the port's and as JAX's Batch type."""
    data = list(_image_batches(n, shape, seed))
    return ([Batch(x=x.copy(), y=y) for x, y in data],
            [JaxBatch(x=x.copy(), y=y) for x, y in data])


HELPERS = {
    "flip": lambda m, b: m.flipped_batches(iter(b), seed=3),
    "flip-copy": lambda m, b: m.flipped_batches(iter(b), seed=3, copy=True),
    "random-crop-margin": lambda m, b: m.random_crop_batches(iter(b), (24, 24), seed=5),
    "random-crop-pad": lambda m, b: m.random_crop_batches(iter(b), (32, 32), pad=4, seed=5),
    "random-crop-same": lambda m, b: m.random_crop_batches(iter(b), (32, 32)),
    "center-crop": lambda m, b: m.center_crop_batches(iter(b), (24, 24)),
    "center-crop-same": lambda m, b: m.center_crop_batches(iter(b), (32, 32)),
    "normalized": lambda m, b: m.normalized_batches(iter(b), m.IMAGENET_MEAN, m.IMAGENET_STD),
    "normalized-flip": lambda m, b: m.normalized_batches(iter(b), m.CIFAR10_MEAN,
                                                         m.CIFAR10_STD, flip=True, seed=1),
}


@needs_jax
@pytest.mark.parametrize("name", list(HELPERS))
def test_batch_helpers_match_jax(name):
    ours, refs = _pair(3, (32, 32, 3))
    got = list(HELPERS[name](datasets, ours))
    want = list(HELPERS[name](jax_datasets, refs))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.x.dtype == w.x.dtype and g.x.shape == w.x.shape
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)


def test_copying_flip_leaves_the_source_alone():
    src = [Batch(x=x, y=y) for x, y in _image_batches(2, (8, 8, 3))]
    before = [b.x.copy() for b in src]
    list(datasets.flipped_batches(iter(src), seed=0, copy=True))
    for b, x in zip(src, before):
        np.testing.assert_array_equal(b.x, x)
    with pytest.raises(ValueError, match="cannot crop"):
        next(datasets.random_crop_batches(iter(src), (16, 16)))


class _ListLoader:
    """``next_raw`` over prepared raw batches, then the end (a loader that
    does not loop)."""

    def __init__(self, raws):
        self._raws = list(raws)

    def next_raw(self, copy=True):
        return self._raws.pop(0) if self._raws else None


def _raw(spec, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, spec.record_size), dtype=np.uint8)


STREAMS = {
    "token": (lambda m: m.token_spec(16), lambda m, ld, s: m.token_batches(ld, s)),
    "token-steps": (lambda m: m.token_spec(16), lambda m, ld, s: m.token_batches(ld, s, steps=2)),
    "mlm": (lambda m: m.token_spec(16),
            lambda m, ld, s: m.mlm_batches(ld, s, mask_token=257, seed=4)),
    "mlm-eval-seed": (lambda m: m.token_spec(16),
                      lambda m, ld, s: m.mlm_batches(ld, s, mask_prob=0.3, mask_token=1,
                                                     seed=10_000)),
    "detection": (lambda m: m.detection_spec(32, 4),
                  lambda m, ld, s: m.detection_batches(ld, s)),
    "detection-u8": (lambda m: m.detection_spec(32, 4),
                     lambda m, ld, s: m.detection_batches(ld, s, normalize=False)),
    "instance": (lambda m: m.instance_spec(32, 4),
                 lambda m, ld, s: m.detection_batches(ld, s, steps=2, normalize=False)),
}


def _flat(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    return [tree]


@needs_jax
@pytest.mark.parametrize("name", list(STREAMS))
def test_record_streams_match_jax(name):
    spec_fn, stream_fn = STREAMS[name]
    spec, ref_spec = spec_fn(datasets), spec_fn(jax_datasets)
    assert [(f.name, f.dtype, f.shape) for f in spec.fields] == \
        [(f.name, f.dtype, f.shape) for f in ref_spec.fields]
    raws = [_raw(spec, 5, seed) for seed in range(3)]
    got = list(stream_fn(datasets, _ListLoader(r.copy() for r in raws), spec))
    want = list(stream_fn(jax_datasets, _ListLoader(r.copy() for r in raws), ref_spec))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(_flat(g.x) + _flat(g.y), _flat(w.x) + _flat(w.y)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# --- cli convert ----------------------------------------------------------------


CLI_CASES = {
    "mnist": lambda src, out: ["convert", "--format", "mnist", "--src", str(src), "--out", out],
    "text": lambda src, out: ["convert", "--format", "text", "--src", str(src), "--out", out,
                              "--seq-len", "32", "--split", "val"],
    "imagefolder-margin": lambda src, out: ["convert", "--format", "imagefolder", "--src",
                                            str(src), "--out", out, "--size", "16",
                                            "--margin", "4"],
    "coco-masks": lambda src, out: ["convert", "--format", "coco", "--src", str(src[0]),
                                    "--annotations", str(src[1]), "--out", out, "--size", "64",
                                    "--max-boxes", "4", "--masks", "--mask-stride", "4"],
    "bad-format": lambda src, out: ["convert", "--format", "cifar10", "--src", str(src),
                                    "--out", out],
}


@needs_jax
@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_convert_matches_dlcfn_convert(tmp_path, capsys, name):
    source = {"mnist": "mnist", "text": "text", "imagefolder-margin": "imagefolder",
              "coco-masks": "coco", "bad-format": "mnist"}[name]
    src = _write_source(source, tmp_path / "src")
    outputs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = str(tmp_path / side)
        rc = main(CLI_CASES[name](src, out))
        captured = capsys.readouterr()
        failed = [ln for ln in captured.err.splitlines() if ln.startswith("CONVERT FAILED")]
        outputs[side] = (rc, captured.out.replace(out, "<out>"), failed)
    assert outputs["port"] == outputs["jax"]
    rc, stdout, stderr = outputs["port"]
    if name == "bad-format":
        assert rc == 1 and stdout == "" and len(stderr) == 1
    else:
        assert rc == 0 and json.loads(stdout)["out_dir"] == "<out>"
        for f in (tmp_path / "jax").iterdir():
            assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes(), f.name


def test_cli_convert_coco_needs_annotations(tmp_path):
    with pytest.raises(SystemExit, match="requires --annotations"):
        cli.main(["convert", "--format", "coco", "--src", str(tmp_path), "--out",
                  str(tmp_path / "o")])
