"""The port's examples trained from records against the JAX package's
examples on the same records, on the CPU.

Each case converts one source (written here from a seed) with the port's
converter, runs the JAX example's ``main`` and then the port's on the same
``--data_dir`` for one step, and holds the losses to each other.  Both read
the records through their own binding to ``native/dataloader`` with the same
arguments, so they see the same batches (the examples' first batch is the
model's sample, the step trains on the second).  The port's model starts
from the JAX example's initial weights (captured from its ``Trainer.init``,
carried by ``interop``).  Everything is f32 (``--no-bf16``; Llama's tiny
config is pinned to f32 on both sides), and the tolerances are those of the
trainer parity tests of each model: losses to 1e-5 relative (the JAX side
runs over the conftest's eight CPU devices, so it sums in another order).

- ``llama_train --size tiny`` and ``bert_pretrain --tiny`` on byte-level
  text records, with ``--eval_steps`` on a val split (held-out perplexity;
  BERT's fixed eval masks);
- ``resnet_imagenet`` at a small depth on records stored with an 8-pixel
  margin (cut to the input size in the step) and a val split scored whole
  (``--full_eval``, its last batch partial), the port's run under
  ``--profile``;
- ``cifar10_train`` with ``--eval_data_dir --full_eval``;
- ``detection_train --masks`` on COCO records with masks.
"""

import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.examples import bert_pretrain as jax_bert_pretrain
    from deeplearning_cfn_tpu.examples import cifar10_train as jax_cifar10_train
    from deeplearning_cfn_tpu.examples import detection_train as jax_detection_train
    from deeplearning_cfn_tpu.examples import llama_train as jax_llama_train
    from deeplearning_cfn_tpu.examples import resnet_imagenet as jax_resnet_imagenet
    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.models import resnet as jax_resnet
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:  # the card's host: these tests need the JAX reference
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples import (  # noqa: E402
    bert_pretrain,
    cifar10_train,
    detection_train,
    llama_train,
    resnet_imagenet,
)
from deeplearning_cfn_tpu_torch.models import bert, llama  # noqa: E402
from deeplearning_cfn_tpu_torch.train import datasets  # noqa: E402
from deeplearning_cfn_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

RTOL = 1e-5


@pytest.fixture()
def carry(monkeypatch):
    """``carry(to_state_dict)``: the JAX trainer's initial variables are
    captured as it builds them; the port's trainer loads
    ``to_state_dict(variables, model)`` into the model it builds."""
    captured = {}
    jax_init = JaxTrainer.init

    def capture(self, *args, **kwargs):
        state = jax_init(self, *args, **kwargs)
        captured["variables"] = jax.device_get({"params": state.params, **state.model_state})
        return state

    monkeypatch.setattr(JaxTrainer, "init", capture)

    def arm(to_state_dict):
        port_init = Trainer.init

        def load(self, seed=0):
            state = port_init(self, seed)
            state.model.load_state_dict(to_state_dict(captured["variables"], state.model),
                                        strict=True)
            return state

        monkeypatch.setattr(Trainer, "init", load)

    return arm


def _text(root, name: str, words: str, repeat: int):
    root.mkdir(parents=True, exist_ok=True)
    (root / name).write_text(words * repeat)
    return root


def _losses(result) -> list:
    return [h["loss"] for h in result["history"]] or [result["final_loss"]]


def test_llama_train_from_text_records_matches_jax(tmp_path, carry, monkeypatch):
    src = _text(tmp_path / "corpus", "a.txt", "the quick brown fox jumps. ", 200)
    val = _text(tmp_path / "valsrc", "b.txt", "over the lazy dog! ", 120)
    datasets.convert_text(src, tmp_path / "dlc", seq_len=32)
    datasets.convert_text(val, tmp_path / "dlc", seq_len=32, split="val")
    for cls, dtype in ((jax_llama.LlamaConfig, jnp.float32), (llama.LlamaConfig, torch.float32)):
        tiny = cls.__dict__["tiny"].__func__
        monkeypatch.setattr(cls, "tiny", classmethod(
            lambda c, *a, _t=tiny, _d=dtype, **kw: _t(c, *a, dtype=_d, **kw)))
    argv = ["--size", "tiny", "--seq_len", "32", "--steps", "1", "--global_batch_size", "8",
            "--log_every", "1", "--eval_steps", "2", "--data_dir", str(tmp_path / "dlc")]
    want = jax_llama_train.main(argv)
    carry(lambda v, model: interop.llama_params_from_jax(model.cfg, v["params"]))
    got = llama_train.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    assert got["eval"]["split"] == want["eval"]["split"] == "heldout"
    assert got["eval"]["examples"] == want["eval"]["examples"] == 16
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=RTOL)


def test_bert_pretrain_from_text_records_matches_jax(tmp_path, carry):
    src = _text(tmp_path / "corpus", "a.txt", "lorem ipsum dolor ", 200)
    val = _text(tmp_path / "valsrc", "b.txt", "sit amet consectetur ", 80)
    datasets.convert_text(src, tmp_path / "dlc", seq_len=32)
    datasets.convert_text(val, tmp_path / "dlc", seq_len=32, split="val")
    argv = ["--tiny", "--seq_len", "32", "--vocab_size", "512", "--steps", "1",
            "--global_batch_size", "8", "--log_every", "1", "--eval_steps", "2",
            "--data_dir", str(tmp_path / "dlc")]
    want = jax_bert_pretrain.main(argv)
    tcfg = bert.BertConfig.tiny(seq_len=32, vocab_size=512)
    carry(lambda v, model: interop.bert_params_from_jax(tcfg, v["params"]))
    got = bert_pretrain.main(argv + ["--device", "cpu"])
    assert got["mask_token"] == 257  # the first id past the byte-level vocabulary
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    assert got["eval"]["split"] == want["eval"]["split"] == "heldout"
    for key in ("loss", "masked_accuracy"):
        np.testing.assert_allclose(got["eval"][key], want["eval"][key], rtol=RTOL)


def _imagefolder(root, n: int, size: int, seed: int):
    """``n`` images a class over four classes, each class its own colour
    (a learnable task), written as PNG."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(4):
        d = root / f"class{c}"
        d.mkdir(parents=True, exist_ok=True)
        base = rng.integers(0, 256, 3)
        for i in range(n):
            img = np.clip(base + rng.normal(0, 30, (size, size + 6, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{i}.png")
    return root


def test_resnet_imagenet_from_margin_records_matches_jax(tmp_path, carry, monkeypatch):
    datasets.convert_imagefolder(_imagefolder(tmp_path / "train", 8, 44, 0), tmp_path / "dlc",
                                 size=32, margin=8)
    datasets.convert_imagefolder(_imagefolder(tmp_path / "val", 6, 36, 1), tmp_path / "dlc",
                                 size=32, split="val")
    monkeypatch.setitem(jax_resnet_imagenet.DEPTHS, 50,
                        functools.partial(jax_resnet.ResNet, stage_sizes=(1, 1)))
    monkeypatch.setitem(resnet_imagenet.DEPTHS, 50, (1, 1))
    argv = ["--depth", "50", "--image_size", "32", "--global_batch_size", "16", "--steps", "1",
            "--no-bf16", "--log_every", "1", "--eval_steps", "1", "--learning_rate", "0.01",
            "--data_dir", str(tmp_path / "dlc")]
    want = jax_resnet_imagenet.main(argv)
    carry(lambda v, model: interop.resnet_params_from_jax(v["params"], v["batch_stats"]))
    got = resnet_imagenet.main(argv + ["--device", "cpu", "--profile"])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    # --profile: the steps' phases (the prefetcher's copies fold into h2d too).
    assert got["profile"]["steps"] == 1 and got["profile"]["phases"]["h2d"]["count"] == 2
    assert got["pipeline"]["batches"] == 1
    # The whole val split: 24 records, batches of 16 and 8.
    assert got["eval"]["split"] == want["eval"]["split"] == "heldout-full"
    assert got["eval"]["examples"] == want["eval"]["examples"] == 24
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=RTOL)


def _cifar(root, n_per_batch: int, seed: int):
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name in ("data_batch_1", "data_batch_2", "test_batch"):
        labels = rng.integers(0, 10, n_per_batch)
        images = (labels[:, None] * 20 + rng.integers(0, 60, (n_per_batch, 3072))).astype(np.uint8)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": images, b"labels": labels.tolist()}, f)
    return root


def test_cifar10_train_from_records_with_held_out_dir_matches_jax(tmp_path, carry):
    """lr 0.005, not the example's 0.05: on these records one step at 0.05
    moves conv7's weights by gradients large enough that f32 rounding leaves
    them 6.5e-4 apart (the train losses agree to 1e-7), which the eval loss,
    at 16, carries as 7e-4.  At 0.005 the parameters are 6.5e-5 apart and
    the eval losses 3e-6."""
    datasets.convert_cifar10(_cifar(tmp_path / "src", 24, 0), tmp_path / "dlc")
    datasets.convert_cifar10(_cifar(tmp_path / "src2", 40, 1), tmp_path / "heldout")
    (tmp_path / "heldout" / "train.dlc").unlink()
    argv = ["--global_batch_size", "16", "--steps", "1", "--no-bf16", "--log_every", "1",
            "--learning_rate", "0.005", "--eval_steps", "1", "--data_dir", str(tmp_path / "dlc"),
            "--eval_data_dir", str(tmp_path / "heldout"), "--full_eval"]
    want = jax_cifar10_train.main(argv)
    carry(lambda v, model: interop.vgg_params_from_jax(v["params"], v["batch_stats"]))
    got = cifar10_train.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    assert got["eval"]["split"] == want["eval"]["split"] == "heldout-full"
    assert got["eval"]["examples"] == want["eval"]["examples"] == 40
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=RTOL)


def _coco(root, n_images: int, seed: int):
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    images, annotations = [], []
    for i in range(n_images):
        h, w = int(rng.integers(48, 80)), int(rng.integers(48, 80))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
        images.append({"id": i, "file_name": f"{i}.png", "height": h, "width": w})
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(12, w // 2)), int(rng.integers(12, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            annotations.append({
                "id": len(annotations) + 1, "image_id": i, "iscrowd": 0,
                "category_id": int(rng.choice([1, 3, 7])), "bbox": [x0, y0, bw, bh],
                "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]})
    ann = root / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations,
                               "categories": [{"id": c} for c in (1, 3, 7)]}))
    return img_dir, ann


def test_detection_train_masks_from_records_matches_jax(tmp_path, carry):
    img_dir, ann = _coco(tmp_path / "coco", 16, 0)
    datasets.convert_coco(img_dir, ann, tmp_path / "dlc", size=64, max_boxes=5, masks=True)
    argv = ["--backbone", "tiny", "--image_size", "64", "--num_classes", "3", "--max_boxes",
            "5", "--masks", "--global_batch_size", "8", "--steps", "1", "--no-bf16",
            "--log_every", "1", "--data_dir", str(tmp_path / "dlc")]
    want = jax_detection_train.main(argv)
    carry(lambda v, model: interop.retinanet_params_from_jax(v["params"], v["batch_stats"]))
    got = detection_train.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)


def test_detection_eval_reads_a_finer_val_split(tmp_path):
    """``--eval_steps`` scores mAP on the val records, whose masks may be
    rasterised finer than training's (the stride follows from the record
    size); train records at a finer stride are refused."""
    img_dir, ann = _coco(tmp_path / "coco", 8, 0)
    datasets.convert_coco(img_dir, ann, tmp_path / "dlc", size=64, max_boxes=5, masks=True)
    datasets.convert_coco(img_dir, ann, tmp_path / "dlc", size=64, max_boxes=5, masks=True,
                          mask_stride=2, split="val")
    argv = ["--device", "cpu", "--backbone", "tiny", "--image_size", "64", "--num_classes", "3",
            "--max_boxes", "5", "--masks", "--global_batch_size", "4", "--steps", "1",
            "--eval_steps", "1", "--data_dir", str(tmp_path / "dlc")]
    ev = detection_train.main(argv)["eval"]
    assert 0.0 <= ev["mAP"] <= 1.0 and 0.0 <= ev["mask_mAP"] <= 1.0
    assert 0.0 <= ev["mask_mAP_stride"] <= 1.0
    datasets.convert_coco(img_dir, ann, tmp_path / "fine", size=64, max_boxes=5, masks=True,
                          mask_stride=2)
    with pytest.raises(SystemExit, match="mask stride 2"):
        detection_train.main(argv[:-1] + [str(tmp_path / "fine")])


def test_detection_without_data_dir_is_synthetic():
    """``evaluate_map`` callers that build their own ``args`` (no
    ``data_dir``) keep the synthetic held-out stream."""
    import argparse

    assert detection_train.record_batches(argparse.Namespace(masks=True), 2) is None
    assert detection_train.record_batches(argparse.Namespace(data_dir=None), 2) is None


def test_detection_records_converted_without_masks_are_named(tmp_path):
    img_dir, ann = _coco(tmp_path / "coco", 4, 0)
    datasets.convert_coco(img_dir, ann, tmp_path / "dlc", size=64, max_boxes=5)
    with pytest.raises(SystemExit, match="opposite --masks"):
        detection_train.main(["--device", "cpu", "--backbone", "tiny", "--image_size", "64",
                              "--max_boxes", "5", "--masks", "--steps", "1",
                              "--data_dir", str(tmp_path / "dlc")])


def test_token_records_are_held_to_the_model_and_seq_len(tmp_path):
    datasets.convert_text(_text(tmp_path / "corpus", "a.txt", "x" * 100, 40), tmp_path / "dlc",
                          seq_len=32)
    base = ["--device", "cpu", "--steps", "1", "--global_batch_size", "2",
            "--data_dir", str(tmp_path / "dlc")]
    with pytest.raises(SystemExit, match="pass --seq_len 32"):
        llama_train.main(base + ["--size", "tiny", "--seq_len", "16"])
    # BERT reserves the mask id past the data vocabulary: 257 + 1 > 256.
    with pytest.raises(SystemExit, match="needs >= 257 \\+ 1 reserved"):
        bert_pretrain.main(base + ["--tiny", "--seq_len", "32"])


def test_a_resumed_record_run_continues_the_stream(tmp_path, monkeypatch):
    """``--checkpoint_dir``: the loader of a resumed run starts at the
    checkpoint's step (``start_batch``), as the straight run's stream does."""
    from deeplearning_cfn_tpu_torch.train import native_loader

    datasets.convert_text(_text(tmp_path / "corpus", "a.txt", "abcdefgh ", 300),
                          tmp_path / "dlc", seq_len=16)
    starts = []
    orig = native_loader.NativeRecordLoader.__post_init__

    def record(self):
        starts.append(self.start_batch)
        orig(self)

    monkeypatch.setattr(native_loader.NativeRecordLoader, "__post_init__", record)
    argv = ["--device", "cpu", "--size", "tiny", "--seq_len", "16", "--global_batch_size", "2",
            "--steps", "2", "--data_dir", str(tmp_path / "dlc"),
            "--checkpoint_dir", str(tmp_path / "ckpt")]
    first = llama_train.main(argv)
    second = llama_train.main(argv)
    assert (first["end_step"], second["start_step"], second["end_step"]) == (2, 2, 4)
    assert starts == [0, 2]


def test_examples_keep_the_synthetic_stream_without_data_dir():
    """Without ``--data_dir`` the examples run as before (the sample draws a
    fresh synthetic stream, so training still starts at its first batch)."""
    out = llama_train.main(["--device", "cpu", "--size", "tiny", "--seq_len", "16",
                            "--global_batch_size", "2", "--steps", "1"])
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
    assert "mask_token" not in bert_pretrain.main(["--device", "cpu", "--tiny", "--seq_len",
                                                   "16", "--global_batch_size", "2",
                                                   "--steps", "1"])


def _args(data_dir, **kw):
    fields = {"data_dir": str(data_dir), "global_batch_size": 4, "augment_flip": False,
              "augment_crop": False, "crop_pad": 4, **kw}
    return dataclasses.make_dataclass("Args", list(fields))(**fields)


def test_image_records_are_told_apart_by_header_and_layout(tmp_path):
    """float32 records, uint8 at the input size and uint8 with a margin, by
    the file header and the layout sidecar; a margin with no sidecar is
    never guessed from the size (the loader refuses it)."""
    from deeplearning_cfn_tpu_torch.examples.common import (
        device_image_pipeline,
        image_batches,
        image_pipeline,
    )
    from deeplearning_cfn_tpu_torch.train.records import RecordSpec, write_records

    shape = (8, 8, 3)
    rng = np.random.default_rng(0)
    for name, spec in (("f32", RecordSpec.classification(shape)),
                       ("u8", RecordSpec.classification(shape, "uint8")),
                       ("margin", RecordSpec.classification((12, 12, 3), "uint8"))):
        x = (rng.random((6, *spec.fields[0].shape)) * 255).astype(spec.fields[0].dtype)
        write_records(tmp_path / name / "train.dlc", spec,
                      [spec.encode(x=x[i], y=np.int32(i)) for i in range(6)])
    batches, stats, augment = device_image_pipeline(_args(tmp_path / "f32"), shape, None)
    b = next(iter(batches(1)))
    assert stats is None and augment is None and b.x.dtype == np.float32
    batches, stats, augment = device_image_pipeline(_args(tmp_path / "u8"), shape, None)
    assert next(iter(batches(1))).x.dtype == np.uint8 and augment is None
    assert stats == (tuple(datasets.CIFAR10_MEAN.tolist()), tuple(datasets.CIFAR10_STD.tolist()))
    # The guess from the image shape (no stats.json), and the host-normalised form.
    host = next(iter(image_batches(_args(tmp_path / "u8"), shape, None)(1)))
    assert host.x.dtype == np.float32 and host.x.shape == (4, 8, 8, 3)
    from deeplearning_cfn_tpu_torch.train.native_loader import LoaderError

    with pytest.raises(LoaderError, match="record_size"):
        device_image_pipeline(_args(tmp_path / "margin"), shape, None)
    datasets.write_layout_sidecar(tmp_path / "margin", "train", 12, 3)
    batches, stats, augment = device_image_pipeline(_args(tmp_path / "margin"), shape, None)
    assert next(iter(batches(1))).x.shape == (4, 12, 12, 3)
    assert augment.crop == (8, 8) and not augment.random_crop  # the centre, on the card
    # Eval: the centre on the host, nothing on the card, the partial batch kept.
    batches, _, augment = device_image_pipeline(_args(tmp_path / "margin"), shape, None,
                                                eval_mode=True)
    got = list(batches(None))
    assert augment is None and [len(b.x) for b in got] == [4, 2]
    assert got[0].x.shape[1:3] == (8, 8)
    # The host pipeline: a random window with --augment_crop, flips copied.
    batches, _ = image_pipeline(_args(tmp_path / "margin", augment_crop=True,
                                      augment_flip=True), shape, None)
    assert next(iter(batches(1))).x.shape == (4, 8, 8, 3)


def test_resnet_margin_sample_is_at_the_stored_size(tmp_path):
    """Margin records reach the step at the stored size; the device augment
    cuts the input size (the MFU numerator counts that size)."""
    from deeplearning_cfn_tpu_torch.examples.common import device_image_pipeline

    datasets.convert_imagefolder(_imagefolder(tmp_path / "train", 2, 44, 0), tmp_path / "dlc",
                                 size=32, margin=8)
    args = _args(tmp_path / "dlc", augment_flip=True, augment_crop=True)
    batches, stats, augment = device_image_pipeline(args, (32, 32, 3), None)
    b = next(iter(batches(1)))
    assert b.x.shape[1:3] == (40, 40) and b.x.dtype == np.uint8
    assert augment.crop == (32, 32) and augment.random_crop and augment.flip
    assert stats == (tuple(datasets.IMAGENET_MEAN.tolist()), tuple(datasets.IMAGENET_STD.tolist()))
