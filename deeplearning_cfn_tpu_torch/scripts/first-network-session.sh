#!/usr/bin/env bash
# first-network-session.sh — the port's real-data acceptance run: the
# counterpart of scripts/first-network-session.sh, with the same stages,
# knobs and summary keys, driving deeplearning_cfn_tpu_torch (its
# `cli convert` and examples) on the card.
#
# The build environment has no egress, so the real-data acceptance
# numbers — the reference's published 92% CIFAR-10 train accuracy
# (README.md:141) and real-COCO detection (prepare-s3-bucket.sh:23-50) —
# cannot be produced in-env.  Every pipeline stage IS in place and
# format-exact under test; this script turns "pipeline in place" into
# "capability demonstrated" as a single command:
#
#   download (CIFAR-10, MNIST, COCO val2017 subset)
#     -> dlcfn convert (public layouts -> DLC1 records)
#     -> CIFAR-10 VGG-11 to --target_accuracy 0.92 with held-out eval
#        (cosine LR + pad-crop + flip: the convergence recipe; constant
#        LR + flip-only does not reliably reach the reference's number)
#     -> COCO-subset RetinaNet training + mAP@0.5 eval
#     -> ImageNet ResNet-50 to 76% top-1 (the north star) — only when
#        DLCFN_FNS_SRC holds an imagenet/ ImageFolder tree (ImageNet's
#        download is authenticated; it cannot be fetched here) and
#        "imagenet" is in DLCFN_FNS_DATASETS
#
# Usage:  scripts/first-network-session.sh [WORK_DIR]
#
# Knobs (all env, defaulted for the real run; the in-env smoke test
# shrinks them):
#   DLCFN_FNS_SRC       pre-populated source dir -> skip all downloads
#   DLCFN_FNS_DATASETS  subset of "cifar mnist coco imagenet"
#                       (default: "cifar mnist coco" — imagenet is
#                       opt-in because its source cannot be downloaded)
#   DLCFN_FNS_TARGET    CIFAR target accuracy   (default 0.92)
#   DLCFN_FNS_STEPS     max CIFAR train steps   (default 40000)
#   DLCFN_FNS_DET_STEPS COCO train steps        (default 2000)
#   DLCFN_FNS_COCO_N    COCO subset image count (default 256)
#   DLCFN_FNS_SIZE      COCO record image size  (default 512)
#   DLCFN_FNS_IN_TARGET ImageNet top-1 target   (default 0.76)
#   DLCFN_FNS_IN_STEPS  max ImageNet steps      (default 450000 = 90
#                       epochs of 1.28M images at global batch 256)
#   DLCFN_FNS_IN_BATCH  ImageNet global batch   (default 256)
#   DLCFN_FNS_IN_MARGIN train-record crop margin px (default 32:
#                       256px stored, 224px random-crop windows)
#   DLCFN_FNS_DEVICE    the examples' --device (default cuda; the tests
#                       set cpu, as the JAX script's test sets
#                       JAX_PLATFORMS=cpu)
set -euo pipefail

WORK="${1:-${DLCFN_FNS_WORK:-${TMPDIR:-/tmp}/dlcfn-first-network}}"
SRC="${DLCFN_FNS_SRC:-$WORK/src}"
DATASETS="${DLCFN_FNS_DATASETS:-cifar mnist coco}"
TARGET="${DLCFN_FNS_TARGET:-0.92}"
STEPS="${DLCFN_FNS_STEPS:-40000}"
DET_STEPS="${DLCFN_FNS_DET_STEPS:-2000}"
COCO_N="${DLCFN_FNS_COCO_N:-256}"
SIZE="${DLCFN_FNS_SIZE:-512}"
IN_TARGET="${DLCFN_FNS_IN_TARGET:-0.76}"
IN_STEPS="${DLCFN_FNS_IN_STEPS:-450000}"
IN_BATCH="${DLCFN_FNS_IN_BATCH:-256}"
IN_MARGIN="${DLCFN_FNS_IN_MARGIN:-32}"
IN_SIZE="${DLCFN_FNS_IN_SIZE:-224}"
DEVICE="${DLCFN_FNS_DEVICE:-cuda}"
PY="${PYTHON:-python3}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DLCFN="$PY -m deeplearning_cfn_tpu_torch.cli"
mkdir -p "$WORK" "$SRC" "$WORK/data" "$WORK/metrics"
SUMMARY="$WORK/summary.json"
echo "{}" > "$SUMMARY"

note() { echo ">>> $*" >&2; }
record() {  # record KEY JSON-FILE: merge a result into the summary
  $PY - "$SUMMARY" "$1" "$2" <<'EOF'
import json, sys
summary_path, key, result_path = sys.argv[1:4]
s = json.load(open(summary_path))
s[key] = json.load(open(result_path))
json.dump(s, open(summary_path, "w"), indent=2)
EOF
}

has() { case " $DATASETS " in *" $1 "*) return 0;; *) return 1;; esac; }

# ---------------------------------------------------------------- download
if [ -z "${DLCFN_FNS_SRC:-}" ]; then
  note "stage 1/3: download into $SRC"
  if has cifar && [ ! -d "$SRC/cifar/cifar-10-batches-py" ]; then
    mkdir -p "$SRC/cifar"
    curl -fL --retry 3 https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz \
      | tar xz -C "$SRC/cifar"
  fi
  if has mnist && [ ! -f "$SRC/mnist/train-images-idx3-ubyte.gz" ]; then
    mkdir -p "$SRC/mnist"
    for f in train-images-idx3-ubyte train-labels-idx1-ubyte \
             t10k-images-idx3-ubyte t10k-labels-idx1-ubyte; do
      curl -fL --retry 3 -o "$SRC/mnist/$f.gz" \
        "https://storage.googleapis.com/cvdf-datasets/mnist/$f.gz"
    done
  fi
  # Completion marker, not the annotations file: a run interrupted mid
  # image download must re-enter this block on rerun.
  if has coco && [ ! -f "$SRC/coco/.download-complete" ]; then
    mkdir -p "$SRC/coco/train" "$SRC/coco/val"
    curl -fL --retry 3 -o "$WORK/ann.zip" \
      "http://images.cocodataset.org/annotations/annotations_trainval2017.zip"
    $PY - "$WORK/ann.zip" "$SRC/coco" <<'EOF'
import sys, zipfile
zf, out = sys.argv[1:3]
with zipfile.ZipFile(zf) as z:
    with z.open("annotations/instances_val2017.json") as f, \
         open(f"{out}/instances_val2017.json", "wb") as g:
        g.write(f.read())
EOF
    # Subset: first COCO_N annotated images, 80/20 train/val dirs.
    $PY - "$SRC/coco" "$COCO_N" <<'EOF' > "$WORK/coco-files.txt"
import json, sys
root, n = sys.argv[1], int(sys.argv[2])
ann = json.load(open(f"{root}/instances_val2017.json"))
with_anns = {a["image_id"] for a in ann["annotations"]}
names = [i["file_name"] for i in ann["images"] if i["id"] in with_anns][:n]
split = max(1, int(len(names) * 0.8))
for i, name in enumerate(names):
    print(("train" if i < split else "val") + " " + name)
EOF
    while read -r split name; do
      [ -s "$SRC/coco/$split/$name" ] && continue  # resume partial runs
      curl -fL --retry 3 -o "$SRC/coco/$split/$name" \
        "http://images.cocodataset.org/val2017/$name"
    done < "$WORK/coco-files.txt"
    touch "$SRC/coco/.download-complete"
  fi
else
  note "stage 1/3: using pre-populated sources in $SRC (no downloads)"
fi

# ----------------------------------------------------------------- convert
note "stage 2/3: convert public layouts -> DLC1 records"
if has cifar; then
  $DLCFN convert --format cifar10 --src "$SRC/cifar" --out "$WORK/data/cifar" \
    > "$WORK/convert-cifar.json"
  record convert_cifar "$WORK/convert-cifar.json"
fi
if has mnist; then
  $DLCFN convert --format mnist --src "$SRC/mnist" --out "$WORK/data/mnist" \
    > "$WORK/convert-mnist.json"
  record convert_mnist "$WORK/convert-mnist.json"
fi
if has imagenet; then
  # ImageNet arrives via DLCFN_FNS_SRC only (authenticated download):
  # $SRC/imagenet/{train,val}/<class>/*.JPEG, torchvision layout.
  [ -d "$SRC/imagenet/train" ] || {
    note "imagenet requested but $SRC/imagenet/train missing"; exit 1; }
  # Train records carry a crop margin (stored 224+IN_MARGIN px) so every
  # epoch sees fresh random 224px windows; val records are exact-size
  # (the standard center-crop eval transform, baked at ingest).
  $DLCFN convert --format imagefolder --src "$SRC/imagenet/train" \
    --out "$WORK/data/imagenet" --size "$IN_SIZE" --margin "$IN_MARGIN" \
    --split train > "$WORK/convert-imagenet-train.json"
  if [ -d "$SRC/imagenet/val" ]; then
    # Same dir as train: the examples' eval reads --data_dir's val split
    # (the pipeline resolves each split's record shape independently).
    $DLCFN convert --format imagefolder --src "$SRC/imagenet/val" \
      --out "$WORK/data/imagenet" --size "$IN_SIZE" --split val \
      > "$WORK/convert-imagenet-val.json"
    record convert_imagenet_val "$WORK/convert-imagenet-val.json"
  fi
  record convert_imagenet_train "$WORK/convert-imagenet-train.json"
fi
if has coco; then
  # --masks: instance bitmaps go into the records too (the flagship is
  # MODE_MASK=True, run.sh:86).
  $DLCFN convert --format coco --src "$SRC/coco/train" \
    --annotations "$SRC/coco/instances_val2017.json" \
    --out "$WORK/data/coco" --size "$SIZE" --split train --masks \
    > "$WORK/convert-coco-train.json"
  # Val masks at stride 2: COCO mask mAP is scored at image resolution,
  # so the GT rasters backing the claimed number are high-fidelity
  # (train stays at stride 8, the prototype-loss resolution).
  $DLCFN convert --format coco --src "$SRC/coco/val" \
    --annotations "$SRC/coco/instances_val2017.json" \
    --out "$WORK/data/coco" --size "$SIZE" --split val --masks \
    --mask-stride 2 \
    > "$WORK/convert-coco-val.json"
  record convert_coco_train "$WORK/convert-coco-train.json"
  record convert_coco_val "$WORK/convert-coco-val.json"
fi

# ------------------------------------------------------------------- train
note "stage 3/3: train + evaluate"
if has cifar; then
  # The reference's published number: 92% CIFAR-10 accuracy
  # (README.md:141), here with a held-out eval as well.  The recipe is
  # the full one — cosine LR decay + pad-4 random crop + flip; constant
  # LR with flip alone does not reliably converge to 92%.
  $PY -m deeplearning_cfn_tpu_torch.examples.cifar10_train --device "$DEVICE" --model vgg11 \
    --data_dir "$WORK/data/cifar" --augment_flip --augment_crop \
    --lr_schedule cosine --warmup_steps 500 --weight_decay 5e-4 \
    --target_accuracy "$TARGET" --steps "$STEPS" --eval_steps 20 \
    --metrics_dir "$WORK/metrics" \
    ${DLCFN_FNS_BATCH:+--global_batch_size "$DLCFN_FNS_BATCH"} \
    > "$WORK/train-cifar.out"
  tail -n1 "$WORK/train-cifar.out" | $PY -c \
    'import json,sys,ast; json.dump(ast.literal_eval(sys.stdin.read()), sys.stdout)' \
    > "$WORK/train-cifar.json"
  record cifar "$WORK/train-cifar.json"
fi

if has imagenet; then
  # The north star: ResNet-50 -> 76% top-1.  The exact recipe: stepped
  # LR decay at 50/75/90% of the run (the run.sh:93 shape at the classic
  # 30/60/80-of-90-epoch milestones), 5-epoch warmup, weight decay 1e-4
  # on kernels only (norm scales/biases mask-excluded — the canonical
  # recipe does not reach 76% without it), random-crop from margin
  # records + flip, label smoothing 0.1 (in the example), batch 256 at
  # base LR 0.1.  Held-out top-1 runs every ~epoch on a fast subsample;
  # the TARGET GATE and the final claimed number eval the FULL val split.
  EPOCH_STEPS=$((1281167 / IN_BATCH))
  $PY -m deeplearning_cfn_tpu_torch.examples.resnet_imagenet --device "$DEVICE" --depth 50 \
    --data_dir "$WORK/data/imagenet" --image_size "$IN_SIZE" \
    --augment_crop --augment_flip \
    --lr_schedule step --warmup_steps $((EPOCH_STEPS * 5)) \
    --weight_decay 1e-4 \
    --learning_rate 0.1 --global_batch_size "$IN_BATCH" \
    --target_accuracy "$IN_TARGET" --steps "$IN_STEPS" \
    --eval_every "$EPOCH_STEPS" --eval_steps 64 \
    --metrics_dir "$WORK/metrics" \
    --checkpoint_dir "$WORK/ckpt/imagenet" \
    > "$WORK/train-imagenet.out"
  tail -n1 "$WORK/train-imagenet.out" | $PY -c \
    'import json,sys,ast; json.dump(ast.literal_eval(sys.stdin.read()), sys.stdout)' \
    > "$WORK/train-imagenet.json"
  record imagenet "$WORK/train-imagenet.json"
fi

if has coco; then
  # Pretrained-backbone transfer (run.sh:94 BACKBONE.WEIGHTS analog):
  # when the imagenet stage trained a ResNet-50 classifier, the detector
  # starts from its backbone instead of from scratch.
  BACKBONE_ARGS=""
  if [ -d "$WORK/ckpt/imagenet" ] && \
     [ "${DLCFN_FNS_DET_BACKBONE:-resnet50}" = "resnet50" ]; then
    BACKBONE_ARGS="--backbone_ckpt $WORK/ckpt/imagenet"
  fi
  $PY -m deeplearning_cfn_tpu_torch.examples.detection_train --device "$DEVICE" \
    --data_dir "$WORK/data/coco" --image_size "$SIZE" \
    --steps "$DET_STEPS" --eval_steps 10 --max_boxes 50 --masks \
    --metrics_dir "$WORK/metrics" $BACKBONE_ARGS \
    ${DLCFN_FNS_DET_BATCH:+--global_batch_size "$DLCFN_FNS_DET_BATCH"} \
    ${DLCFN_FNS_DET_BACKBONE:+--backbone "$DLCFN_FNS_DET_BACKBONE"} \
    > "$WORK/train-coco.out"
  tail -n1 "$WORK/train-coco.out" | $PY -c \
    'import json,sys,ast; json.dump(ast.literal_eval(sys.stdin.read()), sys.stdout)' \
    > "$WORK/train-coco.json"
  record coco "$WORK/train-coco.json"
fi

note "done; summary:"
cat "$SUMMARY"
