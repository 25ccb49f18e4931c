"""Command line of the port — counterpart of ``deeplearning_cfn_tpu/cli.py``.

Run as ``python -m deeplearning_cfn_tpu_torch.cli <command>``.  Ported so
far: ``serve`` and ``convert``, the counterparts of ``dlcfn serve`` and
``dlcfn convert``.  The JAX package's other commands come with the later
slices that port what they drive.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_BROKER_SLICE = "a later slice of the PyTorch port (the cluster plane)"


def cmd_serve(args) -> int:
    """Run the serving plane under deterministic synthetic traffic and print
    the load report.

    ``--replicas`` continuous-batching engines behind a least-loaded
    front-end, driven by seeded Poisson traffic on a virtual clock: the
    smoke of the whole plane (admission, paging, continuous batching,
    metrics) on a toy model, as ``dlcfn serve`` runs it.  ``--disaggregate``
    prefills on a device of its own where there are two CUDA devices or
    more.  ``--journal`` (or ``$DLCFN_FLIGHT_JOURNAL``) records the
    ``serve_load`` and per-replica ``serve_metrics`` events."""
    import torch

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.device import resolve_device
    from deeplearning_cfn_tpu_torch.models.llama import LlamaConfig, init_model
    from deeplearning_cfn_tpu_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeFrontEnd,
        ServeReplica,
        TrafficConfig,
        plan_placement,
        run_load,
    )

    if args.serve_broker:
        raise NotImplementedError(
            f"--broker (registration and liveness at a broker) is ported in {_BROKER_SLICE}"
        )
    if args.journal:
        os.environ["DLCFN_FLIGHT_JOURNAL"] = args.journal
    device = resolve_device(args.device)
    # The demo model: the flagship transformer at toy scale, as dlcfn serve's.
    cfg = LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    model = init_model(cfg, seed=0, device=device)
    scfg = ServeConfig(num_slots=args.slots, block_size=4, blocks_per_slot=8, prefill_len=16)
    placement = None
    if args.disaggregate:
        placement = plan_placement(None if device.type == "cuda" else [device])
    clock = VirtualClock()
    replicas = [
        ServeReplica(
            ContinuousBatchingEngine(model, scfg, clock=clock, name=f"rep{i}",
                                     placement=placement),
            f"rep{i}",
            group=args.group,
        )
        for i in range(args.replicas)
    ]
    frontend = ServeFrontEnd(replicas)
    traffic = TrafficConfig(requests=args.requests, seed=args.seed)
    report = run_load(frontend, traffic, clock, journal=True)
    for replica in frontend.replicas.values():
        replica.engine.journal_metrics()
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.completed == traffic.requests else 1


def cmd_convert(args) -> int:
    """Convert a public dataset in its standard on-disk layout into DLC1
    record files (``train/datasets.py``) and print the converter's summary as
    JSON.  The output directory is what the examples' ``--data_dir`` reads.
    A source in the wrong format prints ``CONVERT FAILED`` and returns 1."""
    from deeplearning_cfn_tpu_torch.train import datasets

    try:
        if args.format == "text":
            out = datasets.convert_text(args.src, args.out, seq_len=args.seq_len,
                                        tokenizer_dir=args.tokenizer, split=args.split)
        elif args.format == "imagefolder":
            out = datasets.convert_imagefolder(args.src, args.out, size=args.size,
                                               split=args.split, margin=args.margin)
        elif args.format == "coco":
            if not args.annotations:
                raise SystemExit("--format coco requires --annotations")
            out = datasets.convert_coco(args.src, args.annotations, args.out, size=args.size,
                                        max_boxes=args.max_boxes, split=args.split,
                                        masks=args.masks_coco, mask_stride=args.mask_stride)
        else:
            out = datasets.CONVERTERS[args.format](args.src, args.out)
    except datasets.DatasetFormatError as e:
        print(f"CONVERT FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deeplearning_cfn_tpu_torch.cli",
        description="the PyTorch/CUDA port of deeplearning_cfn_tpu",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    pv = sub.add_parser(
        "serve", help="continuous-batching inference replicas under synthetic traffic"
    )
    pv.add_argument("--requests", type=int, default=200, help="synthetic requests to serve")
    pv.add_argument("--seed", type=int, default=0,
                    help="traffic seed; the run is deterministic per seed")
    pv.add_argument("--replicas", type=int, default=1, help="engines behind the front-end")
    pv.add_argument("--slots", type=int, default=4, help="decode slots per replica")
    pv.add_argument("--group", default="serve",
                    help="worker-group name for registration/liveness")
    pv.add_argument("--broker", default=None, dest="serve_broker", metavar="HOST:PORT",
                    help="register replicas and beat liveness at this broker (not ported yet)")
    pv.add_argument("--disaggregate", action="store_true",
                    help="prefill on a dedicated device when >= 2 devices")
    pv.add_argument("--journal", default=None,
                    help="flight journal path for serve_metrics events")
    pv.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs only when asked for")
    pv.set_defaults(fn=cmd_serve)
    pc = sub.add_parser("convert", help="dataset -> DLC1 records")
    pc.add_argument("--format", required=True,
                    choices=["cifar10", "mnist", "imagefolder", "coco", "text"])
    pc.add_argument("--src", required=True, help="dataset source dir")
    pc.add_argument("--out", required=True, help="output dir for .dlc files")
    pc.add_argument("--size", type=int, default=224,
                    help="image size for imagefolder/coco records")
    pc.add_argument("--margin", type=int, default=0,
                    help="imagefolder: extra pixels stored per side so training can "
                         "random-crop --size windows (train splits e.g. --margin 32; eval 0)")
    pc.add_argument("--split", default="train",
                    help="output split name for imagefolder/coco/text")
    pc.add_argument("--annotations", default=None, help="COCO instances_*.json path")
    pc.add_argument("--max-boxes", type=int, default=50, dest="max_boxes")
    pc.add_argument("--mask-stride", type=int, default=8, dest="mask_stride",
                    help="instance-mask raster stride for --format coco --masks: 8 (the "
                         "prototype training resolution) for train splits, 1 or 2 for val "
                         "splits scored at image resolution")
    pc.add_argument("--masks", action="store_true", dest="masks_coco",
                    help="coco: also rasterize instance-mask bitmaps into the records (for "
                         "detection_train --masks)")
    pc.add_argument("--seq-len", type=int, default=2048, dest="seq_len",
                    help="token window length for --format text")
    pc.add_argument("--tokenizer", default=None,
                    help="local HF tokenizer dir for --format text (default: byte-level)")
    pc.set_defaults(fn=cmd_convert)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
