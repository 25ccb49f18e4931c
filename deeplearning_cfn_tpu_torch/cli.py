"""Command line of the port — counterpart of ``deeplearning_cfn_tpu/cli.py``.

Run as ``python -m deeplearning_cfn_tpu_torch.cli <command>``.  Ported so
far: ``serve``, ``convert``, ``events``, ``status`` (its mesh, reshard and
span sections) and ``chaos`` (the ``slice-loss-live`` scenario), the
counterparts of the ``dlcfn`` commands of those names.  The JAX package's
other commands, and the other sections of ``status``, come with the later
slices that port what they drive.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_BROKER_SLICE = "a later slice of the PyTorch port (the broker client and service)"
_OBS_SLICE = "a later slice of the PyTorch port (obs/: liveness, profiler folds, aggregator)"


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


def _status_spans(args) -> dict | None:
    """Span aggregates folded from a flight journal, or None; each span
    with p50/p95/p99 over the journal's most recent samples."""
    if not args.journal:
        return None
    from deeplearning_cfn_tpu_torch.obs.profiler import RollingQuantiles
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal
    from deeplearning_cfn_tpu_torch.obs.tracing import SpanStats

    stats: dict[str, SpanStats] = {}
    quantiles: dict[str, RollingQuantiles] = {}
    for event in read_journal(args.journal, kind="span"):
        name = event.get("span")
        seconds = event.get("seconds")
        if not isinstance(name, str) or not isinstance(seconds, (int, float)):
            continue
        agg = stats.setdefault(name, SpanStats())
        agg.fold(float(seconds), bool(event.get("ok", True)))
        quantiles.setdefault(name, RollingQuantiles()).add(float(seconds))
    out = {}
    for name, agg in sorted(stats.items()):
        row = agg.as_dict()
        for key, value in quantiles[name].quantiles().items():
            row[f"{key}_s"] = round(value, 6)
        out[name] = row
    return out


def _status_reshard(args) -> dict | None:
    """Live-reshard counters folded from journaled ``reshard`` /
    ``reshard_fallback`` events, or None (no journal / no reshards)."""
    if not args.journal:
        return None
    from deeplearning_cfn_tpu_torch.obs.exporter import fold_reshard_events
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal

    return fold_reshard_events(read_journal(args.journal)) or None


def _status_mesh(args) -> dict | None:
    """The current mesh shape straight from the published cluster
    contract (slices/workers/chips and the degraded flag) — after a live
    reshard the surviving topology shows up here."""
    if not args.cluster:
        return None
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    try:
        contract = ClusterContract.read()
    except (OSError, TypeError, ValueError, KeyError):
        return None
    if contract.cluster_name != args.cluster:
        return None
    return {
        "cluster": contract.cluster_name,
        "slices": contract.slices_count,
        "workers": contract.workers_count,
        "chips_total": contract.total_chips,
        "degraded": contract.degraded,
        "slice_groups": {
            g: len(ips) for g, ips in (contract.slices or {}).items()
        },
    }


def cmd_status(args) -> int:
    """Cluster status: the mesh from the published cluster contract
    (``--cluster``), the live-reshard counters and span aggregates from a
    flight journal (``--journal``); ``--format prom`` renders them as
    Prometheus text.  The JAX command's liveness and broker sections (read
    from a broker) are not ported: with ``--cluster`` only the mesh shows;
    the flags of the other sections raise, naming their slice."""
    for flag, what, where in (("metrics_dir", "--metrics-dir", _OBS_SLICE),
                              ("status_broker", "--broker", _BROKER_SLICE),
                              ("profile", "--profile", _OBS_SLICE),
                              ("serve", "--serve", _OBS_SLICE),
                              ("fleet", "--fleet", _BROKER_SLICE)):
        if getattr(args, flag):
            raise NotImplementedError(f"status {what} is ported in {where}")
    if not (args.cluster or args.journal):
        raise SystemExit("status needs a source: --cluster and/or --journal")
    spans = _status_spans(args)
    reshard = _status_reshard(args)
    mesh = _status_mesh(args)
    if args.format == "prom":
        from deeplearning_cfn_tpu_torch.obs.exporter import render_prometheus

        print(render_prometheus(None, spans, cluster=args.cluster or "", reshard=reshard,
                                mesh=mesh), end="")
        return 0
    out: dict = {}
    if mesh is not None:
        out["mesh"] = mesh
    if reshard is not None:
        out["reshard"] = reshard
    if spans is not None:
        out["spans"] = spans
    print(json.dumps(out, indent=2))
    return 0


def cmd_events(args) -> int:
    """Tail the flight journal: the last N structured events, as JSONL.
    ``--follow`` prints everything already journaled (``-n`` is ignored),
    then polls for appends across the recorder's ``<path>.1`` rotation —
    ``tail -F`` for the journal; Ctrl-C exits cleanly."""
    from deeplearning_cfn_tpu_torch.obs.recorder import ENV_JOURNAL, follow_journal, read_journal

    path = args.journal or os.environ.get(ENV_JOURNAL)
    if not path:
        raise SystemExit(
            f"events needs --journal (or ${ENV_JOURNAL}) pointing at a flight journal"
        )
    if args.follow:
        try:
            for event in follow_journal(path, kind=args.kind, poll_s=args.poll):
                print(json.dumps(event, allow_nan=False, default=str), flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    if not Path(path).exists() and not Path(path + ".1").exists():
        print(f"no journal at {path}", file=sys.stderr)
        return 1
    count = 0
    for event in read_journal(path, limit=args.last, kind=args.kind):
        print(json.dumps(event, allow_nan=False, default=str))
        count += 1
    if count == 0:
        print("journal is empty (no matching events)", file=sys.stderr)
    return 0


def cmd_chaos(args) -> int:
    """Run named fault-injection scenarios (``chaos/scenarios.py``): each
    drives real components through seeded faults and checks its recovery
    invariants; the report is deterministic per (scenario, seed).  One
    scenario prints one report dict, ``--all`` a list.  Exit 1 if any
    invariant was violated, 2 on a bad name."""
    from deeplearning_cfn_tpu_torch.chaos import SCENARIO_FAULTS, SCENARIOS, run_scenario

    if args.list_scenarios:
        width = max(len(name) for name in SCENARIOS)
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().split("\n")[0]
            faults = ", ".join(SCENARIO_FAULTS.get(name, ())) or "-"
            print(f"{name:<{width}}  {doc}")
            print(f"{'':<{width}}  faults: {faults}")
        return 0
    names = sorted(SCENARIOS) if args.all else [args.scenario]
    if names == [None]:
        print("chaos: pass --scenario NAME, --all, or --list")
        return 2
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"chaos: unknown scenario(s) {unknown}; available: {sorted(SCENARIOS)}")
        return 2
    reports = [run_scenario(name, args.seed, args.device) for name in names]
    payload = [r.to_dict() for r in reports]
    print(json.dumps(payload[0] if len(payload) == 1 else payload, indent=2))
    return 0 if all(r.passed for r in reports) else 1


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
    ps = sub.add_parser("status", help="the mesh, live-reshard counters and span aggregates")
    ps.add_argument("--cluster", default=None,
                    help="cluster name: the mesh from its published contract ($DLCFN_ROOT)")
    ps.add_argument("--journal", default=None,
                    help="flight journal (JSONL) to fold reshard counters and spans from")
    ps.add_argument("--format", choices=["json", "prom"], default="json",
                    help="prom = Prometheus text exposition")
    ps.add_argument("--metrics-dir", dest="metrics_dir", default=None,
                    help="per-worker training metrics (not ported yet)")
    ps.add_argument("--broker", default=None, dest="status_broker", metavar="HOST:PORT",
                    help="liveness from a broker (not ported yet)")
    ps.add_argument("--profile", action="store_true", help="step profiles (not ported yet)")
    ps.add_argument("--serve", action="store_true", help="serving snapshots (not ported yet)")
    ps.add_argument("--fleet", action="store_true", help="fleet telemetry (not ported yet)")
    ps.set_defaults(fn=cmd_status)
    pe = sub.add_parser("events", help="tail the obs flight journal")
    pe.add_argument("--journal", default=None,
                    help="journal path (default: $DLCFN_FLIGHT_JOURNAL)")
    pe.add_argument("-n", "--last", type=int, default=50, dest="last",
                    help="how many trailing events to print")
    pe.add_argument("--kind", default=None,
                    help="only events of this kind (e.g. span, reshard)")
    pe.add_argument("--follow", action="store_true",
                    help="live mode: print existing events then poll for appends, across "
                         "journal rotation (tail -F)")
    pe.add_argument("--poll", type=float, default=0.5, metavar="S",
                    help="--follow poll interval in seconds")
    pe.set_defaults(fn=cmd_events)
    px = sub.add_parser("chaos", help="run seeded fault-injection scenarios (resilience soak)")
    px.add_argument("--scenario", default=None,
                    help="scenario name (see --list): slice-loss-live")
    px.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed; reports are deterministic per (scenario, seed)")
    px.add_argument("--all", action="store_true", help="run every scenario in the catalog")
    px.add_argument("--list", action="store_true", dest="list_scenarios",
                    help="list scenarios and exit")
    px.add_argument("--device", default="cuda",
                    help="where the scenario's trainers run: cuda (default) or cpu")
    px.set_defaults(fn=cmd_chaos)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
