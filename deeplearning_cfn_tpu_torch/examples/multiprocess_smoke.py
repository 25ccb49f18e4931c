"""Multi-process data-parallel smoke — counterpart of
``deeplearning_cfn_tpu/examples/multiprocess_smoke.py`` (its ``lenet`` mode).

N processes join one process group from the cluster contract's env
(``DEEPLEARNING_WORKERS_COUNT``, ``DLCFN_PROCESS_ID``,
``DEEPLEARNING_COORDINATOR``; ``examples.common.maybe_init_distributed``),
build one data-parallel mesh over every rank, and train LeNet synchronously:
each rank takes its slice of the same global batch and the gradient's
all-reduce crosses the process boundary.  Every process prints the same
(global) loss sequence, or the run is broken.

``DLCFN_SMOKE_MODEL=llama-fsdp`` (fsdp × tp across the processes) needs the
tp axis and raises, naming slice 5b.

Run (per worker): ``DEEPLEARNING_WORKERS_COUNT=2 DLCFN_PROCESS_ID=<i>
DEEPLEARNING_COORDINATOR=127.0.0.1:9911 python -m
deeplearning_cfn_tpu_torch.examples.multiprocess_smoke --device cpu``
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv: list[str] | None = None) -> dict:
    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.examples.common import default_mesh, maybe_init_distributed
    from deeplearning_cfn_tpu_torch.models.lenet import LeNet
    from deeplearning_cfn_tpu_torch.parallel.mesh import SLICE_5B
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    steps = int(os.environ.get("DLCFN_SMOKE_STEPS", "10"))
    model_kind = os.environ.get("DLCFN_SMOKE_MODEL", "lenet")
    if model_kind != "lenet":
        raise NotImplementedError(f"DLCFN_SMOKE_MODEL={model_kind} (fsdp x tp) is ported in "
                                  f"{SLICE_5B}")
    torch.set_num_threads(1)
    pid = maybe_init_distributed(args.device)
    if not dist.is_initialized():
        raise SystemExit("multiprocess_smoke runs as many processes: set "
                         "DEEPLEARNING_WORKERS_COUNT > 1 and DEEPLEARNING_COORDINATOR")
    try:
        n_proc = dist.get_world_size()
        mesh = default_mesh("dp")
        trainer = Trainer(lambda g: LeNet(num_classes=10, generator=g),
                          TrainerConfig(learning_rate=0.02, matmul_precision="float32"),
                          device=args.device, mesh=mesh)
        batch = 8 * n_proc
        ds = SyntheticDataset(shape=(28, 28, 1), num_classes=10, batch_size=batch)
        state = trainer.init(seed=0)
        losses = []
        for b in ds.batches(steps):
            x = torch.from_numpy(b.x).to(trainer.device)
            y = torch.from_numpy(b.y).to(trainer.device)
            state, metrics = trainer.train_step(state, x, y)
            losses.append(round(float(metrics["loss"]), 6))
    finally:
        dist.destroy_process_group()
    result = {"process_id": pid, "processes": n_proc, "model": model_kind, "losses": losses}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
