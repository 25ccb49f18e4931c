"""Multi-process smoke — counterpart of
``deeplearning_cfn_tpu/examples/multiprocess_smoke.py``.

N processes join one process group from the cluster contract's env
(``DEEPLEARNING_WORKERS_COUNT``, ``DLCFN_PROCESS_ID``,
``DEEPLEARNING_COORDINATOR``; ``examples.common.maybe_init_distributed``).
In the ``lenet`` mode (the default) they build one data-parallel mesh over
every rank and train LeNet synchronously: each rank takes its slice of the
same global batch and the gradient's all-reduce crosses the process
boundary.  In the ``llama-fsdp`` mode (``DLCFN_SMOKE_MODEL=llama-fsdp``)
they train the tiny Llama over ``fsdp × tp=2`` (N even; one device a
process, so the tp pairs are neighbouring ranks and the fsdp axis spans the
others): the parameter all-gathers and gradient reduce-scatters of FSDP2
and the tp collectives cross the process boundary, on one fixed batch
repeated, so the loss must fall.  Every process prints the same (global)
loss sequence, or the run is broken.

Run (per worker): ``DEEPLEARNING_WORKERS_COUNT=2 DLCFN_PROCESS_ID=<i>
DEEPLEARNING_COORDINATOR=127.0.0.1:9911 python -m
deeplearning_cfn_tpu_torch.examples.multiprocess_smoke --device cpu``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv: list[str] | None = None) -> dict:
    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.examples.common import default_mesh, maybe_init_distributed
    from deeplearning_cfn_tpu_torch.models.lenet import LeNet
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import Batch, SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    steps = int(os.environ.get("DLCFN_SMOKE_STEPS", "10"))
    model_kind = os.environ.get("DLCFN_SMOKE_MODEL", "lenet")
    if model_kind not in ("lenet", "llama-fsdp"):
        raise SystemExit(f"unknown DLCFN_SMOKE_MODEL={model_kind!r} (lenet or llama-fsdp)")
    torch.set_num_threads(1)
    pid = maybe_init_distributed(args.device)
    if not dist.is_initialized():
        raise SystemExit("multiprocess_smoke runs as many processes: set "
                         "DEEPLEARNING_WORKERS_COUNT > 1 and DEEPLEARNING_COORDINATOR")
    try:
        n_proc = dist.get_world_size()
        if model_kind == "llama-fsdp":
            if n_proc % 2:
                raise SystemExit("DLCFN_SMOKE_MODEL=llama-fsdp needs an even number of "
                                 "processes: tp pairs, the fsdp axis across them")
            spec = MeshSpec(fsdp=n_proc // 2, tp=2)
            cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=16)
            trainer = llama.make_trainer(
                cfg, TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=1e-2),
                device=args.device, mesh=build_mesh(spec))
            batch = 2 * spec.fsdp
            # One fixed batch, repeated: the loss must fall in a few steps.
            tokens = np.random.default_rng(7).integers(1, cfg.vocab_size, size=(batch, 16))
            one = Batch(x=tokens.astype(np.int32), y=np.roll(tokens, -1, 1).astype(np.int32))
            batches = [one] * steps
        else:
            spec = MeshSpec.data_parallel(n_proc)
            trainer = Trainer(lambda g: LeNet(num_classes=10, generator=g),
                              TrainerConfig(learning_rate=0.02, matmul_precision="float32"),
                              device=args.device, mesh=default_mesh("dp"))
            batch = 8 * n_proc
            ds = SyntheticDataset(shape=(28, 28, 1), num_classes=10, batch_size=batch)
            batches = ds.batches(steps)
        state = trainer.init(seed=0)
        losses = []
        for b in batches:
            x = torch.from_numpy(b.x).to(trainer.device)
            y = torch.from_numpy(b.y).to(trainer.device)
            state, metrics = trainer.train_step(state, x, y)
            losses.append(round(float(metrics["loss"]), 6))
    finally:
        dist.destroy_process_group()
    result = {"process_id": pid, "processes": n_proc, "model": model_kind,
              "mesh": spec.axis_sizes(), "losses": losses}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
