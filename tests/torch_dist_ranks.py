"""One rank of the port's multi-rank CPU checks (``test_torch_distributed.py``).

Run as a process of the cluster contract's env (``DEEPLEARNING_WORKERS_COUNT``,
``DLCFN_PROCESS_ID``, ``DEEPLEARNING_COORDINATOR``): it joins a gloo group
through ``examples.common.maybe_init_distributed``, then for each case of the
pickled input file builds the case's mesh, loads the JAX package's initial
weights (numpy, computed by the test), takes the global norm of the first
batch's gradients, runs the case's trainer steps, and writes what it saw to
``<input>.rank<id>``.  It imports no JAX.

    python tests/torch_dist_ranks.py <input.pkl>
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, axis_rank, build_mesh  # noqa: E402
from deeplearning_cfn_tpu_torch.train import trainer as trainer_lib  # noqa: E402


def _full(p: torch.Tensor) -> torch.Tensor:
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def run_case(case: dict) -> dict:
    mesh = build_mesh(MeshSpec(**case["mesh"]))
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **case["cfg"])
    weights = interop.llama_params_from_jax(cfg, case["init"])

    def model_fn(generator):
        model = llama.Llama(cfg, generator)
        model.load_state_dict(weights)
        return model

    t = trainer_lib.Trainer(model_fn, trainer_lib.TrainerConfig(**case["trainer"]),
                            loss_fn=llama.causal_lm_loss, device="cpu", mesh=mesh,
                            param_specs=llama.param_specs(cfg))
    state = t.init(seed=0)
    x0, y0 = (torch.from_numpy(a) for a in case["batches"][0])
    loss, _ = llama.causal_lm_loss(state.runner or state.model, t._local_batch(x0),
                                   t._local_batch(y0))
    loss.backward()
    t._sync_replicated_grads()  # as the step does before its clip
    norm = trainer_lib.clip_by_global_norm(state.model.parameters(), float("inf"),
                                           t._split_groups)
    state.optimizer.zero_grad(set_to_none=True)
    losses, aux = [], []
    for x, y in case["batches"]:
        state, metrics = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(metrics["loss"]))
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
    sharded = {n: [pl.dim for pl in p.placements if pl.is_shard()]
               for n, p in state.model.named_parameters() if hasattr(p, "placements")}
    params = {n: _full(p).detach().numpy().copy() for n, p in state.model.named_parameters()}
    return {"losses": losses, "aux": aux, "norm": float(norm), "params": params,
            "ep_rank": axis_rank(mesh, "ep"), "sharded": sharded,
            "ddp": state.runner is not None}


def main() -> None:
    torch.set_num_threads(1)
    path = Path(sys.argv[1])
    cases = pickle.loads(path.read_bytes())
    pid = maybe_init_distributed("cpu")
    try:
        out = {name: run_case(case) for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    Path(f"{path}.rank{pid}").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    if int(os.environ.get("DEEPLEARNING_WORKERS_COUNT", "1")) < 2:
        raise SystemExit("run as one of several processes (the cluster contract's env)")
    main()
