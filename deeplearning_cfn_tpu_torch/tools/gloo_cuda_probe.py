"""Which collectives a gloo group takes on CUDA tensors, and whether a
trainer step over a one-rank NCCL mesh captures as a CUDA graph.

Two processes on ``cuda:0`` join a gloo group for each collective the port's
multi-rank paths use (DDP's and the bucketed sync's all-reduce, the int8
exchange's ``all_to_all_single`` and ``all_gather_into_tensor``, the sharded
bucket's ``reduce_scatter_tensor``, GPipe's ``send``/``recv``), one pair a
collective so that a refusal cannot take the others down; each pair's result
is one JSON row.  Then, in a process of its own each, a small Llama
(m435's widths at 2 layers, seq 256) over ``build_mesh(MeshSpec(fsdp=1))``
(FSDP2) on a one-rank NCCL group: ``multi_step_fn(4)`` against four eager
steps; over ``MeshSpec(dp=1)`` (DDP, which the trainer refuses to capture)
one step captured by hand: the error the capture raised.

Run on a host with one card: ``python -m deeplearning_cfn_tpu_torch.tools.gloo_cuda_probe``
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import traceback

OPS = ("all_reduce", "all_reduce_bf16", "broadcast", "all_gather_into_tensor_int8",
       "all_gather_into_tensor_f32", "all_to_all_single_int8", "reduce_scatter_tensor",
       "send_recv")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_op(op: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    t = torch.arange(8, device="cuda", dtype=torch.float32) + rank * 100
    q = (torch.arange(8, device="cuda") + rank * 10).to(torch.int8)
    if op == "all_reduce":
        dist.all_reduce(t)
        out = t
    elif op == "all_reduce_bf16":
        out = t.to(torch.bfloat16)
        dist.all_reduce(out)
    elif op == "broadcast":
        dist.broadcast(t, src=0)
        out = t
    elif op.startswith("all_gather_into_tensor"):
        src = q if op.endswith("int8") else t
        out = src.new_empty(16)
        dist.all_gather_into_tensor(out, src)
    elif op == "all_to_all_single_int8":
        out = torch.empty_like(q)
        dist.all_to_all_single(out, q)
    elif op == "reduce_scatter_tensor":
        out = t.new_empty(4)
        dist.reduce_scatter_tensor(out, t)
    else:  # send_recv
        out = t if rank == 0 else torch.empty_like(t)
        dist.send(t, 1) if rank == 0 else dist.recv(out, 0)
    torch.cuda.synchronize()
    print(json.dumps({"op": op, "rank": rank, "out": out.float().cpu().tolist()}))
    dist.destroy_process_group()


def _capture(strategy: str) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    row = {"probe": "capture", "strategy": strategy}
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=256), n_layers=2)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy=strategy, optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0), device="cuda", mesh=build_mesh(MeshSpec(**{strategy: 1})))
        one = next(SyntheticTokenDataset(seq_len=256, vocab_size=cfg.vocab_size,
                                         batch_size=4).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * 4), 4)), torch.device("cuda"))
        state, eager = trainer.init(seed=0), []
        for i in range(4):
            state, m = trainer.train_step(state, xs[i], ys[i])
            eager.append(m["loss"].item())
        final = [p.detach().clone() for p in state.model.parameters()]
        state = trainer.init(seed=0)
        if strategy == "dp":
            # The trainer refuses to capture DDP; capture one step by hand,
            # after an eager one on a side stream, to see what DDP does.
            lr = torch.full((), 3e-4, device="cuda")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                trainer._update(state, xs[0], ys[0], lr)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                trainer._update(state, xs[0], ys[0], lr)
            row.update(captured=True)
        else:
            state, captured = trainer.multi_step_fn(4)(state, xs, ys)
            row.update(captured=True, losses_equal=captured.tolist() == eager,
                       params_equal=all(torch.equal(p, q)
                                        for p, q in zip(state.model.parameters(), final)))
    except Exception as e:  # the probe's answer: what the capture raised
        row.update(captured=False, error=repr(e)[:300], where=traceback.format_exc()[-1200:])
    dist.destroy_process_group()
    print(json.dumps(row))


def main() -> int:
    me = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.tools.gloo_cuda_probe"]
    pairs = {}
    for op in OPS:
        port = str(_free_port())
        pairs[op] = [subprocess.Popen(me + ["gloo", op, str(r), port], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True) for r in range(2)]
    for op, procs in pairs.items():
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append({"rc": p.returncode, "out": out.strip()[-300:],
                         "error": (err.strip().splitlines() or [""])[-1][-300:]
                         if p.returncode else None})
        print(json.dumps({"probe": "gloo_cuda", "op": op,
                          "takes_cuda": all(o["rc"] == 0 for o in outs), "ranks": outs}),
              flush=True)
    for strategy in ("fsdp", "dp"):
        res = subprocess.run(me + ["capture", strategy], capture_output=True, text=True,
                             timeout=600)
        print(res.stdout.strip().splitlines()[-1] if res.stdout.strip()
              else json.dumps({"probe": "capture", "strategy": strategy, "rc": res.returncode,
                               "error": res.stderr[-600:]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "gloo":
        _gloo_op(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif len(sys.argv) > 1 and sys.argv[1] == "capture":
        _capture(sys.argv[2])
    else:
        sys.exit(main())
