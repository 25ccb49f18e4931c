"""Which collectives a gloo group takes on CUDA tensors, whether a trainer
step over a one-rank NCCL mesh captures as a CUDA graph, and what a one-rank
NCCL collective leaves in a CUDA graph.

Two processes on ``cuda:0`` join a gloo group for each collective the port's
multi-rank paths use (the dp step's and the bucketed sync's all-reduce, the int8
exchange's ``all_to_all_single`` and ``all_gather_into_tensor``, the sharded
bucket's ``reduce_scatter_tensor``, the tp and sp gathers' list ``all_gather``,
GPipe's ``send``/``recv``, ring attention's ``batch_isend_irecv``), one pair a
collective so that a refusal cannot take the others down; each pair's result
is one JSON row.  Then, in a process of its own each, a small Llama
(m435's widths at 2 layers, seq 256) over ``build_mesh(MeshSpec(fsdp=1))``
(FSDP2) on a one-rank NCCL group: ``multi_step_fn(4)`` against four eager
steps, and the same over ``MeshSpec(dp=1)`` with the dp step and with the bucketed
sync in f32 and int8 (``comms_overlap``, whose one-rank gate, JAX's, is
lifted for the probe: the engine is the same at any rank count).  Last, the
collectives of the port's syncs (all-reduce in place, ``all_to_all_single``,
``all_gather_into_tensor``, broadcast) on a one-rank NCCL group, captured in
a CUDA graph and replayed under ``torch.profiler``: the device activity each
left (NCCL returns early on one rank where it has nothing to move).

Run on a host with one card: ``python -m deeplearning_cfn_tpu_torch.tools.gloo_cuda_probe``
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import traceback

OPS = ("all_reduce", "all_reduce_bf16", "broadcast", "all_gather_into_tensor_int8",
       "all_gather_into_tensor_f32", "all_gather", "all_gather_bf16", "all_to_all_single_int8",
       "all_to_all_single_f32", "reduce_scatter_tensor", "send_recv", "batch_isend_irecv")


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
    elif op.startswith("all_gather"):  # the list form (tensor_parallel._all_gather)
        src = t.to(torch.bfloat16) if op.endswith("bf16") else t
        parts = [torch.empty_like(src) for _ in range(2)]
        dist.all_gather(parts, src)
        out = torch.cat(parts)
    elif op.startswith("all_to_all_single"):
        src = q if op.endswith("int8") else t
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
    elif op == "reduce_scatter_tensor":
        out = t.new_empty(4)
        dist.reduce_scatter_tensor(out, t)
    elif op == "batch_isend_irecv":  # ring attention's exchange
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, 1 - rank), dist.P2POp(dist.irecv, out, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    else:  # send_recv
        out = t if rank == 0 else torch.empty_like(t)
        dist.send(t, 1) if rank == 0 else dist.recv(out, 0)
    torch.cuda.synchronize()
    print(json.dumps({"op": op, "rank": rank, "out": out.float().cpu().tolist()}))
    dist.destroy_process_group()


_BUCKETS = dict(strategy="dp", comms_overlap=True, overlap_bucket_bytes=32 << 20)
CAPTURES = {  # name: (mesh axis, trainer overrides)
    "fsdp": ("fsdp", dict(strategy="fsdp")),
    "dp": ("dp", dict(strategy="dp")),
    "overlap": ("dp", _BUCKETS),
    "overlap_int8": ("dp", dict(_BUCKETS, overlap_compress=True)),
}


def _capture(name: str) -> None:
    import dataclasses
    from unittest import mock

    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import overlap
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
    axis, overrides = CAPTURES[name]
    row = {"probe": "capture", "strategy": name}
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=256), n_layers=2)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
            **overrides), device="cuda",
            mesh=build_mesh(MeshSpec(**{axis: 1})))
        one = next(SyntheticTokenDataset(seq_len=256, vocab_size=cfg.vocab_size,
                                         batch_size=4).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * 4), 4)), torch.device("cuda"))
        with mock.patch.object(overlap, "check_sync", lambda *a, **k: None):
            state, eager = trainer.init(seed=0), []
            for i in range(4):
                state, m = trainer.train_step(state, xs[i], ys[i])
                eager.append(m["loss"].item())
            final = [p.detach().clone() for p in state.model.parameters()]
            state = trainer.init(seed=0)
        kfn = trainer.multi_step_fn(4)
        state, captured = kfn(state, xs, ys)
        row.update(captured=kfn.captures == 1, losses_equal=captured.tolist() == eager,
                   params_equal=all(torch.equal(p, q)
                                    for p, q in zip(state.model.parameters(), final)))
    except Exception as e:  # the probe's answer: what the capture raised
        row.update(captured=False, error=repr(e)[:300], where=traceback.format_exc()[-1200:])
    dist.destroy_process_group()
    print(json.dumps(row))


def _nccl_one_rank() -> None:
    """Each collective of the syncs on a one-rank NCCL group, captured and
    replayed under the profiler: the device activity (kernels, copies) of
    one replay, by name."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    x = torch.ones(1 << 20, device="cuda")
    q = torch.ones(1 << 20, device="cuda", dtype=torch.int8)
    ops = {
        "all_reduce_in_place": lambda: dist.all_reduce(x),
        "all_reduce_async_wait": lambda: dist.all_reduce(x, async_op=True).wait(),
        "all_to_all_single_int8": lambda: dist.all_to_all_single(torch.empty_like(q), q),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(torch.empty_like(x), x),
        "broadcast": lambda: dist.broadcast(x, src=0),
    }
    for name, op in ops.items():
        row = {"probe": "nccl_one_rank", "op": name}
        try:
            op()  # the communicator, eagerly
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                op()
            graph.replay()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            row["replay"] = {e.key[:100]: e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA}
        except Exception as e:
            row["error"] = repr(e)[:300]
        print(json.dumps(row), flush=True)
    dist.destroy_process_group()


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
    for name in CAPTURES:
        res = subprocess.run(me + ["capture", name], capture_output=True, text=True,
                             timeout=600)
        print(res.stdout.strip().splitlines()[-1] if res.stdout.strip()
              else json.dumps({"probe": "capture", "strategy": name, "rc": res.returncode,
                               "error": res.stderr[-600:]}), flush=True)
    res = subprocess.run(me + ["nccl_one_rank"], capture_output=True, text=True, timeout=300)
    print(res.stdout.strip() or json.dumps({"probe": "nccl_one_rank", "rc": res.returncode,
                                            "error": res.stderr[-600:]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "gloo":
        _gloo_op(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif len(sys.argv) > 1 and sys.argv[1] == "capture":
        _capture(sys.argv[2])
    elif len(sys.argv) > 1 and sys.argv[1] == "nccl_one_rank":
        _nccl_one_rank()
    else:
        sys.exit(main())
