"""Does a live CUDA graph that holds NCCL collectives stop a group from being
destroyed?

Two processes, one card each, join an NCCL group, capture an all-reduce in
a CUDA graph and replay it.  Then, by mode, rank 0 captures a graph of its
own that holds no collective (``global`` or ``thread_local`` capture mode,
4,000 elementwise ops) or nothing (``none``); both ranks pass a barrier and
an all-reduce, and call ``destroy_process_group``: with the NCCL graph still
alive, or, in the ``*_dropped`` modes, after dropping it.  Each rank prints
its progress; a rank still running after ``STALL_S`` seconds writes its
threads' stacks and exits 1.  One JSON row a mode: each rank's exit code,
its last progress line, and the function its stack was in.

Needs two cards: ``python -m deeplearning_cfn_tpu_torch.tools.nccl_graph_probe [MODE ...]``
"""

from __future__ import annotations

import json
import re
import socket
import subprocess
import sys
import time

MODES = ("none", "global", "thread_local", "none_dropped")
STALL_S = 35
TIMEOUT_S = 60


def _rank(mode: str, rank: int, port: int) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(STALL_S, exit=True)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    t = torch.ones(1, device=dev)
    u = torch.ones(1024, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dist.all_reduce(u)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        dist.all_reduce(u)
    graph.replay()
    torch.cuda.synchronize()
    print("nccl graph replayed", flush=True)
    capture = mode.removesuffix("_dropped")
    if rank == 0 and capture != "none":
        x = torch.ones(1 << 16, device=dev)
        y = x * 2
        torch.cuda.synchronize()
        own = torch.cuda.CUDAGraph()
        with torch.cuda.graph(own, capture_error_mode=capture):
            for _ in range(4000):
                y = y * 1.0001 + x
        own.replay()
        torch.cuda.synchronize()
        print(f"captured ({capture})", flush=True)
    dist.barrier(device_ids=[rank])
    print("after barrier", flush=True)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("after all_reduce", flush=True)
    if mode.endswith("_dropped"):
        del graph
        print("graph dropped", flush=True)
    dist.destroy_process_group()
    print("destroyed", flush=True)


def _row(mode: str) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "deeplearning_cfn_tpu_torch.tools."
                               "nccl_graph_probe", "--rank", mode, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    ranks = []
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate(timeout=30)[0] + "\nkilled"
        progress = [line for line in out.splitlines() if re.match(r"^[a-z]", line)]
        stuck = re.findall(r'line \d+ in (\w+)', out)
        ranks.append({"rank": r, "rc": p.returncode, "last": progress[-1] if progress else None,
                      "stuck_in": stuck[0] if stuck else None})
    return {"mode": mode, "ranks": ranks, "seconds": time.perf_counter() - t0,
            "destroyed": all(r["last"] == "destroyed" for r in ranks)}


def main(argv: list[str]) -> int:
    for mode in argv or MODES:
        print(json.dumps(_row(mode)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        _rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(main(sys.argv[1:]))
