"""``parallel/p2p.py``: point-to-point through the host where gloo takes no
CUDA tensor.

Two gloo ranks on the CPU deliver the other rank's tensors (f32, bf16, a
strided int64) through ``exchange`` and ``rotate`` straight through gloo and
through the host staging (forced for CPU tensors) alike, and the staging
counts its bytes; the staging rule (a CUDA tensor on a gloo group, or any
under ``force_staging``).  One ``cuda`` test runs the two ranks on the card,
where gloo's own send refuses CUDA tensors (``tools/gloo_cuda_probe.py``).
No JAX here: the card's host has none.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch.parallel import p2p  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_P2P_RANK = """
import sys, torch, torch.distributed as dist
from deeplearning_cfn_tpu_torch.parallel import p2p
rank, port, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if device == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
def made(r):  # what rank r sends: every dtype the stages pass, one not contiguous
    return [torch.arange(1 << 16, dtype=torch.float32) + r,
            torch.full((3, 4), r, dtype=torch.bfloat16),
            (torch.arange(12, dtype=torch.int64).reshape(3, 4) * (r + 1))[:, ::2]]
sent = [t.to(device) for t in made(rank)]
want = made(1 - rank)
for mode in ("direct", "staged"):
    if mode == "direct" and device == "cuda":
        continue  # gloo's own send refuses CUDA tensors
    p2p.reset_staged_bytes()
    recv = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in sent]
    if mode == "staged" and device == "cpu":
        p2p._FORCE.set(True)
    p2p.exchange([(t, 1 - rank) for t in sent], [(r, 1 - rank) for r in recv])
    rotated = p2p.rotate(sent, None)
    for got in (recv, rotated):
        assert all(g.device.type == device and torch.equal(g.cpu(), w)
                   for g, w in zip(got, want)), (mode, got)
    n = 2 * sum(t.numel() * t.element_size() for t in sent)
    assert p2p.staged_bytes == (n if mode == "staged" else 0), (mode, p2p.staged_bytes)
dist.destroy_process_group()
"""


def _p2p_ranks(device: str) -> None:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _P2P_RANK, str(r), str(port), device],
                              cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_staged_and_direct_paths_deliver_equal_tensors():
    """Two gloo ranks on the CPU: ``exchange`` and ``rotate`` deliver the
    other rank's tensors (f32, bf16, a strided int64) straight through gloo
    and through the host staging alike; the staging counts its bytes."""
    _p2p_ranks("cpu")


def test_only_cuda_tensors_on_gloo_are_staged():
    """The staging rule on a gloo group: a CPU tensor goes straight, unless
    staging is forced."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        assert not p2p.staged(torch.zeros(2))
        with p2p.force_staging():
            assert p2p.staged(torch.zeros(2))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_staged_p2p_on_the_card_delivers_what_was_sent():
    """Two processes on ``cuda:0`` over gloo, whose own send refuses CUDA
    tensors: ``exchange`` and ``rotate`` of CUDA tensors arrive, through the
    host staging, as the other rank's tensors, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _p2p_ranks("cuda")
