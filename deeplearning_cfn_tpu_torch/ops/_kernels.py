"""Build, load and launch the port's CUDA kernels.

Each kernel is a ``.cu`` file under ``ops/csrc/`` with a plain ``extern "C"``
launcher; the headers beside them (``*.cuh``, such as ``hopper.cuh``) hold
what several kernels share.  At first use a source is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/torch_kernels/`` (named by
a hash of the source, every header and the flags, so an edited source or
header is rebuilt) and loaded with ``ctypes``.
Nothing here runs at import time: the CPU tests import this module on hosts
with no ``nvcc`` and no card.

Every pointer and the stream cross into C as ``ctypes.c_void_p``: a bare
Python int would be passed as a 32-bit int and cut the pointer.

Each wrapper counts its launches in ``launch_counts``, incremented only
where the kernel is launched, so a run can show that its path went through
the kernel: under the kernel's name, and under ``"<name>/<variant>"`` for the
variant the C launcher reports it launched (for example
``"fused_dense/wgmma_tma_pingpong_128x128"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in the build log
)

_KERNELS = ("flash_attention_fwd", "fused_dense", "fused_dense_quantized")
launch_counts: dict[str, int] = dict.fromkeys(_KERNELS, 0)

# Codes of each launcher's variant enum (`enum Variant`; `enum QuantVariant`
# for the int8-weight launcher).  bf16xP: P bf16 products a k-step, of the
# parts an f32 operand is split into (the int8 kernel's bf16x1 / bf16x3 for a
# bf16 or an f32 x; bf16x6 for the f32 dense, both operands in three parts).
_VARIANTS = {
    "flash_attention_fwd": {0: "simt", 1: "wgmma_tma"},
    "fused_dense": {0: "simt", 1: "mma_sync", 2: "wgmma_tma_128x192",
                    3: "wgmma_tma_pingpong_128x128", 4: "wgmma_tma_bf16x6_128x192",
                    5: "wgmma_tma_bf16x6_splitk_128x192"},
    "fused_dense_quantized": {0: "simt", 1: "wgmma_tma_bf16x1_128x192",
                              2: "wgmma_tma_bf16x3_128x192"},
}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()
    launch_counts.update(dict.fromkeys(_KERNELS, 0))


def _count_launch(name: str, variant: ctypes.c_int) -> None:
    launch_counts[name] += 1
    key = f"{name}/{_VARIANTS[name][variant.value]}"
    launch_counts[key] = launch_counts.get(key, 0) + 1


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source, of
    every header under ``csrc/`` (any of them may be included) and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source and
    these flags exists.  The compiler's output goes to ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)  # the launcher writes the variant it launched
# Launchers of each source and their argument types.
_SIGNATURES: dict[str, dict[str, list]] = {
    "flash_attn_fwd": {
        "flash_attn_fwd": [_P] * 5 + [_I] * 6 + [_LL] * 12 + [ctypes.c_float, _I, _I, _P, _PI],
    },
    "fused_dense": {
        "fused_dense": [_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I, _I, _P, _PI],
        "fused_dense_quantized": [_P] * 5 + [_I] * 3 + [_LL] * 2 + [_I, _I, _P, _PI],
    },
}


def _load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``, with every launcher's
    argument types declared."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


_FLASH_HEAD_DIMS = (64, 128)


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What ``csrc/flash_attn_fwd.cu`` takes, checked before anything is
    built or launched: one dtype (bf16: the wgmma/TMA kernel, f32: the scalar
    one), ``[B, S, H, D]`` with D 64 or 128, non-empty, unit stride on the
    head dim; for bf16 TMA's rule, 16-byte-aligned bases and strides a
    multiple of 8 elements; q, k and v on one CUDA device."""
    tensors = (q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash_attn_fwd takes bf16 or f32 q/k/v of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.ndim != 4 for t in tensors):
        raise ValueError("flash_attn_fwd takes [B, S, H, D] tensors")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if D not in _FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernel takes {_FLASH_HEAD_DIMS}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError("flash_attn_fwd takes non-empty batch and sequences")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attn_fwd needs unit stride on the head dim")
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in tensors
    ):
        raise ValueError("bf16 rows must start on 16-byte boundaries (strides a multiple of 8)")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attn_fwd takes q, k, v on one CUDA device")


def flash_attn_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attn_fwd.cu``: ``(out [B,Sq,Hq,D], lse [B,Hq,Sq] f32)``.

    Takes CUDA tensors of one dtype (bf16 through the wgmma/TMA path, f32
    through the scalar path), head dim 64 or 128, unit stride on the head
    dim; any other strides are read as given (see :func:`_check_flash`)."""
    _check_flash(q, k, v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _load("flash_attn_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), int(bool(causal)), int(q.dtype == torch.bfloat16), stream,
            ctypes.byref(variant),
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    _count_launch("flash_attention_fwd", variant)
    return out, lse


_ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2}


def _check_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, name: str) -> tuple[int, int, int]:
    """Device, rank, shape and stride checks shared by the two dense
    launchers; returns (M, N, K)."""
    tensors = (x, w, b)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{name} takes its tensors on one CUDA device")
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(f"{name} takes x[M,K], w[K,N], b[N]; got "
                         f"{tuple(x.shape)}/{tuple(w.shape)}/{tuple(b.shape)}")
    M, K = x.shape
    if w.shape[0] != K or b.shape[0] != w.shape[1]:
        raise ValueError(f"{name}: shape mismatch x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"b {tuple(b.shape)}")
    N = w.shape[1]
    if M == 0 or N == 0:
        raise ValueError(f"{name} takes non-empty M and N")
    if x.stride(-1) != 1 or w.stride(-1) != 1 or b.stride(0) != 1:
        raise ValueError(f"{name} needs unit stride on the last axis")
    return M, N, K


def _activation_code(activation: str | None) -> int:
    if activation not in _ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    return _ACTIVATION_CODES[activation]


def fused_dense(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, activation: str | None
) -> torch.Tensor:
    """Launch ``csrc/fused_dense.cu``: ``act(x @ w + b)`` as ``[M, N]`` in x's
    dtype.  x, w and b are CUDA tensors of one dtype, bf16 or f32; any row
    strides, unit stride on the last axis.

    bf16 runs on the tensor cores.  f32 runs there too where TMA can read the
    rows (16-byte-aligned bases and row strides, N a multiple of 4): both
    operands split exactly into three bf16 parts, six products of parts
    (f32-accurate), K split across a thread-block cluster where the output
    tiles would leave the card's SMs idle (:func:`fused_dense_f32_splits`).
    Elsewhere f32 runs on CUDA cores.  The launcher picks by dtype, shape and
    alignment and reports its choice, counted under ``"fused_dense/<variant>"``."""
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"fused_dense takes bf16 or f32 x/w/b of one dtype, got "
                        f"{[t.dtype for t in (x, w, b)]}")
    M, N, K = _check_dense(x, w, b, "fused_dense")
    act = _activation_code(activation)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _load("fused_dense")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        err = lib.fused_dense(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            x.stride(0), w.stride(0), act, int(x.dtype == torch.bfloat16), stream,
            ctypes.byref(variant),
        )
    if err != 0:
        raise RuntimeError(f"fused_dense launch failed with CUDA error {err}")
    _count_launch("fused_dense", variant)
    return out


def fused_dense_f32_splits(M: int, N: int, K: int) -> int:
    """How many CTAs of a cluster the f32 fused dense splits K over for an
    ``[M, K] x [K, N]`` product with rows TMA can read, on the current card
    (1: no split, the ``wgmma_tma_bf16x6_128x192`` variant); the launcher's
    own rule, for the record."""
    lib = _load("fused_dense")
    fn = lib.fused_dense_f32_splits
    fn.argtypes, fn.restype = [_I, _I, _I], ctypes.c_int
    return int(fn(M, N, K))


def fused_dense_quantized(
    x: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    b: torch.Tensor,
    *,
    activation: str | None,
) -> torch.Tensor:
    """Launch the int8-weight kernel of ``csrc/fused_dense.cu``:
    ``act(f32(x) @ (f32(wq) * scale) + b)`` as ``[M, N]`` in x's dtype.  x and
    b bf16 or f32 of one dtype, ``wq [K, N]`` int8, ``scale [N]`` f32; any
    row strides, unit stride on the last axis.

    Where TMA can read the rows (16-byte-aligned bases and row strides, N a
    multiple of 16) the product runs on the bf16 tensor cores: wq widened to
    bf16 in shared memory (exact), a bf16 x in one product, an f32 x split
    into three bf16 parts and three products (f32-accurate), the scale
    applied after the sum.  Elsewhere it runs on CUDA cores in f32.  The
    launcher picks by shape and alignment and reports its choice, which is
    counted under ``"fused_dense_quantized/<variant>"``."""
    if x.dtype not in (torch.bfloat16, torch.float32) or b.dtype != x.dtype:
        raise TypeError(f"fused_dense_quantized takes bf16 or f32 x and b of one dtype, got "
                        f"{x.dtype}/{b.dtype}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"fused_dense_quantized takes int8 wq and f32 scale, got "
                        f"{wq.dtype}/{scale.dtype}")
    M, N, K = _check_dense(x, wq, b, "fused_dense_quantized")
    if scale.shape != (N,) or scale.device != x.device or scale.stride(0) != 1:
        raise ValueError(f"scale must be a contiguous [{N}] tensor on {x.device}")
    act = _activation_code(activation)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _load("fused_dense")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        err = lib.fused_dense_quantized(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, N, K, x.stride(0), wq.stride(0), act, int(x.dtype == torch.bfloat16), stream,
            ctypes.byref(variant),
        )
    if err != 0:
        raise RuntimeError(f"fused_dense_quantized launch failed with CUDA error {err}")
    _count_launch("fused_dense_quantized", variant)
    return out
