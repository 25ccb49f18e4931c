"""The f32 fused dense's and the int8-weight fused dense's errors against a
float64 reference, beside f32 ``addmm``'s, and the f32 dense's error split by
term.

Run from the repository root on a host with one CUDA card:

    python3 -m deeplearning_cfn_tpu_torch.tools.dense_f64_error

For each shape, one JSON line: the largest absolute error against
``x.double() @ w.double() + b`` (no activation, so the sum alone is held)
of

- ``kernel``: the CUDA kernel (``_kernels.fused_dense``);
- ``addmm``: f32 ``torch.addmm`` with TF32 off, cuBLAS's f32 sum;
- ``six_f64``: the six kept products of the three-part splits summed in
  float64, so the error of the three dropped products alone;
- ``six_f32``: the same six products, each an f32 matmul (cuBLAS, TF32 off)
  summed in f32 in the kernel's order, so dropped products plus an f32 sum;

with the ratio of the kernel's error to ``addmm``'s.  Then, for the
int8-weight kernel with an f32 x (``_kernels.fused_dense_quantized``), the
same against ``x.double() @ (wq.double() * scale) + b``, beside f32 ``addmm``
on the dequantised weight (``quant_kernel``, ``quant_addmm``).
"""

from __future__ import annotations

import json
import sys

import torch

SHAPES = {  # name: (M, K, N)
    "resnet_head": (128, 2048, 1000),
    "mlp_in-f32": (4096, 768, 3072),
    "k256": (1024, 256, 1024),
    "k3072": (1024, 3072, 1024),
}
# The int8-weight kernel with an f32 x: BERT-base's mlp_in, and K 200 with a
# ragged last K chunk.
QUANT_SHAPES = {"quant_mlp_in-f32": (4096, 768, 3072), "quant_k200": (1000, 200, 304)}
# (x part, w part) by index into (h, m, l), the kernel's order.
F32_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _truncate_bf16(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) & -65536).view(torch.float32)


def _split3(a: torch.Tensor) -> list[torch.Tensor]:
    h = _truncate_bf16(a)
    m = _truncate_bf16(a - h)
    return [h, m, a - h - m]


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_f64_error: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (M, K, N) in SHAPES.items():
        x = torch.randn(M, K, device="cuda", generator=gen)
        w = torch.randn(K, N, device="cuda", generator=gen) / K**0.5
        b = 0.1 * torch.randn(N, device="cuda", generator=gen)
        exact = x.double() @ w.double() + b.double()
        _kernels.reset_launch_counts()
        kernel = _kernels.fused_dense(x, w, b, activation=None)
        variant = [k for k in _kernels.launch_counts if k.startswith("fused_dense/")]
        addmm = torch.addmm(b, x, w)
        xs, ws = _split3(x), _split3(w)
        six64 = sum(xs[i].double() @ ws[j].double() for i, j in F32_PAIRS) + b.double()
        six32 = None
        for i, j in F32_PAIRS:
            p = xs[i] @ ws[j]
            six32 = p if six32 is None else six32 + p
        six32 = six32 + b
        torch.cuda.synchronize()
        errs = {name: (t.double() - exact).abs().max().item()
                for name, t in (("kernel", kernel), ("addmm", addmm), ("six_f64", six64),
                                ("six_f32", six32))}
        print(json.dumps({"shape": label, "M": M, "K": K, "N": N, "variant": variant,
                          "max_abs_err": errs, "kernel_over_addmm": errs["kernel"] / errs["addmm"],
                          "exact_max_abs": exact.abs().max().item()}), flush=True)
    for label, (M, K, N) in QUANT_SHAPES.items():
        x = torch.randn(M, K, device="cuda", generator=gen)
        w = torch.randn(K, N, device="cuda", generator=gen) / K**0.5
        b = 0.1 * torch.randn(N, device="cuda", generator=gen)
        wq, scale = quantize_weight(w)
        exact = x.double() @ (wq.double() * scale.double()) + b.double()
        _kernels.reset_launch_counts()
        kernel = _kernels.fused_dense_quantized(x, wq, scale, b, activation=None)
        variant = [k for k in _kernels.launch_counts if k.startswith("fused_dense_quantized/")]
        addmm = torch.addmm(b, x, dequantize_weight(wq, scale))
        torch.cuda.synchronize()
        errs = {name: (t.double() - exact).abs().max().item()
                for name, t in (("quant_kernel", kernel), ("quant_addmm", addmm))}
        print(json.dumps({"shape": label, "M": M, "K": K, "N": N, "variant": variant,
                          "max_abs_err": errs,
                          "kernel_over_addmm": errs["quant_kernel"] / errs["quant_addmm"],
                          "exact_max_abs": exact.abs().max().item()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
