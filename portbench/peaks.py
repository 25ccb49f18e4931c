"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense,
no sparsity, at the full 700 W limit).  Copied from the port's
``train/metrics.py`` table, SXM row only: the benchmark states every share
against these and records the card's name and ``power.limit`` beside it."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
