"""deeplearning_cfn_tpu_torch — the PyTorch/CUDA port of the compute path.

The JAX package ``deeplearning_cfn_tpu`` stays the reference; this package
is its counterpart for one NVIDIA H100 (Hopper, ``sm_90a``).  Plain tensor
code is PyTorch; every Pallas kernel of the JAX package on a ported path is
a CUDA C++ kernel written by hand under ``ops/csrc/`` and built with
``nvcc`` at first use (``ops/_kernels.py``).

The port imports nothing from the JAX package: where it needs code that
lives there (synthetic data, schedules, metrics), it keeps its own copy.

Ported so far: Llama causal-LM training (``examples/llama_train.py``)
through the flash-attention forward kernel, on one device or over a mesh of
ranks (``parallel/``: dp as DDP, fsdp as FSDP2, MoE experts over ep), with
AdamW, LAMB or Adafactor; BERT masked-LM pretraining and fine-tuning
(``examples/bert_pretrain.py``, ``examples/bert_finetune.py``) through the
fused-dense kernel, beside which sits its int8-weight variant; ResNet
training (``examples/resnet_imagenet.py``); Llama serving (``serve/``).
"""

__version__ = "0.1.0"
