"""Plain PyTorch references, float32 with TF32 off.  They import neither
JAX, nor the JAX package, nor anything of the program under test, and take
nothing the program made: the benchmark draws the weights and inputs
(``portbench/weights.py``, ``portbench/traffic.py``) and hands the same to
both sides."""
