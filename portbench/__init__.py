"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``

Everything a cell is made of is found by name: the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json`` (it
names the driver in ``drivers/``), and each metric's reader in
``metrics/<metric>.py``.  The FLOP counts (``flops.py``), the peaks
(``peaks.py``), the interval arithmetic (``intervals.py``), the generators
(``traffic.py``, ``weights.py``) and the plain references (``reference/``)
are the benchmark's own, so that a change to the program cannot move them.
Nothing here imports JAX or the JAX package; the program under test is
``deeplearning_cfn_tpu_torch``.
"""
