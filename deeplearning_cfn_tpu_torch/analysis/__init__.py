"""dlcfn-lint for the port: repo-native static analysis and its audits.

The JAX package's analysis, over the port's own tree and idioms:

- :mod:`core` — the AST rule framework (registry, per-line
  ``# dlcfn: noqa[RULE]`` suppression, JSON/human output).
- :mod:`rules` — the DLC0xx per-file rules (untimed blocking calls,
  NaN-unsafe JSON, host syncs in captured code, swallowed interrupts,
  substring param matching, daemonless threads, py2 remnants,
  out-of-place state steps).
- :mod:`contract_check` — the DLC1xx broker contract: the port's
  ``cluster/contract.py``, client and supervisor against the C++ broker
  it builds (``native/broker/broker.cpp``).
- :mod:`concurrency` — the DLC2xx lockset/thread-escape rules (gated).
- :mod:`protocol` — the DLC3xx message-shape and lifecycle-kind checks
  (gated).
- :mod:`sharding` — the DLC4xx capture-safety rules (gated): what a CUDA
  graph freezes, syncs or copies, mesh-axis names, in-place state.
- :mod:`collectives` — the DLC5xx DTensor/FSDP2 comms rules (gated).
- :mod:`determinism` — the DLC6xx nondeterminism rules (gated), torch's
  global generator included.
- :mod:`schedules` — the deterministic interleaving harness and the soaks.
- :mod:`runner` — discovery, gating and the baseline ratchet behind
  ``python -m deeplearning_cfn_tpu_torch.cli lint``.
- :mod:`compile_audit`, :mod:`comms_audit`, :mod:`replay_audit` — the
  dynamic sentinels (DLC410/411, DLC510-512, DLC610), imported on use.
"""

from deeplearning_cfn_tpu_torch.analysis.core import (  # noqa: F401
    FILE_RULES,
    FileContext,
    Rule,
    Violation,
    lint_source,
)
from deeplearning_cfn_tpu_torch.analysis.runner import run_lint  # noqa: F401
