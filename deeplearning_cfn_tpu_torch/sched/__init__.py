"""Multi-tenant fleet scheduling: one cluster arbitrating many jobs —
counterpart of ``deeplearning_cfn_tpu/sched/``, copied (the port imports
nothing of the JAX package; ``tests/test_torch_sched.py`` holds the copies to
the originals).

The policy layer over the cluster's mechanisms (live reshard, serve-pool
resizes, the broker KV, SLO alerts): job specs with
priority classes and slice quotas (:mod:`~deeplearning_cfn_tpu_torch.sched.specs`),
a deterministic bin-packing placer
(:mod:`~deeplearning_cfn_tpu_torch.sched.placer`), the alert-driven arbiter
with its broker-persisted ledger
(:mod:`~deeplearning_cfn_tpu_torch.sched.arbiter`), and the preemption driver
that turns decisions into live reshards and serve-pool resizes
(:mod:`~deeplearning_cfn_tpu_torch.sched.preempt`).  ``python -m
deeplearning_cfn_tpu_torch.cli chaos --scenario sched-flash-crowd`` is the
gate.
"""

from deeplearning_cfn_tpu_torch.sched.arbiter import (  # noqa: F401
    DEFAULT_SERVE_RULES,
    LEDGER_KEY,
    FleetArbiter,
    SchedError,
)
from deeplearning_cfn_tpu_torch.sched.placer import (  # noqa: F401
    Placement,
    place,
    verify_placement,
)
from deeplearning_cfn_tpu_torch.sched.preempt import (  # noqa: F401
    PreemptionDriver,
    ServePoolHandle,
    TrainJobHandle,
)
from deeplearning_cfn_tpu_torch.sched.specs import (  # noqa: F401
    JOB_KINDS,
    PRIORITY_CLASSES,
    JobSpec,
    priority_rank,
)
