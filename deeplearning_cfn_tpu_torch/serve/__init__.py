"""Serving plane of the port — counterpart of ``deeplearning_cfn_tpu/serve``.

- :mod:`.paged_cache` — a slot-based paged K/V pool: pages plus per-slot
  block tables, so requests of different lengths share one decode program
  and freed pages recycle without reallocation.
- :mod:`.engine` — the prefill and decode steps over the pool (the decode
  step captured once as a CUDA graph on the card) and the
  continuous-batching scheduler that admits requests into in-flight batches
  at step boundaries.
- :mod:`.replica` — ``ServeReplica`` (registration and liveness around one
  engine) and ``ServeFrontEnd`` (routing, and replay of accepted requests
  across replica death).
- :mod:`.loadgen` — deterministic synthetic traffic on ``VirtualClock``.
- :mod:`.placement` — prefill/decode disaggregation across devices.
"""

from deeplearning_cfn_tpu_torch.serve.engine import (  # noqa: F401
    Completion,
    ContinuousBatchingEngine,
    ServeAdmissionError,
    ServeConfig,
    ServeRequest,
)
from deeplearning_cfn_tpu_torch.serve.loadgen import (  # noqa: F401
    LoadReport,
    TrafficConfig,
    generate_traffic,
    run_load,
)
from deeplearning_cfn_tpu_torch.serve.paged_cache import (  # noqa: F401
    BlockAllocator,
    PagedKVCache,
    init_paged_cache,
)
from deeplearning_cfn_tpu_torch.serve.placement import (  # noqa: F401
    ServePlacement,
    plan_placement,
)
from deeplearning_cfn_tpu_torch.serve.replica import (  # noqa: F401
    ServeFrontEnd,
    ServeReplica,
)
