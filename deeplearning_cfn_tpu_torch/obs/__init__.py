"""Observability of the port: the flight recorder, spans, the heartbeater,
liveness, the step profiler, fleet telemetry, SLO rules and their engine,
the crash black box, the cross-host trace and the Prometheus exporter —
counterpart of ``deeplearning_cfn_tpu/obs/``, with its exports.  Nothing in
here imports torch at module scope: the broker, the agent and the command
line stay light.
"""

from deeplearning_cfn_tpu_torch.obs.recorder import (
    FlightRecorder,
    configure,
    follow_journal,
    get_recorder,
    read_journal,
)
from deeplearning_cfn_tpu_torch.obs.tracing import span, span_aggregates, reset_aggregates
from deeplearning_cfn_tpu_torch.obs.liveness import (
    LivenessConfig,
    LivenessTable,
    WorkerState,
)
from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
from deeplearning_cfn_tpu_torch.obs.profiler import (
    NULL_PROFILER,
    RollingQuantiles,
    StepProfiler,
    program_attribution,
    program_cost,
)
from deeplearning_cfn_tpu_torch.obs.trace_export import (
    chrome_trace,
    merge_journals,
    straggler_table,
)
from deeplearning_cfn_tpu_torch.obs.aggregator import (
    FleetAggregator,
    agent_snapshot,
    decode_snapshot,
    encode_snapshot,
    fleet_metric_values,
    telemetry_source,
)
from deeplearning_cfn_tpu_torch.obs.slo import DEFAULT_RULES, SloEngine, SloRule
from deeplearning_cfn_tpu_torch.obs.blackbox import (
    BlackBox,
    capture_bundle,
    merge_bundles,
    read_bundle,
    render_timeline,
    write_bundle,
)

__all__ = [
    "FlightRecorder",
    "configure",
    "follow_journal",
    "get_recorder",
    "read_journal",
    "span",
    "span_aggregates",
    "reset_aggregates",
    "LivenessConfig",
    "LivenessTable",
    "WorkerState",
    "Heartbeater",
    "NULL_PROFILER",
    "RollingQuantiles",
    "StepProfiler",
    "program_attribution",
    "program_cost",
    "chrome_trace",
    "merge_journals",
    "straggler_table",
    "FleetAggregator",
    "agent_snapshot",
    "decode_snapshot",
    "encode_snapshot",
    "fleet_metric_values",
    "telemetry_source",
    "DEFAULT_RULES",
    "SloEngine",
    "SloRule",
    "BlackBox",
    "capture_bundle",
    "merge_bundles",
    "read_bundle",
    "render_timeline",
    "write_bundle",
]
