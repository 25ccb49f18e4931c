"""Chaos scenarios of the port (``deeplearning_cfn_tpu/chaos``'s counterpart):
the ``slice-loss-live`` scenario so far."""

from deeplearning_cfn_tpu_torch.chaos.scenarios import (  # noqa: F401
    SCENARIO_FAULTS,
    SCENARIOS,
    ScenarioReport,
    run_scenario,
)
