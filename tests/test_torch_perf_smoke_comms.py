"""The port's perf-smoke gate: stages 10 and 11 (``comms``,
``comms_overlap``) on the comms audit's two gloo ranks on the CPU.

- ``comms``: the audited fsdp train step's collective bytes equal the
  committed budget's (``analysis/comms_budget.json``) exactly; with an
  extra all-reduce planted in the step (the audit's ``extra_allreduce``)
  they do not, and the stage names it.
- ``comms_overlap``: the bucketed dp program's overlap score beats the dp
  step's (14.6667 against 14.0 on the CPU ranks), its buckets hold the
  whole gradient tree, and nothing is captured or built after the warm-up;
  with the last bucket left out of the sync (the audit's
  ``unsynced_bucket``) the byte accounting fails, by name.
"""

import functools

import pytest

from deeplearning_cfn_tpu_torch.analysis import comms_audit  # noqa: E402
from deeplearning_cfn_tpu_torch.scripts import perf_smoke as ps  # noqa: E402

STAGES = dict(ps.STAGES)


def test_comms_stage_holds_the_committed_bytes():
    snap, failures = STAGES["comms"]("cpu")
    assert failures == []
    committed = comms_audit.load_budget()["programs"]["train_step"]
    assert snap["train_step"]["collective_bytes"] == committed["collective_bytes"] == 103448
    assert snap["backend"] == "gloo"


def test_comms_overlap_stage_beats_the_dp_step():
    snap, failures = STAGES["comms_overlap"]("cpu")
    assert failures == []
    assert (snap["monolithic_overlap_score"], snap["bucketed_overlap_score"]) == (14.0, 14.6667)
    assert snap["buckets"] == 2 and snap["post_warmup_compiles"] == 0
    # fc1 (256 x 64 + 256) and fc2 (4 x 256 + 4) in f32.
    assert snap["bucket_bytes"] == 4 * (256 * 64 + 256 + 4 * 256 + 4)


PLANTS = {"comms": ("extra_allreduce", "train_step collective_bytes"),
          "comms_overlap": ("unsynced_bucket", "bucket byte accounting")}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_a_planted_violation_fails_the_stage_by_name(name, monkeypatch):
    plant, expected = PLANTS[name]
    monkeypatch.setattr(comms_audit, "run_comms_audit",
                        functools.partial(comms_audit.run_comms_audit, plant=plant))
    _, failures = STAGES[name]("cpu")
    assert any(f.startswith(expected) for f in failures), failures
