"""The port's comms-audit sentinel (``analysis/comms_audit.py``).

- On 2 gloo ranks on the CPU, the six programs (JAX's names and audit
  shapes) run the committed budget's collective counts and bytes
  (``analysis/comms_budget.json``), both ranks alike, each rank's backend
  counting as many collectives as c10d issued; FSDP2's gathers are all
  predicted by its parameter groups; no finding, and the baseline holds no
  comms entry (DLC512 on ``train_step_dp_overlap`` fired while
  ``train_step_dp`` ran DDP's wrapper, whose bucket-rebuild broadcasts
  lifted its score; the dp step is now the bucketed sync's engine).
- (``test_torch_comms_audit_planted.py``: planted faults give DLC510 and
  DLC511.)
- ``violations_for`` gives the JAX package's messages for the same
  programs and budget, and the journal's ``comms_audit`` event folds
  through the port's ``obs/exporter.fold_comms_events`` as JAX's does
  through its own.
- The trace readers on hand-made records: result bytes from the c10d op's
  output (or the backend's, for tensor-list ops), the overlap score.
"""

import pytest

try:
    from deeplearning_cfn_tpu.analysis import comms_audit as jcm
    from deeplearning_cfn_tpu.obs import exporter as jexporter
except ImportError:  # the card's host
    jcm = None

from deeplearning_cfn_tpu_torch.analysis import comms_audit as cm  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import runner  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis.collectives import AUDIT_RULE_IDS  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import exporter  # noqa: E402

needs_jax = pytest.mark.skipif(jcm is None, reason="needs JAX, the reference")


@pytest.fixture(scope="module")
def report():
    return cm.run_comms_audit(device="cpu", journal=False)


def test_the_six_programs_run_the_committed_budget(report):
    budget = cm.load_budget()
    assert budget["device_count"] == cm.RANKS and report.budget_checked
    assert [p.name for p in report.programs] == list(cm.PROGRAMS) == list(budget["programs"])
    for p in report.programs:
        b = budget["programs"][p.name]
        assert (p.collective_count, p.collective_bytes) == \
            (b["collective_count"], b["collective_bytes"]), p.name
        assert p.overlap_score == b["overlap_score"], p.name
        assert p.witness_count == p.collective_count, p.name
        assert p.unpredicted_gathers == ()
    for name, m in report.measured.items():
        assert len(set(m["rank_counts"])) == len(set(m["rank_bytes"])) == 1, name
        assert m["witness_counts"] == m["rank_counts"], name
    fsdp = {p.name: p for p in report.programs}["train_step"]
    assert fsdp.by_op["all-gather"] == 1 and fsdp.by_op["reduce-scatter"] == 1
    assert {p.name: p for p in report.programs}["serve_decode"].collective_count == 0


def test_the_only_finding_is_the_baselined_overlap_pair(report):
    """The overlap pair's finding is gone with DDP's wrapper: the bucketed
    program beats the dp step's score, and no baseline entry is left stale."""
    assert report.violations == []
    fresh, stale = runner.apply_audit_baseline(report.violations, None, AUDIT_RULE_IDS)
    assert fresh == [] and stale == []


def test_fsdp_prediction_is_the_flat_group_not_the_parameter(report):
    """FSDP2 gathers fc1's weight (256 x 64, the one leaf the FSDP rule
    shards; the rest stay whole) as one flat padded buffer of both ranks'
    128 x 64 shards: (16384,), which is no parameter's shape."""
    m = report.measured["train_step"]
    assert m["gathers"] == [(16384,)]
    predicted = {tuple(s) for s in m["predicted"]}
    assert (16384,) in predicted
    assert {(256, 64), (256,), (4, 256), (4,)} <= predicted


def _records():
    c10d = lambda name, t, shapes, dtypes: {"name": name, "thread": 1, "start": t, "end": t + 1,
                                            "shapes": shapes, "dtypes": dtypes}
    op = lambda name, t, thread=1: {"name": name, "thread": thread, "start": t, "end": t + 1,
                                    "shapes": [], "dtypes": []}
    gloo = lambda name, t, shape, dtype: {"name": name, "thread": 7, "start": t, "end": t + 5,
                                          "shapes": [shape], "dtypes": [dtype]}
    return [
        c10d("c10d::_allgather_base_", 0, [[16640], [8320]], ["float", "float"]),
        gloo("gloo:all_gather", 1, [8320], "float"),
        op("aten::mm", 3), op("aten::relu", 5),
        c10d("c10d::allreduce_", 7, [[], []], ["TensorList", ""]),
        gloo("gloo:all_reduce", 8, [10], "c10::BFloat16"),
        op("aten::add_", 9), op("aten::mul", 11, thread=2),
        c10d("c10d::_reduce_scatter_base_", 13, [[514], [1028]], ["float", "float"]),
        gloo("gloo:all_reduce", 14, [1028], "float"),
    ]


def test_trace_readers_on_records():
    ops, witness = cm.trace_collectives(_records(), world=2)
    assert [(o.op, o.result_shapes, o.nbytes) for o in ops] == [
        ("all-gather", ((16640,),), 66560), ("all-reduce", ((10,),), 20),
        ("reduce-scatter", ((514,),), 2056)]
    assert witness == 3
    # Slack: 2 ops after the gather, 1 after the all-reduce (thread 2's op
    # is another thread's), 0 after the reduce-scatter (the end).
    assert cm.trace_overlap(_records()) == {
        "overlap_score": 1.0, "serialized_collectives": 1, "scheduled_collectives": 3}


def _programs(mod):
    def prog(name, count, nbytes, score, gathers=()):
        return mod.ProgramComms(name=name, collective_count=count, collective_bytes=nbytes,
                                peak_hbm_bytes=0, by_op={}, bytes_by_op={}, flops=None,
                                bytes_accessed=None, overlap_score=score,
                                unpredicted_gathers=gathers, audited_file="t.py")
    return [prog("train_step", 9, 200, 1.0, ((16, 64),)), prog("train_step_dp", 4, 10, 3.0),
            prog("train_step_dp_overlap", 4, 10, 2.0)]


@needs_jax
def test_violations_for_gives_jaxs_findings():
    budget = {"device_count": 2, "programs": {
        "train_step": {"collective_count": 8, "collective_bytes": 100, "overlap_score": 2.0},
        "train_step_dp": {"collective_count": 4, "collective_bytes": 10}}}
    key = lambda vs: [(v.rule, v.path, v.line, v.col, v.message) for v in vs]
    ours = key(cm.violations_for(_programs(cm), budget, device_count=2))
    assert ours == key(jcm.violations_for(_programs(jcm), budget, device_count=2))
    assert sorted(r for r, *_ in ours) == ["DLC510", "DLC511", "DLC512", "DLC512"]
    assert key(cm.violations_for(_programs(cm), budget, device_count=8)) == \
        key(jcm.violations_for(_programs(jcm), budget, device_count=8))


@needs_jax
def test_journal_event_folds_like_jaxs(tmp_path):
    ours = [p.to_dict() for p in _programs(cm)]
    theirs = [p.to_dict() for p in _programs(jcm)]
    event = lambda ps: {"kind": "comms_audit", "programs": {p["name"]: p for p in ps}}
    assert exporter.fold_comms_events([event(ours)]) == jexporter.fold_comms_events([event(theirs)])


def test_the_card_holds_counts_and_bytes_not_the_cpus_overlap():
    budget = cm.load_budget()
    held = cm.held_on(budget, "cuda")
    assert held["programs"]["train_step"] == {
        k: v for k, v in budget["programs"]["train_step"].items() if k != "overlap_score"}
    assert cm.held_on(budget, "cpu") is budget


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phase23_comms_and_replay_gates_on_card(cuda_device):
    """On the card: the six programs on 2 gloo ranks on cuda:0 run the
    committed CPU budget's counts and bytes, c10d's count equal to the
    backend's; and every catalog case that starts no rank process, and both
    soaks, replays byte-equal with its engines on the card."""
    on_card = cm.run_comms_audit(device="cuda", journal=False)
    budget = cm.load_budget()["programs"]
    assert {p.name: (p.collective_count, p.collective_bytes) for p in on_card.programs} == \
        {n: (b["collective_count"], b["collective_bytes"]) for n, b in budget.items()}
    assert all(m["witness_counts"] == m["rank_counts"] for m in on_card.measured.values())
    fresh, _ = runner.apply_audit_baseline(on_card.violations, None, AUDIT_RULE_IDS)
    assert fresh == []

    from deeplearning_cfn_tpu_torch.analysis import replay_audit as ra

    cases = [c for c in ra.default_cases(device="cuda") if not ra.spawns_ranks(c.name)]
    replay = ra.run_replay_audit(cases=cases, journal=False)
    assert replay.violations == [] and len(replay.replays) == 13
