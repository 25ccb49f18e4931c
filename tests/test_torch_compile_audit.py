"""The port's compile-audit sentinel (``analysis/compile_audit.py``).

- ``violations_for`` gives the JAX package's DLC410/DLC411 findings, message
  for message, for the same path audits.
- The watcher counts captures by owner (an unrelated wrapper's capture does
  not count, a wrapper class does), builds for every watcher, and reports
  what grew after the mark.
- The trainer's ``single_step`` and ``multi_step`` paths and the serve
  engine's decode reach a fixed point on the CPU and update their state in
  place; a step that rebinds its parameters to new storage is DLC411.
- On the card (``cuda`` marker), the phase 23 gates: one capture of the
  ``multi_step_fn`` graph, none after the mark, flash launched in its wgmma
  variant in the capture, every state leaf updated in place; one
  ``CapturedDecode`` and the pool's storage unchanged; a second model handed
  to the wrapper recaptures and gives DLC410.
"""

import pytest
import torch

try:
    from deeplearning_cfn_tpu.analysis import compile_audit as jca
except ImportError:  # the card's host
    jca = None

from deeplearning_cfn_tpu_torch.analysis import compile_audit as ca  # noqa: E402

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jca is None, reason="needs JAX, the reference")


def _paths(mod, anchor=None):
    d = mod.DonationReport(donated_bytes=0, retained_bytes=64, donated_leaves=0,
                           retained_leaves=2)
    return [mod.PathAudit(name="multi_step", steady_steps=4,
                          new_compiles={"CapturedSteps(k=2)": 1, "train_step": 2},
                          donation=d, audited_file=anchor),
            mod.PathAudit(name="single_step", steady_steps=4),
            mod.PathAudit(name="serve_decode", steady_steps=9, new_compiles={"x": 1},
                          audited_file=anchor)]


@needs_jax
def test_violations_for_gives_jaxs_findings():
    ours = [(v.rule, v.line, v.col, v.message) for v in ca.violations_for(_paths(ca, "a.py"))]
    theirs = [(v.rule, v.line, v.col, v.message) for v in jca.violations_for(_paths(jca, "a.py"))]
    assert ours == theirs
    assert [r for r, *_ in ours] == ["DLC410", "DLC411", "DLC410"]
    anchors = [v.path for v in ca.violations_for(_paths(ca))]
    assert anchors[0] == str(ca.AUDITED_FILE)
    assert ca.AUDITED_FILE.relative_to(ca.REPO_ROOT).as_posix() == \
        "deeplearning_cfn_tpu_torch/train/trainer.py"


@needs_jax
def test_path_and_report_dicts_keep_jaxs_keys():
    p = _paths(ca)[0]
    jp = _paths(jca)[0]
    assert set(jp.to_dict()) == set(p.to_dict())
    assert set(jp.donation.to_dict()) <= set(p.donation.to_dict())
    assert p.clean is jp.clean is False


def test_watcher_counts_by_owner_and_builds_for_all():
    mine, other = object(), object()

    class Wrapper:
        pass

    w1 = Wrapper()
    with ca.CompileWatcher(owners=[mine]) as a, ca.CompileWatcher(owners=[Wrapper]) as b, \
            ca.CompileWatcher() as c:
        ca.note_capture(mine, "CapturedSteps(k=2)")
        ca.note_capture(other, "CapturedDecode")
        ca.note_capture(w1, "CapturedDecode")
        a.mark_steady()
        ca.note_build("flash_attn_fwd")
        ca.note_capture(mine, "CapturedSteps(k=2)")
    assert a.traces == {"CapturedSteps(k=2)": 2}
    assert a.new_compiles_since_mark() == {"CapturedSteps(k=2)": 1, "build:flash_attn_fwd": 1}
    assert a.new_traces_since_mark() == {"CapturedSteps(k=2)": 1}
    assert a.retrace_count == 1 and a.backend_compiles == 1
    assert b.traces == {"CapturedDecode": 1}
    assert c.compile_count == 5
    ca.note_capture(mine, "after")  # no watcher active: nothing counts
    assert "after" not in c.compiles


def test_trainer_and_engine_reach_a_fixed_point_on_the_cpu():
    report = ca.run_compile_audit(device="cpu", journal=False)
    assert report.violations == []
    single, multi = report.paths
    assert single.donation.donated_leaves == 4 and single.donation.retained_leaves == 0
    assert multi.donation.freed_bytes == 0  # numpy-backed CPU batches cannot be freed
    assert multi.cache_size is None  # the CPU runs multi_step_fn's steps eagerly
    serve = ca.run_serve_audit(device="cpu", journal=False)
    assert serve.violations == [] and serve.watcher["pool_storage_unchanged"]
    assert serve.paths[0].donation.donated_leaves == 2
    assert serve.paths[0].steady_steps > 24


def test_a_step_that_rebinds_its_parameters_is_dlc411():
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(ca.audit_mlp(), TrainerConfig(optimizer="sgd"), device="cpu")
    state = trainer.init(seed=0)

    def out_of_place(state):
        with torch.no_grad():
            for p in state.model.parameters():
                p.data = p.data * 0.5  # new storage: the old copy lived through it
        return state, None

    _, donation = ca.measure_donation(out_of_place, state)
    assert donation.retained_leaves == 4 and not donation.effective
    path = ca.PathAudit(name="single_step", steady_steps=1, donation=donation)
    assert [v.rule for v in ca.violations_for([path])] == ["DLC411"]


def test_compile_audit_journals_its_event(tmp_path):
    from deeplearning_cfn_tpu_torch.obs import recorder

    journal = tmp_path / "flight.jsonl"
    recorder.configure(path=journal)
    try:
        ca.run_serve_audit(device="cpu", steady_requests=2)
    finally:
        recorder.configure()
    (event,) = recorder.read_journal(journal, kind="compile_audit")
    assert event["clean"] is True and set(event["paths"]) == {"serve_decode"}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phase23_gates_on_card(cuda_device):
    import dataclasses

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch, \
        stack_batches
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    mlp = ca.run_compile_audit(device="cuda", journal=False)
    assert mlp.violations == [] and mlp.paths[1].cache_size == 1
    # m435 width, two layers, multi_step_fn(2): one capture, none after the mark.
    cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=2)
    trainer = llama.make_trainer(cfg, TrainerConfig(optimizer="adamw", learning_rate=3e-4),
                                 device="cuda")
    data = SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=1)
    (xs, ys), = [device_put_batch(b, cuda_device)
                 for b in stack_batches(iter(list(data.batches(2))), 2)]
    state = trainer.init(seed=0, draw_on_device=True)
    kfn = trainer.multi_step_fn(2)
    with ca.CompileWatcher(owners=[kfn]) as w:
        _kernels.reset_launch_counts()
        state, _ = kfn(state, xs, ys)
        assert _kernels.launch_counts.get("flash_attention_fwd/wgmma_tma", 0) > 0
        w.mark_steady()
        for _ in range(2):
            state, _ = kfn(state, xs, ys)
        (state, _), donation = ca.measure_donation(kfn, state, xs, ys)
        assert w.new_compiles_since_mark() == {} and kfn.captures == 1
    assert donation.retained_leaves == 0 and donation.untouched_leaves == 0
    serve = ca.run_serve_audit(device="cuda", journal=False)
    assert serve.violations == [] and serve.watcher["decode_captures"] == 1
    assert serve.watcher["pool_storage_unchanged"]
    # The control: another model through the same wrapper recaptures.
    small = Trainer(ca.audit_mlp(), TrainerConfig(optimizer="sgd"), device="cuda")
    k2 = small.multi_step_fn(2)
    bx, by = torch.randn(2, 8, 8, 8, 1, device="cuda"), torch.randint(0, 4, (2, 8), device="cuda")
    with ca.CompileWatcher(owners=[k2]) as w:
        k2(small.init(seed=0), bx, by)
        w.mark_steady()
        k2(small.init(seed=1), bx, by)
        path = ca.PathAudit(name="multi_step", steady_steps=1,
                            new_compiles=w.new_compiles_since_mark())
    assert [v.rule for v in ca.violations_for([path])] == ["DLC410"]
