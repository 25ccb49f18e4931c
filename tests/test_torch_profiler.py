"""The port's step profiler against the JAX package's, and ``fit(profiler=)``.

- Every scenario of ``tests/test_profiler.py`` (phase accounting, the sync
  boundary's spreading, overlapped folds, ``wrap_source``, per-step events,
  a k-step call, the disabled profiler, the journal, labels, folds from
  producer threads) runs on both profilers with the same virtual clock:
  the snapshots and the recorded events are equal, and the exact values of
  the JAX tests hold.
- ``Trainer.fit(profiler=)`` against the JAX ``Trainer.fit(profiler=)`` on
  tiny Llamas: the same phases with the same sample counts, eager, with and
  without the prefetcher.  Then the port's own loops on the CPU: the
  ``multi_step_fn(k)`` calls (eager there; captured on the card) and the
  remainder, one ``data_wait``, ``h2d`` and ``dispatch`` sample a call and
  ``compute`` samples for every step drained.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.obs import profiler as jax_profiler
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.train import data as jax_data
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax_profiler = None

from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import profiler  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax_profiler is None, reason="needs JAX, the reference")


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


class FakeRecorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append({"kind": kind, **fields})
        return self.events[-1]


def phase_accounting(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock)
    prof.start()
    for _ in range(4):
        clock.advance(0.001)
        with prof.phase("h2d"):
            clock.advance(0.002)
        with prof.phase("dispatch"):
            clock.advance(0.003)
        with prof.sync_boundary(1):
            clock.advance(0.010)
        prof.step_done()
    return prof


def sync_amortized(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock)
    prof.start()
    for _ in range(5):
        with prof.phase("dispatch"):
            clock.advance(0.001)
        prof.step_done()
    with prof.sync_boundary(5):
        clock.advance(0.050)
    return prof


def overlapped_fold(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock)
    prof.start()
    clock.advance(0.004)
    prof.fold("h2d", 0.100, critical=False)
    prof.step_done()
    return prof


def data_wait(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock)

    def slow_source():
        for i in range(3):
            clock.advance(0.007)
            yield i

    assert list(prof.wrap_source(slow_source())) == [0, 1, 2]
    return prof


def per_step_events(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock, recorder=rec, per_step_events=True)
    prof.start()
    for i in range(2):
        with prof.phase("dispatch"):
            clock.advance(0.002)
        clock.advance(0.001)
        prof.step_done(step=i)
    return prof


def k_step_call(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock)
    prof.start()
    with prof.phase("dispatch"):
        clock.advance(0.004)
    prof.step_done(steps=4)
    return prof


def journal(mod, clock, rec):
    prof = mod.StepProfiler(name="bench", clock=clock, recorder=rec)
    prof.start()
    with prof.phase("dispatch"):
        clock.advance(0.002)
    prof.step_done()
    prof.journal()
    return prof


def labels(mod, clock, rec):
    prof = mod.StepProfiler(name="labeled", clock=clock)
    assert "labels" not in prof.snapshot()
    prof.set_label("mode", "multi_step_k4")
    prof.set_label("k", 4)
    return prof


def unanchored(mod, clock, rec):
    prof = mod.StepProfiler(name="t", clock=clock, window=3)
    clock.advance(0.5)
    prof.step_done()  # no start(): only anchors the next interval
    for ms in (1, 2, 3, 4):
        clock.advance(ms / 1e3)
        prof.step_done()
    return prof


SCENARIOS = {f.__name__: f for f in (phase_accounting, sync_amortized, overlapped_fold,
                                      data_wait, per_step_events, k_step_call, journal,
                                      labels, unanchored)}
# The JAX tests' exact values (tests/test_profiler.py).
EXPECTED = {
    "phase_accounting": lambda s: (s["steps"], s["h2d_ms"], s["dispatch_ms"], s["compute_ms"],
                                   s["host_ms"], s["step_ms"]["p50"]) == (4, 2.0, 3.0, 10.0,
                                                                          1.0, 16.0),
    "sync_amortized": lambda s: (s["phases"]["compute"]["count"],
                                 s["phases"]["compute"]["total_ms"],
                                 s["phases"]["compute"]["p50_ms"]) == (5, 50.0, 10.0),
    "overlapped_fold": lambda s: (s["h2d_ms"], s["host_ms"], s["step_ms"]["p50"]) ==
    (100.0, 4.0, 4.0),
    "data_wait": lambda s: (s["phases"]["data_wait"]["count"],
                            s["phases"]["data_wait"]["total_ms"]) == (3, 21.0),
    "per_step_events": lambda s: s["steps"] == 2,
    "k_step_call": lambda s: (s["steps"], s["dispatch_ms"], s["step_ms"]["p50"]) ==
    (4, 1.0, 1.0),
    "journal": lambda s: s["dispatch_ms"] == 2.0,
    "labels": lambda s: s["labels"] == {"mode": "multi_step_k4", "k": 4},
    "unanchored": lambda s: s["steps"] == 4 and s["step_ms"]["max"] == 4.0,
}


@needs_jax
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_profiler_matches_jax(name):
    out = {}
    for mod in (jax_profiler, profiler):
        clock, rec = VirtualClock(), FakeRecorder()
        prof = SCENARIOS[name](mod, clock, rec)
        out[mod] = (prof.snapshot(), rec.events, prof.recent_step_ms())
    assert out[profiler] == out[jax_profiler]
    snap, events, _ = out[profiler]
    assert EXPECTED[name](snap), snap
    assert [f"{p}_ms" for p in profiler.PHASES] == [k for k in snap if k.endswith("_ms")
                                                    and k != "step_ms"]
    if name == "per_step_events":
        assert [e["kind"] for e in events] == ["step_time"] * 2
        assert (events[0]["total_ms"], events[0]["dispatch_ms"], events[0]["host_ms"]) == \
            (3.0, 2.0, 1.0)
    if name == "journal":
        assert [e["kind"] for e in events] == ["step_profile"] and events[0]["name"] == "bench"


def test_phases_and_the_disabled_profiler():
    assert profiler.PHASES == ("data_wait", "h2d", "dispatch", "compute", "host")
    src = iter(())
    assert profiler.NULL_PROFILER.wrap_source(src) is src
    with profiler.NULL_PROFILER.phase("dispatch"), profiler.NULL_PROFILER.sync_boundary(4):
        pass
    profiler.NULL_PROFILER.step_done()
    profiler.NULL_PROFILER.set_label("mode", "x")
    rec = FakeRecorder()
    profiler.NULL_PROFILER.journal(recorder=rec)
    assert rec.events == [] and profiler.NULL_PROFILER.snapshot()["steps"] == 0
    assert "labels" not in profiler.NULL_PROFILER.snapshot()


def test_rolling_quantiles_match_nearest_rank():
    q = profiler.RollingQuantiles(window=1000)
    assert q.quantiles() == {}
    for v in range(1, 101):
        q.add(float(v))
    assert q.quantiles() == {"p50": 51.0, "p95": 95.0, "p99": 99.0}
    small = profiler.RollingQuantiles(window=8)
    for v in range(100):
        small.add(float(v))
    assert len(small) == 8 and small.samples()[0] == 92.0 and small.quantiles()["p50"] == 96.0


def test_folds_from_producer_threads_are_counted():
    prof = profiler.StepProfiler(name="t", clock=VirtualClock())
    prof.start()

    def producer():
        for _ in range(100):
            prof.fold("h2d", 0.001, critical=False)

    threads = [threading.Thread(target=producer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert prof.snapshot()["phases"]["h2d"]["count"] == 400


# --- fit(profiler=) -------------------------------------------------------------

SEQ, VOCAB, BATCH = 16, 64, 2


def _port_trainer(log_every: int):
    cfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    t = llama.make_trainer(cfg, trainer.TrainerConfig(optimizer="adamw", learning_rate=1e-3,
                                                      log_every=log_every), device="cpu")
    return t, t.init(seed=0)


def _counts(prof) -> dict:
    return {k: v["count"] for k, v in prof.snapshot()["phases"].items()}


@needs_jax
@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_folds_the_phases_jax_fit_folds(prefetch):
    steps, log_every = 5, 2
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32)
    jtrainer = jax_llama.make_trainer(
        jcfg, build_mesh(MeshSpec(), jax.devices()[:1]),
        JaxTrainerConfig(optimizer="adamw", learning_rate=1e-3, log_every=log_every))
    jds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    jstate = jtrainer.init(jax.random.key(0), jnp.asarray(next(iter(jds.batches(1))).x))
    jprof = jax_profiler.StepProfiler(name="fit")
    jtrainer.fit(jstate, jds.batches(steps), steps=steps, prefetch=prefetch, profiler=jprof)

    ttrainer, tstate = _port_trainer(log_every)
    tds = data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    tprof = profiler.StepProfiler(name="fit")
    tstate, losses = ttrainer.fit(tstate, tds.batches(steps), steps=steps, prefetch=prefetch,
                                  profiler=tprof)
    assert len(losses) == steps
    assert _counts(tprof) == _counts(jprof)
    # One sample a step for the loop's phases; compute: the first step's
    # wait, then every step drained at a readback.
    assert _counts(tprof) == {"data_wait": steps, "h2d": steps * (2 if prefetch else 1),
                              "dispatch": steps, "compute": steps + 1, "host": steps}
    snap, jsnap = tprof.snapshot(), jprof.snapshot()
    assert snap.keys() == jsnap.keys() and snap["steps"] == jsnap["steps"] == steps


@pytest.mark.parametrize("k,steps", [(1, 6), (2, 6), (4, 6), (3, 7)])
def test_fit_profiles_the_stacked_calls_and_the_remainder(k, steps):
    """k > 1: ``steps // k`` multi-step calls (eager on the CPU, one CUDA
    graph on the card), then the remainder one step a call, all in one
    loop: a ``data_wait``, ``h2d`` and ``dispatch`` sample and one
    ``step_done`` a call, ``compute`` spread over every step."""
    ttrainer, tstate = _port_trainer(log_every=2)
    tds = data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    prof = profiler.StepProfiler(name="fit")
    tstate, losses = ttrainer.fit(tstate, tds.batches(steps), steps=steps, prefetch=0,
                                  steps_per_call=k, profiler=prof)
    calls = steps // k + steps % k
    assert len(losses) == steps and tstate.step == steps
    assert _counts(prof) == {"data_wait": calls, "h2d": calls, "dispatch": calls,
                             "compute": steps + 1, "host": steps}
    snap = prof.snapshot()
    assert snap["steps"] == steps
    mean = snap["step_ms"]["mean"]
    parts = sum(snap[f"{p}_ms"] for p in profiler.PHASES)
    assert np.isclose(parts, mean, rtol=0.05, atol=0.05), (parts, mean)


def test_fit_without_a_profiler_still_refuses_a_reshard():
    """The live reshard is ported (``tests/test_torch_reshard.py``): ``fit``
    takes a coordinator, and refuses one only beside a captured multi-step
    call, profiler or not."""
    ttrainer, tstate = _port_trainer(log_every=1)
    assert ttrainer.fit(tstate, iter(()), steps=1, reshard=object()) == (tstate, [])
    with pytest.raises(ValueError, match="steps_per_call"):
        ttrainer.fit(tstate, iter(()), steps=2, steps_per_call=2, reshard=object())


@needs_jax
@pytest.mark.parametrize("kw", [
    dict(flops=4.0e12, bytes_accessed=2.0e9, seconds_per_call=0.5, steps_per_call=4,
         peak_flops=989e12),
    dict(flops=None, bytes_accessed=3.0e6, seconds_per_call=0.0),
    dict(flops=7.0, bytes_accessed=None, seconds_per_call=0.125, peak_flops=None),
])
def test_program_attribution_equals_jax(kw):
    assert profiler.program_attribution(**kw) == jax_profiler.program_attribution(**kw)


def test_program_cost_counts_a_training_step():
    """``program_cost`` keeps JAX's keys; its FLOPs are ``FlopCounterMode``'s
    over one forward and backward (on ``meta``, no memory) or the analytic
    count given; its bytes the parameters twice, the input, the output and
    the tensors saved for the backward, written and read back."""
    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=16, dtype=torch.float32)
    with torch.device("meta"):
        model = llama.Llama(cfg)
        x = torch.zeros((2, 16), dtype=torch.int64)
    got = profiler.program_cost(model, x)
    assert set(got) == {"flops", "bytes_accessed"}
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    floor = 2 * params + 2 * 16 * 8 + 2 * 16 * 64 * 4
    # Every block saves at least its two norms' inputs and its MLP's hidden.
    acts = cfg.n_layers * 2 * 16 * (2 * cfg.dim + cfg.mlp_dim) * 4
    assert got["bytes_accessed"] >= floor + 2 * acts
    analytic = llama.train_flops_per_token(cfg, 16) * 2 * 16
    assert 0.5 < got["flops"] / analytic < 2.0
    given = profiler.program_cost(model, x, flops=analytic)
    assert given == {"flops": analytic, "bytes_accessed": got["bytes_accessed"]}
    assert profiler.program_cost(model, torch.zeros((2, 3, 4, 5)))["bytes_accessed"] is None
    lin = torch.nn.Linear(8, 4)
    assert profiler.program_cost(lin, torch.zeros(2, 8))["flops"] == 2 * (2 * 2 * 8 * 4)


def test_program_cost_leaves_the_callers_gradients():
    """Gradients being accumulated survive a count, bitwise; with ``flops``
    given no backward runs.  Linear then ReLU: the parameters read and
    written (36 f32), x read (16), the output written (8) and, saved by the
    ReLU, read back (8); the Linear's saved x is x."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU())
    x = torch.randn(2, 8)
    net(x).sum().backward()
    before = [p.grad.clone() for p in net.parameters()]
    got = profiler.program_cost(net, x)
    assert got == {"flops": 2 * (2 * 2 * 8 * 4), "bytes_accessed": 4.0 * (2 * 36 + 16 + 8 + 8)}
    assert all(torch.equal(p.grad, b) for p, b in zip(net.parameters(), before))
    backward_ran = []
    net[0].weight.register_hook(lambda g: backward_ran.append(g))
    assert profiler.program_cost(net, x, flops=1.0) == {
        "flops": 1.0, "bytes_accessed": got["bytes_accessed"]}
    assert backward_ran == []
    assert all(torch.equal(p.grad, b) for p, b in zip(net.parameters(), before))
