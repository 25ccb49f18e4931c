"""The port's serving plane (``deeplearning_cfn_tpu_torch/serve``) against the
JAX package's, on the CPU, on the same weights.

The tiny f32 Llama's weights come from JAX's ``init_params`` through
``interop.llama_params_from_jax``; traffic comes from numpy seeds, drawn
the same way in both packages.  Held here:

- the JAX package's own serving tests (``tests/test_serve.py``) on the
  port's side: the allocator, the pool, admission, greedy paged decode
  equal to ``generate`` token for token (mid-flight admission included),
  disaggregated prefill, front-end failover, registration, the soak;
- greedy tokens of the port's engine and ``generate`` equal to JAX's
  ``generate``, and ``run_load`` giving JAX's ``LoadReport``;
- the port's copies of what serving imports from the JAX package
  (``generate_traffic``, ``VirtualClock``, the flight recorder's journal);
- the port's CLI.

The decode step captured as a CUDA graph is checked by the ``cuda`` test
at the end, on a card (``python -m pytest -m cuda tests/test_torch_serve.py``).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.analysis import schedules as jax_schedules
    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.models import llama_decode as jax_decode
    from deeplearning_cfn_tpu.obs import exporter as jax_exporter
    from deeplearning_cfn_tpu.obs import recorder as jax_recorder
    from deeplearning_cfn_tpu import serve as jax_serve
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import cli, interop  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, llama_decode  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater  # noqa: E402
from deeplearning_cfn_tpu_torch.serve import (  # noqa: E402
    BlockAllocator,
    ContinuousBatchingEngine,
    ServeAdmissionError,
    ServeConfig,
    ServeFrontEnd,
    ServeReplica,
    ServeRequest,
    TrafficConfig,
    generate_traffic,
    init_paged_cache,
    plan_placement,
    run_load,
)
from deeplearning_cfn_tpu_torch.serve import engine as engine_mod  # noqa: E402

torch.set_num_threads(1)

CFG = llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
SCFG = ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
CPU = torch.device("cpu")

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


@pytest.fixture(scope="module")
def jax_weights():
    """(JAX config, JAX params) of the tiny f32 Llama, seed 0."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=jnp.float32)
    return jcfg, jax_llama.init_params(jcfg, jax.random.key(0))


@pytest.fixture(scope="module")
def model():
    """The port's tiny f32 Llama on the CPU: JAX's weights where JAX is
    installed, else the port's own seed-0 weights."""
    if jax is None:
        return llama.init_model(CFG, seed=0, device="cpu")
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=jnp.float32)
    params = jax_llama.init_params(jcfg, jax.random.key(0))
    m = llama.Llama(CFG)
    m.load_state_dict(interop.llama_params_from_jax(CFG, jax.device_get(params)))
    return m


def make_engine(model, scfg=SCFG, clock=None, **kw):
    return ContinuousBatchingEngine(model, scfg, clock=clock or (lambda: 0.0), journal=False, **kw)


def drain(engine_or_frontend):
    step = getattr(engine_or_frontend, "step_all", None) or engine_or_frontend.step
    out = {}
    while engine_or_frontend.pending():
        for c in step():
            out[c.request_id] = c
    return out


# --- block allocator and pool --------------------------------------------------


def test_allocator_is_all_or_nothing_and_lowest_first():
    alloc = BlockAllocator(8)
    assert alloc.allocate(3) == [0, 1, 2]
    assert alloc.allocate(6) is None  # only 5 left: nothing handed out
    assert alloc.free_blocks == 5
    assert alloc.allocate(5) == [3, 4, 5, 6, 7]


def test_allocator_recycles_deterministically():
    alloc = BlockAllocator(8)
    a = alloc.allocate(4)
    b = alloc.allocate(4)
    alloc.free(a)
    assert alloc.recycled == 4
    assert alloc.allocate(2) == [0, 1]  # freed pages come back lowest id first
    alloc.free(b)
    assert alloc.allocate(3) == [2, 3, 4]


def test_allocator_rejects_double_free_and_bad_ids():
    alloc = BlockAllocator(4)
    blocks = alloc.allocate(2)
    alloc.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        alloc.free([blocks[0]])
    with pytest.raises(ValueError, match="outside pool"):
        alloc.free([99])
    with pytest.raises(ValueError, match="outside pool"):
        alloc.free([4])  # the sink page's id is never handed out, nor taken back


def test_paged_cache_pool_shape_and_sink_page():
    """JAX's pool is [L, num_blocks, ...]; the port's has one page more, the
    sink that takes dropped writes, and reports the usable count."""
    cache = init_paged_cache(CFG, num_blocks=6, block_size=4, device="cpu")
    assert cache.k.shape == (CFG.n_layers, 7, 4, CFG.n_kv_heads, CFG.head_dim)
    assert cache.v.shape == cache.k.shape and cache.k.dtype == torch.float32
    assert cache.num_blocks == 6 and cache.block_size == 4 and cache.sink == 6


def test_inactive_slots_write_only_the_sink_page(model):
    """One active slot among four: its token lands at (table[len // bs],
    len % bs) and every other usable page keeps its bytes."""
    cache = init_paged_cache(CFG, num_blocks=8, block_size=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
    before_k, before_v = cache.k.clone(), cache.v.clone()
    tables = torch.zeros(4, 2, dtype=torch.int64)
    tables[2] = torch.tensor([5, 3])
    lengths = torch.tensor([0, 0, 6, 0])
    active = torch.tensor([False, False, True, False])
    tokens = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    engine_mod.paged_decode_step(model, cache, tokens, lengths, tables, active)
    changed = (cache.k != before_k).flatten(3).any(-1) | (cache.v != before_v).flatten(3).any(-1)
    # [L, pages, offsets]: page 3 offset 2 (position 6 of slot 2) and the sink.
    expect = torch.zeros_like(changed)
    expect[:, 3, 2] = True
    expect[:, cache.sink, 0] = True
    assert torch.equal(changed, expect)


# --- admission ---------------------------------------------------------------


def test_admission_rejects_unservable_requests(model):
    engine = make_engine(model)
    with pytest.raises(ServeAdmissionError, match="prefill_len"):
        engine.submit(ServeRequest("a", np.arange(17, dtype=np.int32), 1))
    with pytest.raises(ServeAdmissionError, match="max context"):
        engine.submit(ServeRequest("b", np.arange(16, dtype=np.int32), 18))
    with pytest.raises(ServeAdmissionError, match="max_new_tokens"):
        engine.submit(ServeRequest("c", np.arange(4, dtype=np.int32), 0))
    with pytest.raises(ServeAdmissionError, match="non-empty"):
        engine.submit(ServeRequest("d", np.zeros(0, np.int32), 2))
    assert engine.queue_depth == 0  # nothing half-accepted


def test_admission_backpressure_bounds_the_queue(model):
    engine = make_engine(model, dataclasses.replace(SCFG, max_queue=2))
    engine.submit(ServeRequest("a", np.arange(4, dtype=np.int32), 2))
    engine.submit(ServeRequest("b", np.arange(4, dtype=np.int32), 2))
    with pytest.raises(ServeAdmissionError, match="queue full"):
        engine.submit(ServeRequest("c", np.arange(4, dtype=np.int32), 2))
    assert engine.rejected == 1


def test_engine_refuses_a_prefill_longer_than_its_context(model):
    with pytest.raises(ValueError, match="exceeds max context"):
        make_engine(model, dataclasses.replace(SCFG, prefill_len=40))


# --- parity --------------------------------------------------------------------


def parity_setup(model):
    # max_context (block_size * blocks_per_slot = 16) equals generate's
    # max_seq (prompt 8 + 8 new), so both paths reduce attention over the
    # same extent: the condition for equal tokens, not just close logits.
    scfg = ServeConfig(num_slots=2, block_size=4, blocks_per_slot=4, prefill_len=8)
    prompts = np.random.default_rng(0).integers(0, 64, size=(2, 8)).astype(np.int32)
    ref = llama_decode.generate(model, torch.from_numpy(prompts), max_new_tokens=8).numpy()
    return scfg, prompts, ref


def test_paged_decode_equals_generate(model):
    """Slot-written paged cache == the whole-generation path, greedy."""
    scfg, prompts, ref = parity_setup(model)
    engine = make_engine(model, scfg)
    engine.submit(ServeRequest("r0", prompts[0], 8))
    engine.submit(ServeRequest("r1", prompts[1], 8))
    done = drain(engine)
    np.testing.assert_array_equal(np.stack([done["r0"].tokens, done["r1"].tokens]), ref)


def test_parity_survives_mid_flight_admission(model):
    """The second request joins an in-flight decode batch and still matches
    the undisturbed reference."""
    scfg, prompts, ref = parity_setup(model)
    engine = make_engine(model, scfg)
    engine.submit(ServeRequest("r0", prompts[0], 8))
    done = {}
    for i in range(64):
        if i == 3:
            engine.submit(ServeRequest("r1", prompts[1], 8))
        for c in engine.step():
            done[c.request_id] = c
        if i >= 3 and not engine.pending():
            break
    np.testing.assert_array_equal(np.stack([done["r0"].tokens, done["r1"].tokens]), ref)


@needs_jax
def test_engine_and_generate_equal_jax_generate(model, jax_weights):
    """Greedy tokens of the port's engine and generate equal JAX's generate
    on the same weights."""
    jcfg, jparams = jax_weights
    scfg, prompts, ref = parity_setup(model)
    j_ref = jax_decode.generate(jcfg, jparams, jnp.asarray(prompts), jax.random.key(1),
                                max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(ref, np.asarray(j_ref))
    engine = make_engine(model, scfg)
    for i in range(2):
        engine.submit(ServeRequest(f"r{i}", prompts[i], 8))
    done = drain(engine)
    np.testing.assert_array_equal(np.stack([done["r0"].tokens, done["r1"].tokens]),
                                  np.asarray(j_ref))


# --- the soak ------------------------------------------------------------------


def test_soak_200_requests_one_decode_signature(model, monkeypatch):
    """200 mixed-length requests through one ServeReplica: every decode call
    sees the same input shapes, dtypes and devices (on the card, the
    signature of the one captured graph), and every page comes back."""
    signatures = set()
    step = engine_mod.paged_decode_step

    def recording_step(model, cache, *inputs, **kw):
        signatures.add(tuple((tuple(t.shape), t.dtype, t.device.type)
                             for t in (cache.k, cache.v, *inputs[:4])))
        return step(model, cache, *inputs, **kw)

    monkeypatch.setattr(engine_mod, "paged_decode_step", recording_step)
    scfg = ServeConfig(num_slots=8, block_size=4, blocks_per_slot=8, prefill_len=16)
    clock = VirtualClock()
    replica = ServeReplica(make_engine(model, scfg, clock=clock), "soak0")
    report = run_load(
        replica,
        TrafficConfig(requests=200, seed=0, prompt_len_range=(1, 16), output_len_range=(1, 16)),
        clock,
    )
    assert report.completed == 200
    assert len(signatures) == 1, signatures
    snap = replica.engine.snapshot()
    assert snap["free_blocks"] == scfg.resolved_num_blocks  # every page recycled
    assert snap["recycled_blocks"] > 0
    assert snap["decode_captures"] == 0  # the CPU decodes eagerly


@needs_jax
@pytest.mark.parametrize("seed,requests", [(0, 200), (3, 40)])
def test_run_load_reproduces_the_jax_load_report(model, jax_weights, seed, requests):
    """Same traffic seed, same weights: the same report (completions, steps,
    virtual-clock quantiles) and the same tokens as the JAX run_load."""
    jcfg, jparams = jax_weights
    tcfg = TrafficConfig(requests=requests, seed=seed)
    clock = VirtualClock()
    got = run_load(make_engine(model, clock=clock), tcfg, clock)
    jscfg = jax_serve.ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
    jclock = jax_schedules.VirtualClock()
    jengine = jax_serve.ContinuousBatchingEngine(jcfg, jparams, jscfg, clock=jclock,
                                                 journal=False)
    ref = jax_serve.run_load(jengine, jax_serve.TrafficConfig(requests=requests, seed=seed),
                             jclock)
    assert got.to_dict() == ref.to_dict()
    assert got.completions == ref.completions


def test_loadgen_is_deterministic_per_seed(model):
    tcfg = TrafficConfig(requests=40, seed=3)
    clock_a, clock_b = VirtualClock(), VirtualClock()
    a = run_load(make_engine(model, clock=clock_a), tcfg, clock_a)
    b = run_load(make_engine(model, clock=clock_b), tcfg, clock_b)
    assert a.to_dict() == b.to_dict()
    assert a.completions == b.completions
    clock_c = VirtualClock()
    c = run_load(make_engine(model, clock=clock_c), TrafficConfig(requests=40, seed=4), clock_c)
    assert c.completions != a.completions  # the seed is live


# --- front-end and replicas --------------------------------------------------------


def test_frontend_failover_loses_nothing_and_outputs_match(model):
    tcfg = TrafficConfig(requests=50, seed=5)
    ref_clock = VirtualClock()
    reference = run_load(make_engine(model, clock=ref_clock), tcfg, ref_clock)
    clock = VirtualClock()
    frontend = ServeFrontEnd(
        [ServeReplica(make_engine(model, clock=clock), f"rep{i}") for i in range(2)]
    )
    killed = []

    def chaos(step):
        if step == 20 and not killed:
            killed.append(frontend.fail_replica("rep0"))

    live = run_load(frontend, tcfg, clock, on_step=chaos)
    assert live.completed == tcfg.requests
    assert frontend.lost_requests() == []
    assert frontend.failed == ["rep0"] and killed[0] > 0
    assert live.completions == reference.completions  # failover is invisible in outputs


def test_frontend_pool_resize_and_instance_loss(model):
    clock = VirtualClock()
    frontend = ServeFrontEnd([ServeReplica(make_engine(model, clock=clock), "rep0")])
    frontend.add_replica(ServeReplica(make_engine(model, clock=clock), "rep1"))
    with pytest.raises(ValueError, match="already in pool"):
        frontend.add_replica(ServeReplica(make_engine(model, clock=clock), "rep1"))
    for i in range(4):
        frontend.submit(ServeRequest(f"r{i}", np.arange(1, 5, dtype=np.int32), 3))
    assert frontend.retire_replica("rep1") is None  # busy: refused without force
    assert frontend.retire_replica("rep1", force=True).name == "rep1"
    frontend.submit(ServeRequest("r4", np.arange(1, 5, dtype=np.int32), 3))
    frontend.add_replica(ServeReplica(make_engine(model, clock=clock), "rep2"))
    frontend.on_instance_loss(None, type("Event", (), {"instance_id": "serve/rep0"})())
    assert frontend.failed == ["rep0"] and sorted(frontend.replicas) == ["rep2"]
    drain(frontend)
    assert frontend.lost_requests() == []
    assert sorted(frontend.completions) == [f"r{i}" for i in range(5)]


def test_disaggregated_prefill_matches_colocated(model):
    """Two CPU "devices": prefill through prefill_kv, the K/V handed over and
    scattered into the pool; the same greedy tokens as colocated."""
    placement = plan_placement([CPU, CPU])
    assert placement.disaggregated
    assert placement.describe() == {"disaggregated": True, "prefill_devices": ["cpu"],
                                    "decode_devices": ["cpu"]}
    assert not plan_placement([CPU]).disaggregated
    tcfg = TrafficConfig(requests=20, seed=6)
    clock_a = VirtualClock()
    colocated = run_load(make_engine(model, clock=clock_a), tcfg, clock_a)
    clock_b = VirtualClock()
    engine = make_engine(model, clock=clock_b, placement=placement)
    disagg = run_load(engine, tcfg, clock_b)
    assert disagg.completions == colocated.completions
    assert engine.kv_transfer_bytes > 0  # the prefill K/V moved
    assert engine.snapshot()["disaggregated"] is True


def test_plan_placement_defaults_to_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_placement()


def test_replica_registers_in_broker_kv(model):
    replica = ServeReplica(make_engine(model), "rep0", group="g")

    class KV:
        def __init__(self):
            self.table = {}

        def set(self, key, value):
            self.table[key] = value

    kv = KV()
    replica.register(kv)
    payload = json.loads(kv.table["serve/g/rep0"])
    assert payload == {"name": "rep0", "group": "g", "num_slots": SCFG.num_slots,
                       "max_context": SCFG.max_context, "prefill_len": SCFG.prefill_len}


def test_replica_beats_through_its_connection_factory(model):
    class Conn:
        def __init__(self, fail=False):
            self.beats, self.fail, self.closed = [], fail, False

        def heartbeat(self, worker_id):
            if self.fail:
                raise ConnectionError("broker gone")
            self.beats.append(worker_id)

        def close(self):
            self.closed = True

    conns = [Conn(fail=True), Conn()]
    replica = ServeReplica(make_engine(model), "rep0", group="g",
                           connection_factory=lambda: conns.pop(0))
    bad = conns[0]
    assert replica.beat() is False and bad.closed  # a failed beat drops its connection
    good = conns[0]
    assert replica.beat() is True and replica.beat() is True
    assert good.beats == ["g/rep0", "g/rep0"] and replica.heartbeater.beats_sent == 2
    assert ServeReplica(make_engine(model), "solo").beat() is False


def test_unported_broker_paths_raise(model):
    with pytest.raises(NotImplementedError, match="broker client"):
        ServeReplica(make_engine(model), "rep0", broker_host="localhost", broker_port=1)
    with pytest.raises(NotImplementedError, match="telemetry"):
        Heartbeater("", 0, "w", connection_factory=object, telemetry_source=lambda: {})


# --- the port's copies of JAX-package modules ----------------------------------------


@needs_jax
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_traffic_equals_jax(seed):
    kw = dict(requests=50, seed=seed, prompt_len_range=(3, 40), output_len_range=(2, 30),
              vocab_size=1000)
    got = generate_traffic(TrafficConfig(**kw))
    ref = jax_serve.generate_traffic(jax_serve.TrafficConfig(**kw))
    assert [r.request_id for r in got] == [r.request_id for r in ref]
    assert [r.arrival_s for r in got] == [r.arrival_s for r in ref]
    assert [r.max_new_tokens for r in got] == [r.max_new_tokens for r in ref]
    for a, b in zip(got, ref):
        assert a.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)


@needs_jax
def test_virtual_clock_equals_jax():
    ours, theirs = VirtualClock(1.5), jax_schedules.VirtualClock(1.5)
    for dt in (0.0, 0.25, 3.0, 1e-3):
        assert ours.advance(dt) == theirs.advance(dt)
        assert ours() == theirs() == ours.now()
    for clock in (ours, theirs):
        with pytest.raises(ValueError, match="backwards"):
            clock.advance(-1.0)


@needs_jax
def test_journal_reads_back_through_the_jax_reader(model, tmp_path):
    """The port's journal is the JAX package's format: its read_journal and
    fold_serve_events read a journal the port wrote."""
    path = tmp_path / "journal.jsonl"
    rec = recorder.configure(path)
    try:
        engine = ContinuousBatchingEngine(model, SCFG, clock=VirtualClock(), name="rep0")
        engine.submit(ServeRequest("r0", np.arange(1, 6, dtype=np.int32), 3))
        drain(engine)
        snap = engine.journal_metrics()
        rec.record("odd", value=float("nan"), arr=np.float32(2.5), nested={"x": [1, float("inf")]})
    finally:
        recorder.configure(None)
    ours = list(recorder.read_journal(path))
    theirs = list(jax_recorder.read_journal(path))
    assert ours == theirs and [e["kind"] for e in ours] == ["serve_metrics", "odd"]
    assert ours[1]["value"] is None and ours[1]["arr"] == 2.5 and ours[1]["nested"] == {
        "x": [1, None]}
    folded = jax_exporter.fold_serve_events(theirs)
    assert set(folded) == {"rep0"}
    for key, value in folded["rep0"].items():
        assert value == snap[key], key
    assert folded["rep0"]["completed"] == 1 and folded["rep0"]["free_blocks"] == 32


def test_recorder_rotates_and_reads_in_order(tmp_path):
    path = tmp_path / "j.jsonl"
    rec = recorder.FlightRecorder(path, max_events=3, max_file_lines=2)
    for i in range(5):
        rec.record("e", i=i)
    rec.close()
    assert [e["i"] for e in rec.tail(10)] == [2, 3, 4]  # the ring keeps the last three
    assert [e["i"] for e in recorder.read_journal(path)] == [2, 3, 4]
    assert [e["i"] for e in recorder.read_journal(path, limit=2)] == [3, 4]


# --- the CLI -------------------------------------------------------------------------


def test_cli_serve_on_cpu_completes_every_request(capsys):
    assert cli.main(["serve", "--device", "cpu", "--requests", "30", "--replicas", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"] == report["completed"] == 30


@needs_jax
def test_cli_serve_report_matches_dlcfn_serve(capsys):
    """The same scheduling on a virtual clock: the JAX CLI's report."""
    from deeplearning_cfn_tpu.cli import main as jax_main

    args = ["serve", "--requests", "25", "--seed", "2"]
    assert jax_main(args) == 0
    ref = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == ref


def test_cli_serve_refuses_the_broker_and_a_missing_card(monkeypatch):
    with pytest.raises(NotImplementedError, match="later slice"):
        cli.main(["serve", "--device", "cpu", "--broker", "localhost:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--requests", "1"])


# --- on the card ---------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_decode_equals_eager_decode_on_card(cuda_device):
    """A tiny bf16 engine on the card: decode is captured once, and one
    replayed step gives the eager step's tokens and pool bytes exactly; an
    inactive slot's write lands in the sink page alone."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    model = llama.init_model(cfg, seed=0, device=cuda_device)
    scfg = ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
    engine = ContinuousBatchingEngine(model, scfg, clock=VirtualClock(), journal=False)
    assert engine.decode_captures == 1
    for i, n in enumerate((5, 9, 3)):  # three of four slots active
        engine.submit(ServeRequest(f"r{i}", np.arange(1, n + 1, dtype=np.int32), 20))
    for _ in range(3):
        engine.step()
    inputs = engine.decode_inputs()
    assert inputs[3].tolist() == [True, True, True, False]
    pool = (engine.cache.k.clone(), engine.cache.v.clone())
    eager_cache = type(engine.cache)(k=pool[0].clone(), v=pool[1].clone())
    eager, _ = engine_mod.paged_decode_step(
        model, eager_cache, *(torch.from_numpy(a).to(cuda_device) for a in inputs))
    replayed = engine.decode(inputs)
    torch.cuda.synchronize()
    assert np.array_equal(replayed, eager.cpu().numpy())
    assert torch.equal(engine.cache.k, eager_cache.k) and torch.equal(engine.cache.v, eager_cache.v)
    changed = ((engine.cache.k != pool[0]).flatten(2).any(-1)
               | (engine.cache.v != pool[1]).flatten(2).any(-1))
    pages = sorted({int(p) for p in changed.nonzero()[:, 1]})
    owned = {int(inputs[2][i][inputs[1][i] // scfg.block_size]) for i in range(3)}
    assert set(pages) - owned <= {engine.cache.sink}
    assert engine.decode_captures == 1
