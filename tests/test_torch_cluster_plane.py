"""The port's cluster plane against the JAX package's, on the CPU, no card.

The control-plane modules the live reshard runs on are copies
(``provision/events``, ``cluster/queue``, ``provision/backend``,
``cluster/contract``, ``cluster/elasticity``, ``cluster/recovery``'s
``LiveReshardManager``, ``analysis/schedules.interleavings``,
``obs/tracing``, the reshard and mesh parts of ``obs/exporter`` and of the
``status`` and ``events`` commands); each test drives the copy and the
original on the same inputs and holds them equal, exactly (they compute no
floating point):

- the debouncer's flushes over the seeded ``interleavings`` of a terminate
  burst, for several seeds and windows;
- ``ClusterContract``: ``build``, ``surviving``, ``restored``, the derived
  views, the refusals with their messages, and the bytes ``write`` puts on
  disk;
- ``LiveReshardManager`` under duplicate and stale flushes and ``arm_restore``;
- ``rescale_grad_accum`` over a grid of (accum, old, new, symmetric);
- ``mesh_topology`` of the same layouts (the port's meshes over a fake
  process group of eight ranks, JAX's over the conftest's virtual devices);
- ``fold_reshard_events`` and ``render_prometheus`` text; ``_status_mesh``
  dicts; the ``status`` and ``events`` commands' output;
- the queue's at-least-once and visibility semantics, the event bus's
  isolation of a failing handler, span aggregates.
"""

import argparse
import json

import pytest

torch = pytest.importorskip("torch")

try:
    import jax  # noqa: F401

    from deeplearning_cfn_tpu import cli as jcli
    from deeplearning_cfn_tpu.analysis import schedules as jschedules
    from deeplearning_cfn_tpu.cluster import contract as jcontract
    from deeplearning_cfn_tpu.cluster import elasticity as jelasticity
    from deeplearning_cfn_tpu.cluster import queue as jqueue
    from deeplearning_cfn_tpu.cluster import recovery as jrecovery
    from deeplearning_cfn_tpu.obs import exporter as jexporter
    from deeplearning_cfn_tpu.parallel import mesh as jmesh
    from deeplearning_cfn_tpu.provision import events as jevents
    from deeplearning_cfn_tpu.train import reshard as jreshard
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import schedules  # noqa: E402
from deeplearning_cfn_tpu_torch.cluster import contract, elasticity, queue, recovery  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import exporter, tracing  # noqa: E402
from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import events  # noqa: E402
from deeplearning_cfn_tpu_torch.train import reshard  # noqa: E402
from deeplearning_cfn_tpu_torch.utils import timeouts  # noqa: E402

pytestmark = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


def _side(name: str):
    if name == "jax":
        return jevents, jelasticity, jcontract, jrecovery
    return events, elasticity, contract, recovery


class _Backend:
    def __init__(self, ev):
        self.events = ev.EventBus()


def _controller(side: str, clock, window_s: float = 10.0):
    ev, el, _, _ = _side(side)
    c = el.ElasticityController(backend=_Backend(ev), coordinator_queue_name="coord",
                                slice_loss_window_s=window_s, clock=clock)
    c.register(el.GroupPolicy("s0", 1, "sig-s0", coordinator=True))
    c.register(el.GroupPolicy("s1", 1, "sig-s1"))
    c.register(el.GroupPolicy("s2", 1, "sig-s2"))
    c.attach()
    return c


def _terminate(side: str, group: str, instance: str):
    ev = _side(side)[0]
    return ev.LifecycleEvent(kind=ev.EventKind.INSTANCE_TERMINATE, group=group,
                             instance_id=instance, detail={"reason": "preempted"})


# --- interleavings and the debouncer ------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 13])
def test_interleavings_equal_jax(seed):
    actions = ["term:h3", "term:h4", "term:h3", "tick", "tick", "term:h5"]
    assert schedules.interleavings(actions, 12, seed) == jschedules.interleavings(
        actions, 12, seed)


def _drive(side: str, schedule, window_s: float, tick_s: float):
    """The schedule on one side's controller: each action, then a flush."""
    clock = schedules.VirtualClock() if side == "port" else jschedules.VirtualClock()
    c = _controller(side, clock, window_s)
    fired = []
    c.on_slice_loss = lambda g, burst: fired.append((g, sorted(e.instance_id for e in burst)))
    trace = []
    for action in schedule:
        kind, _, arg = action.partition(":")
        if kind == "term":
            group, instance = arg.split("/")
            c.backend.events.publish(_terminate(side, group, instance))
        else:
            clock.advance(tick_s)
        trace.append((action, c.flush_slice_losses(), list(fired)))
    clock.advance(window_s)
    trace.append(("end", c.flush_slice_losses(), list(fired)))
    return trace, sorted(c.lost_instances)


@pytest.mark.parametrize("seed,window_s,tick_s", [(7, 10.0, 3.0), (11, 10.0, 3.0),
                                                   (13, 5.0, 3.0), (1, 4.0, 2.5),
                                                   (29, 0.0, 1.0)])
def test_debouncer_flushes_equal_jax(seed, window_s, tick_s):
    actions = ["term:s1/h3", "term:s1/h4", "term:s1/h3", "tick", "tick", "term:s2/h5",
               "tick"]
    for schedule in schedules.interleavings(actions, count=8, seed=seed):
        assert _drive("port", schedule, window_s, tick_s) == _drive(
            "jax", schedule, window_s, tick_s), schedule


def test_terminate_burst_coalesces_to_one_flush():
    """JAX's test_terminate_burst_coalesces_across_interleavings on the port."""
    actions = ["term:h3", "term:h4", "term:h3", "tick", "tick"]
    for schedule in schedules.interleavings(actions, count=10, seed=7):
        vclock = schedules.VirtualClock()
        c = _controller("port", vclock)
        fired = []
        c.on_slice_loss = lambda g, burst: fired.append((g, sorted(e.instance_id for e in burst)))
        for action in schedule:
            kind, _, arg = action.partition(":")
            if kind == "term":
                c.backend.events.publish(_terminate("port", "s1", arg))
            else:
                vclock.advance(3.0)
            c.flush_slice_losses()
        assert fired == [], schedule
        vclock.advance(10.0)
        assert c.flush_slice_losses() == ["s1"]
        assert fired == [("s1", ["h3", "h4"])], schedule


# --- the contract ---------------------------------------------------------------


def _contract(side: str, n_slices: int = 2, chips: int = 2, tags=None):
    ct = _side(side)[2]
    ips = [f"10.0.0.{i}" for i in range(1, 2 * n_slices + 1)]
    slices = {f"s{k}": ips[2 * k:2 * k + 2] for k in range(n_slices)}
    c = ct.ClusterContract.build(cluster_name="live", coordinator_ip="10.0.0.1",
                                 other_worker_ips=ips[1:][::-1], chips_per_worker=chips,
                                 storage_mount="/mnt/none", slices=slices)
    c.tags = dict(tags or {})
    return c


CONTRACT_CASES = {
    "two-slices": lambda c: c,
    "survive-s1": lambda c: c.surviving({"s1"}),
    "survive-s1-s2": lambda c: c.surviving({"s1", "s2", "ghost"}),
    "restore": lambda c: c.surviving({"s1"}).restored({"s1": ["10.0.0.4", "10.0.0.3"]}),
    "restore-degraded": lambda c: c.surviving({"s2"}).restored({"s9": ["10.0.9.1"]},
                                                               degraded=True),
}


@pytest.mark.parametrize("case,n_slices", [
    (case, n) for case in sorted(CONTRACT_CASES) for n in (2, 3)
    if n == 3 or case not in ("survive-s1-s2", "restore-degraded")])
def test_contract_derivations_and_files_equal_jax(case, n_slices, tmp_path):
    derive = CONTRACT_CASES[case]
    port = derive(_contract("port", n_slices, tags={"env": "test"}))
    ref = derive(_contract("jax", n_slices, tags={"env": "test"}))
    assert port.to_message() == ref.to_message()
    assert (port.workers_count, port.slices_count, port.total_chips, port.degraded) == (
        ref.workers_count, ref.slices_count, ref.total_chips, ref.degraded)
    assert port.slice_inventory() == ref.slice_inventory()
    assert port.hosts_entries() == ref.hosts_entries()
    assert port.datastream_hosts() == ref.datastream_hosts()
    port.write(tmp_path / "port")
    ref.write(tmp_path / "jax")
    for name in ("workers", "hosts", "env.sh", "contract.json"):
        assert (tmp_path / "port" / name).read_bytes().replace(b"/port/", b"/jax/") == (
            tmp_path / "jax" / name).read_bytes(), name
    back = contract.ClusterContract.read(tmp_path / "jax")
    assert back.to_message() == ref.to_message()
    assert contract.ClusterContract.from_message(ref.to_message()) == port


REFUSALS = {
    "coordinator-slice": lambda c: c.surviving({"s0"}),
    "not-a-slice": lambda c: c.surviving({"bogus"}),
    "nothing-survives": lambda c: c.surviving({"s0", "s1"}),
    "already-present": lambda c: c.restored({"s1": ["10.0.5.5"]}),
    "nothing-restored": lambda c: c.restored({}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_contract_refusals_equal_jax(case):
    messages = []
    for side in ("port", "jax"):
        with pytest.raises(ValueError) as err:
            REFUSALS[case](_contract(side))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_flat_contract_refuses_survivors_as_jax_does():
    for ct in (contract, jcontract):
        flat = ct.ClusterContract.build(cluster_name="flat", coordinator_ip="10.0.0.1",
                                        other_worker_ips=["10.0.0.2"], chips_per_worker=2,
                                        storage_mount="/mnt/none")
        with pytest.raises(ValueError, match="topology"):
            flat.surviving({"s1"})


# --- the manager ------------------------------------------------------------------


def _manager_trace(side: str):
    _, _, _, rec = _side(side)
    m = rec.LiveReshardManager(_contract(side))
    out = []
    m.on_slice_loss("s1", [_terminate(side, "s1", "a")])
    m.on_slice_loss("s1", [_terminate(side, "s1", "a")])  # duplicate flush
    m.on_slice_loss("ghost", [_terminate(side, "ghost", "z")])  # unknown
    out.append((sorted(m.lost_groups), m.needs_reshard, len(m.events)))
    survivor = m.surviving_contract()
    m.commit(survivor)
    out.append((survivor.to_message(), m.needs_reshard))
    m.on_slice_loss("s1", [_terminate(side, "s1", "a")])  # stale re-delivery
    out.append(m.needs_reshard)
    m.arm_restore("s1", ["10.0.0.4", "10.0.0.3"])
    m.arm_restore("s0", ["10.0.0.1"])  # already present: ignored
    out.append((dict(m.pending_restores), m.needs_reshard, m.surviving_contract().to_message()))
    return out


def test_live_reshard_manager_is_idempotent_as_jax():
    assert _manager_trace("port") == _manager_trace("jax")
    assert _manager_trace("port")[2] is False


def test_recovery_manager_names_its_slice(tmp_path):
    """The recreate-and-resume tier is ported (``tests/test_torch_recovery.py``
    holds it to JAX's), and so are agents on the VMs reached through the
    broker: ``remote_agents=True`` refuses a backend with no broker behind
    it with JAX's error, and takes a ``BrokerRendezvousBackend``."""
    from deeplearning_cfn_tpu.config import schema as jschema
    from deeplearning_cfn_tpu.provision import local as jlocal
    from deeplearning_cfn_tpu.provision import provisioner as jprovisioner

    from deeplearning_cfn_tpu_torch.cluster.broker_backend import BrokerRendezvousBackend
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerProcess
    from deeplearning_cfn_tpu_torch.config import schema
    from deeplearning_cfn_tpu_torch.provision import local
    from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner

    errors = []
    for sch, loc, prov, clock in ((schema, local, Provisioner, timeouts.FakeClock),
                                  (jschema, jlocal, jprovisioner.Provisioner,
                                   jtimeouts.FakeClock)):
        spec = sch.ClusterSpec(name="c", backend="local",
                               pool=sch.NodePool(accelerator_type="local-1", workers=1),
                               job=sch.JobSpec(global_batch_size=8))
        backend = loc.LocalBackend(clock=clock())
        assert prov(backend, spec, contract_root=tmp_path)
        with pytest.raises(ValueError) as err:
            prov(backend, spec, contract_root=tmp_path, remote_agents=True)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert recovery.RecoveryManager(Provisioner(backend := local.LocalBackend(
        clock=timeouts.FakeClock()), spec, contract_root=tmp_path))
    with BrokerProcess() as broker:
        remote = Provisioner(BrokerRendezvousBackend(backend, "127.0.0.1", broker.port), spec,
                             contract_root=tmp_path, remote_agents=True)
        assert remote.remote_agents and recovery.RecoveryManager(remote)


# --- rescale_grad_accum --------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("new", [0, 1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("old", [2, 4, 8])
@pytest.mark.parametrize("accum", [1, 2, 3])
def test_rescale_grad_accum_equals_jax(accum, old, new, symmetric):
    if new == 0:
        with pytest.raises(reshard.ReshardError):
            reshard.rescale_grad_accum(accum, old, new, symmetric=symmetric)
        with pytest.raises(jreshard.ReshardError):
            jreshard.rescale_grad_accum(accum, old, new, symmetric=symmetric)
        return
    assert reshard.rescale_grad_accum(accum, old, new, symmetric=symmetric) == (
        jreshard.rescale_grad_accum(accum, old, new, symmetric=symmetric))


# --- mesh_topology --------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of eight ranks in this process (no traffic):
    enough to build the port's meshes, whose topology is all that is read."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        pytest.skip("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


LAYOUTS = {  # name: (ici, dcn) MeshSpec kwargs; dcn None = a flat mesh
    "fsdp8": (dict(fsdp=8), None),
    "dp8": (dict(dp=8), None),
    "dp2-fsdp4": (dict(dp=2, fsdp=4), None),
    "fsdp2-tp4": (dict(fsdp=2, tp=4), None),
    "hybrid-2x-fsdp4": (dict(fsdp=4), dict(dp=2)),
    "hybrid-4x-fsdp2": (dict(fsdp=2), dict(dp=4)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_topology_equals_jax(layout, fake_world):
    from deeplearning_cfn_tpu_torch.parallel import mesh as pmesh

    ici, dcn = LAYOUTS[layout]
    devices = jmesh.virtual_cpu_devices(8)
    if dcn is None:
        ref = jmesh.build_mesh(jmesh.MeshSpec(**ici), devices)
        port = pmesh.build_mesh(pmesh.MeshSpec(**ici), device_type="cpu")
    else:
        n = dcn["dp"]
        ref = jmesh.hybrid_mesh_for_slices(n, ici_spec=jmesh.MeshSpec(**ici), dcn_axis="dp",
                                           devices=devices)
        port = pmesh.hybrid_mesh_for_slices(n, pmesh.MeshSpec(**ici), "dp", device_type="cpu")
    assert reshard.mesh_topology(port) == jreshard.mesh_topology(ref)


@pytest.mark.parametrize("ranks,kind", [([0, 1, 2, 3], "flat"), ([0, 1, 4, 5], "flat"),
                                         ([0, 1, 2, 3, 4, 5], "hybrid")])
def test_a_mesh_over_some_ranks_is_theirs_alone(ranks, kind, fake_world):
    """A survivors' mesh (``ranks=``): the rank grid of those ranks, each
    group among its own members, and the dp x fsdp data group made with them
    (``_flatten`` would make it over every rank of the default group)."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel import mesh as pmesh

    if kind == "flat":
        m = pmesh.build_mesh(pmesh.MeshSpec(dp=2, fsdp=2), device_type="cpu", ranks=ranks)
        grid = [[r] for r in ranks]
        assert pmesh.mesh_spec(m).axis_sizes() == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1,
                                                   "tp": 1, "ep": 1}
    else:
        m = pmesh.hybrid_mesh_for_slices(3, pmesh.MeshSpec(fsdp=2), "dp", device_type="cpu",
                                         ranks=ranks)
        grid = [[r] for r in ranks]
        assert pmesh.mesh_spec(m).axis_sizes()["dp"] == 3
    assert m.mesh.reshape(-1, 1).tolist() == grid
    assert reshard.mesh_topology(m)["devices"] == len(ranks)
    assert dist.get_process_group_ranks(pmesh.data_group(m)) == ranks
    assert pmesh.data_mesh(m).mesh.tolist() == ranks
    assert pmesh.data_rank(m) == (0, len(ranks))
    with pytest.raises(pmesh.MeshError, match="not in the mesh"):
        pmesh.build_mesh(pmesh.MeshSpec(fsdp=2), device_type="cpu", ranks=[6, 7])


def test_survivor_ranks_follow_the_launch_contract():
    origin = _contract("port", 3, chips=2)
    assert reshard.survivor_ranks(origin, origin.surviving({"s1"})) == [0, 1, 2, 3, 8, 9, 10, 11]
    assert reshard.survivor_ranks(origin, origin.surviving({"s1", "s2"})) == [0, 1, 2, 3]
    with pytest.raises(Exception, match="launch contract"):
        reshard.survivor_ranks(origin.surviving({"s2"}), origin)


def test_one_device_topology_equals_jax():
    ref = jmesh.build_mesh(jmesh.MeshSpec.fsdp_parallel(1), jmesh.virtual_cpu_devices(1))
    assert reshard.mesh_topology(None) == jreshard.mesh_topology(ref) == {"devices": 1,
                                                                         "axes": {}}


# --- exporter, status, events ------------------------------------------------------------

EVENT_SETS = {
    "one-each": [
        {"kind": "reshard", "step": 4, "seconds": 0.25, "grad_accum_after": 2},
        {"kind": "reshard_fallback", "step": 9, "reason": "x"},
        {"kind": "span", "span": "train_step"},
    ],
    "two-live": [
        {"kind": "reshard", "step": 3, "seconds": 0.125, "old_topology": {"devices": 8},
         "new_topology": {"devices": 4}, "grad_accum_before": 1, "grad_accum_after": 2},
        {"kind": "reshard", "step": 7, "seconds": 1.5, "grad_accum_before": 2,
         "grad_accum_after": 4},
    ],
    "fallback-only": [{"kind": "reshard_fallback", "step": 2, "reason": "forced"}],
    "none": [{"kind": "span"}, {"kind": "slice_lost"}],
}


@pytest.mark.parametrize("events_name", sorted(EVENT_SETS))
def test_fold_and_render_equal_jax(events_name):
    evs = EVENT_SETS[events_name]
    folded = exporter.fold_reshard_events(evs)
    assert folded == jexporter.fold_reshard_events(evs)
    mesh = {"slices": 1, "workers": 2, "chips_total": 4}
    spans = {"reshard": {"count": 1, "errors": 0, "total_s": 0.5, "max_s": 0.5, "last_s": 0.5,
                         "p50_s": 0.5, "p95_s": 0.5, "p99_s": 0.5},
             "train_step": {"count": 3, "errors": 0, "total_s": 1.0, "max_s": 0.5,
                            "last_s": 0.2}}
    for kw in (dict(reshard=folded, mesh=mesh, cluster="live"), dict(reshard=folded),
               dict(mesh=mesh, cluster='a"b'), dict(spans=spans, reshard=folded, cluster="c"),
               {}):
        assert exporter.render_prometheus(**kw) == jexporter.render_prometheus(**kw), kw
    if events_name == "one-each":
        text = exporter.render_prometheus(reshard=folded, mesh=mesh, cluster="live")
        assert 'dlcfn_reshard_total{cluster="live"} 1' in text
        assert 'dlcfn_mesh_chips_total{cluster="live"} 4' in text


@pytest.mark.parametrize("asked,published", [("live", "live"), ("other", "live"),
                                             ("", "live"), ("live", None)])
def test_status_mesh_equals_jax(asked, published, tmp_path, monkeypatch):
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path))
    if published is not None:
        c = _contract("port", 3).surviving({"s2"})
        c.write(tmp_path)
    args = argparse.Namespace(cluster=asked)
    assert cli._status_mesh(args) == jcli._status_mesh(args)


def _journal(path):
    rec = FlightRecorder(path)
    for ev in EVENT_SETS["one-each"] + EVENT_SETS["two-live"]:
        rec.record(ev["kind"], **{k: v for k, v in ev.items() if k != "kind"})
    for s in (0.5, 0.25, 0.125):
        rec.record("span", span="reshard", seconds=s, ok=True)
    rec.close()
    return path


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_status_command_equals_jax(fmt, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path))
    _contract("port").surviving({"s1"}).write(tmp_path)
    journal = str(_journal(tmp_path / "journal.jsonl"))
    argv = ["status", "--cluster", "live", "--journal", journal, "--format", fmt]
    assert cli.main(argv) == 0
    port = capsys.readouterr().out
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out
    if fmt == "prom":
        assert port == ref
        return
    # Both add the broker's liveness table, empty with no broker recorded.
    ref = json.loads(ref)
    assert ref["liveness"] == {}
    assert json.loads(port) == ref
    assert list(json.loads(port)) == list(ref)
    assert ref["reshard"]["total"] == 3 and ref["mesh"]["slices"] == 1


@pytest.mark.parametrize("argv", [["-n", "3"], ["--kind", "reshard"], ["-n", "2", "--kind",
                                                                        "span"]])
def test_events_command_equals_jax(argv, tmp_path, capsys):
    journal = str(_journal(tmp_path / "journal.jsonl"))
    assert cli.main(["events", "--journal", journal, *argv]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["events", "--journal", journal, *argv]) == 0
    assert port == capsys.readouterr().out and port


@pytest.mark.parametrize("flag", ["--metrics-dir", "--profile", "--serve", "--broker",
                                  "liveness"])
def test_status_sections_not_ported_name_their_slice(flag, tmp_path, monkeypatch, capsys):
    """The sections that once named the slice porting them now render as
    JAX's do: ``--metrics-dir`` (the workers' last records), ``--profile``
    and ``--serve`` (their journal folds), ``--broker`` (an unreachable
    broker exits with JAX's message) and the liveness families."""
    if flag == "liveness":
        live = {"w0": {"state": "alive", "age_s": 1.0, "beats": 2},
                "w1": {"state": "dead", "age_s": 90.0, "beats": 1}}
        text = exporter.render_prometheus(live, cluster="c")
        assert text == jexporter.render_prometheus(live, cluster="c")
        assert 'dlcfn_worker_up{cluster="c",worker="w1",state="dead"} 0' in text
        return
    if flag == "--broker":
        monkeypatch.delenv("DLCFN_BROKER_TOKEN", raising=False)
        argv = ["status", "--broker", "127.0.0.1:1"]
        errors = []
        for main in (cli.main, jcli.main):
            with pytest.raises(SystemExit) as err:
                main(argv)
            errors.append(str(err.value).split(":")[:3])
        assert errors[0] == errors[1] and "cannot reach broker" in errors[0][0]
        return
    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler

    rec = FlightRecorder(path=tmp_path / "j")
    clock = iter(i * 0.004 for i in range(100)).__next__
    prof = StepProfiler(name="train", clock=clock, recorder=rec)
    prof.start()
    for i in range(2):
        with prof.phase("dispatch"):
            pass
        prof.step_done(step=i)
    prof.journal()
    rec.record("serve_metrics", replica="r0", steps=3, queue_depth=1, active_slots=2,
               tokens_per_s=10.0, ttft_ms={"p50": 5.0, "p95": 6.0, "p99": 7.0})
    rec.close()
    argv = ["status", "--journal", str(tmp_path / "j"), flag]
    if flag == "--metrics-dir":
        (tmp_path / "run").mkdir()
        (tmp_path / "run" / "worker0.jsonl").write_text(json.dumps(
            {"event": "train_step", "step": 4, "loss": 1.5, "examples_per_sec": 12.0}) + "\n")
        argv.append(str(tmp_path))
    for fmt in ("json", "prom"):
        outs = []
        for main in (cli.main, jcli.main):
            assert main([*argv, "--format", fmt]) == 0
            outs.append(capsys.readouterr().out)
        # The metrics dir has no Prometheus family: an empty text on both.
        assert outs[0] == outs[1] and (outs[0] or (fmt, flag) == ("prom", "--metrics-dir"))
    body = json.loads(_json_status(argv, capsys))
    key = {"--metrics-dir": "workers", "--profile": "profile", "--serve": "serve"}[flag]
    assert body[key]


def _json_status(argv, capsys) -> str:
    assert cli.main(argv) == 0
    return capsys.readouterr().out


# --- queue, bus, spans ---------------------------------------------------------------------


def _queue_trace(side: str):
    q_mod, clock = (queue, timeouts.FakeClock()) if side == "port" else (
        jqueue, jtimeouts.FakeClock())
    q = q_mod.InMemoryQueue("coord", clock=clock)
    out = []
    q.duplicate_next_send = True
    out.append(q.send({"event": "group-setup", "group": "s0"}))
    out.append(q.send({"event": "group-setup", "group": "s1"}))
    got = q.receive(max_messages=10, visibility_timeout_s=60.0)
    out.append([(m.message_id, m.body, m.receipt, m.receive_count) for m in got])
    out.append(len(q.receive()))  # invisible
    clock.advance(61.0)
    again = q.receive(max_messages=2, visibility_timeout_s=0.0)
    out.append([(m.message_id, m.receipt, m.receive_count) for m in again])
    q.delete(again[0].receipt)
    q.delete("unknown")
    out.append(q.approximate_depth())
    return out


def test_queue_semantics_equal_jax():
    assert _queue_trace("port") == _queue_trace("jax")


def test_event_bus_isolates_a_failing_handler():
    for ev in (events, jevents):
        bus, seen = ev.EventBus(), []

        def broken(e):
            raise RuntimeError("full disk")

        bus.subscribe(broken)
        bus.subscribe(seen.append)
        bus.publish(ev.LifecycleEvent(kind=ev.EventKind.INSTANCE_TERMINATE, group="s1"))
        bus.unsubscribe(broken)
        bus.unsubscribe(broken)  # absent: no-op
        bus.publish(ev.LifecycleEvent(kind=ev.EventKind.ALERT, group="s1"))
        assert [e.kind.value for e in seen] == ["instance-terminate", "alert"]


def test_span_aggregates_fold_as_jax(tmp_path):
    from deeplearning_cfn_tpu.obs import tracing as jtracing

    rec = FlightRecorder(tmp_path / "j.jsonl")
    tracing.reset_aggregates()
    for ok in (True, True, False):
        try:
            with tracing.span("reshard", recorder=rec, step=3):
                if not ok:
                    raise ValueError("x")
        except ValueError:
            pass
    aggs = tracing.span_aggregates()["reshard"]
    assert (aggs["count"], aggs["errors"]) == (3, 1)
    assert set(aggs) == set(jtracing.SpanStats().as_dict())
    assert [e["ok"] for e in rec.tail()] == [True, True, False]
    assert rec.tail()[0]["step"] == 3
    tracing.reset_aggregates()
    assert tracing.span_aggregates() == {}
