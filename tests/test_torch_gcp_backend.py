"""The port's GCP backend and transport against the JAX package's, on the
CPU, with no network.

``provision/gcp.py`` and ``provision/gcp_transport.py`` are copies, and the
``--print-requests`` dry run of ``create``, ``describe``, ``delete`` and
``recover`` is ported with them:

- the transcripts equal the JAX package's goldens under
  ``tests/goldens/gcp_requests/``: ``describe`` and ``delete`` byte for
  byte, ``create`` and ``recover`` apart from the one module the worker
  startup script execs (the port's agent, ``deeplearning_cfn_tpu_torch.
  cluster.agent_main``, in place of the JAX package's);
- provisioning over ``FakeGCPTransport`` (healthy, degraded, storage
  create/retain/reuse, a fresh process adopting group records and signals)
  issues the same calls and comes to the same result as JAX's;
- ``GoogleAuthTransport`` over a scripted opener (routing, auth header,
  404, retries on 503 on a ``FakeClock``, 403, a refreshed token) sends the
  same requests and raises the same errors.
"""

import io
import json
import shutil
import urllib.error
from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.config import schema as jschema
    from deeplearning_cfn_tpu.provision import gcp as jgcp
    from deeplearning_cfn_tpu.provision import gcp_transport as jgcp_transport
    from deeplearning_cfn_tpu.provision import provisioner as jprovisioner
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host has no JAX package to compare with
    jschema = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.config import schema  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import gcp, gcp_transport, local  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import provisioner  # noqa: E402
from deeplearning_cfn_tpu_torch.utils import timeouts  # noqa: E402

needs_jax = pytest.mark.skipif(jschema is None, reason="needs the JAX package, the reference")

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "goldens" / "gcp_requests"
ARGS = [str(REPO / "templates" / "v5p-cluster.json"), "-P", "Project=example-project"]
JAX_AGENT = "deeplearning_cfn_tpu.cluster.agent_main"
PORT_AGENT = "deeplearning_cfn_tpu_torch.cluster.agent_main"


@pytest.mark.parametrize("op", ["create", "describe", "delete", "recover"])
def test_transcript_matches_the_golden(op, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path))
    assert cli.main([op, *ARGS, "--print-requests"]) == 0
    got = capsys.readouterr().out
    golden = (GOLDEN_DIR / f"{op}.json").read_text()
    assert golden.count(JAX_AGENT) == (1 if op in ("create", "recover") else 0)
    assert json.loads(got) == json.loads(golden.replace(JAX_AGENT, PORT_AGENT))
    assert not list(tmp_path.iterdir())  # a dry run writes no contract


def test_print_requests_refused_off_gcp(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path))
    with pytest.raises(SystemExit, match="gcp"):
        cli.main(["create", str(REPO / "templates" / "local.json"), "--print-requests"])


def test_no_network_transport_refuses():
    backend = gcp.GCPBackend(project="p", zone="z")
    with pytest.raises(RuntimeError, match="without a transport"):
        backend.create_group("g", 4, 4, 4)


@needs_jax
@pytest.mark.parametrize("token", [None, "tok-9"], ids=["open", "auth"])
def test_broker_host_names_its_slice(token):
    """``broker_host`` stamps the broker's address (and its AUTH token,
    when there is one) into every VM's metadata: the queued-resource
    request equals JAX's, apart from the agent module of the boot
    command."""
    bodies = []
    for mod in (gcp, jgcp):
        rec = mod.RecordingTransport(mod.FakeGCPTransport(workers=2, provision_polls=1),
                                     project="p")
        backend = mod.GCPBackend(project="p", zone="z", transport=rec,
                                 broker_host="10.0.0.2", broker_port=9001, broker_token=token,
                                 clock=(timeouts if mod is gcp else jtimeouts).FakeClock())
        backend.create_group("g-workers", 2, 2, 4)
        bodies.append(json.dumps(rec.requests))
    assert bodies[0] == bodies[1].replace(JAX_AGENT, PORT_AGENT)
    metadata = json.loads(bodies[0])[0]["body"]["queuedResource"]["tpu"]["nodeSpec"][0][
        "node"]["metadata"]
    assert metadata["dlcfn-broker"] == "10.0.0.2:9001"
    assert metadata.get("dlcfn-broker-token") == token


def test_inline_bootstrap_over_a_real_transport_is_flagged(tmp_path):
    spec = schema.ClusterSpec(name="g", backend="gcp", project="p", zone="z",
                              pool=schema.NodePool(accelerator_type="v5litepod-16"),
                              job=schema.JobSpec(global_batch_size=64))

    def flagged(backend):
        return provisioner.Provisioner(backend, spec, contract_root=tmp_path
                                       )._inline_bootstrap_is_simulation()

    assert flagged(gcp.GCPBackend(project="p", zone="z", transport=lambda m, p, b: {}))
    assert not flagged(gcp.GCPBackend(project="p", zone="z", transport=gcp.FakeGCPTransport()))
    assert not flagged(gcp.GCPBackend(project="p", zone="z"))
    assert not flagged(local.LocalBackend(clock=timeouts.FakeClock()))


# --- the backend over the fake transport, beside JAX's --------------------------


def _sides():
    return {"jax": (jschema, jgcp, jprovisioner, jtimeouts),
            "port": (schema, gcp, provisioner, timeouts)}


def _gcp_spec(s, workers=4, min_workers=None, batch=None):
    spec = s.ClusterSpec(
        name="gcp-test", backend="gcp", project="my-project", zone="us-central2-b",
        pool=s.NodePool(accelerator_type="v5litepod-16", workers=workers,
                        min_workers=min_workers),
        storage=s.StorageSpec(kind="gcs"),
        job=s.JobSpec(global_batch_size=batch or workers * 16))
    spec.timeouts.poll_interval_s = 0.01
    return spec


def _backend(g, t, spec, transport, clock):
    return g.GCPBackend(project=spec.project, zone=spec.zone, transport=transport,
                        accelerator_type=spec.pool.accelerator_type, clock=clock,
                        storage_namespace=spec.name)


SCENARIOS = {
    "healthy": (dict(workers=4), dict(workers=4, provision_polls=2)),
    "degraded": (dict(workers=4, min_workers=2, batch=48),
                 dict(workers=4, provision_polls=1, failed_workers={2})),
}


@needs_jax
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_provision_over_the_fake_cloud_as_jax(tmp_path, name):
    spec_kw, fake_kw = SCENARIOS[name]
    out = {}
    root = tmp_path / "opt-deeplearning"  # the same root, so env.sh's paths agree
    for side, (s, g, p, t) in _sides().items():
        spec = _gcp_spec(s, **spec_kw)
        transport = g.FakeGCPTransport(**fake_kw)
        clock = t.FakeClock()
        backend = _backend(g, t, spec, transport, clock)
        shutil.rmtree(root, ignore_errors=True)
        prov = p.Provisioner(backend, spec, contract_root=root)
        result = prov.provision()
        trace = [result.contract.to_message(), result.degraded, result.storage.storage_id,
                 prov.describe(), clock.now()]
        # A fresh process adopts the group record and reads the signal.
        fresh = _backend(g, t, spec, transport, t.FakeClock())
        trace.append(p.Provisioner(fresh, spec, contract_root=root).describe())
        trace.append(prov.delete())
        trace.append(p.Provisioner(_backend(g, t, spec, transport, t.FakeClock()), spec,
                                   contract_root=root).recover().storage.created)
        out[side] = (trace, list(transport.calls),
                     {f.name: f.read_bytes() for f in sorted(root.iterdir()) if f.is_file()})
    assert out["port"] == out["jax"]
    assert out["port"][0][1] is (name == "degraded")


@needs_jax
def test_storage_create_retain_and_reuse_as_jax():
    out = {}
    for side, (s, g, p, t) in _sides().items():
        transport = g.FakeGCPTransport()
        backend = g.GCPBackend(project="p", zone="z", transport=transport,
                               storage_namespace="nsdemo")
        trace = []
        for kind in ("gcs", "filestore"):
            h1 = backend.create_or_reuse_storage(kind, None, "/mnt/dlcfn", True)
            h2 = backend.create_or_reuse_storage(kind, None, "/mnt/dlcfn", True)
            trace += [(h1.storage_id, h1.created), (h2.storage_id, h2.created),
                      backend.delete_storage(h1.storage_id),
                      backend.storage_exists(h1.storage_id, kind),
                      backend.delete_storage(h1.storage_id, force=True)]
        with pytest.raises(KeyError) as e:
            backend.describe_group("never-made")
        trace.append(str(e.value))
        out[side] = (trace, list(transport.calls))
    assert out["port"] == out["jax"]


# --- GoogleAuthTransport over a scripted opener ----------------------------------


class _Response:
    def __init__(self, payload):
        self._data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()

    def read(self):
        return self._data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Opener:
    """Serves scripted responses in order (an error factory's error is raised) and
    records each request's method, URL, auth header and body."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.requests = []

    def __call__(self, req, timeout=None):
        self.requests.append((req.get_method(), req.full_url, req.get_header("Authorization"),
                              req.data))
        item = self.responses.pop(0)
        if callable(item):
            raise item()
        return _Response(item)


def _http_error(code):
    """A scripted HTTP error (made anew for each side: its body is read once)."""
    return lambda: urllib.error.HTTPError("https://x", code, "err", hdrs=None,
                                          fp=io.BytesIO(b"{}"))


TRANSPORT_CASES = {
    "tpu-routing": ([{"state": {"state": "ACTIVE"}}],
                    ("GET", "projects/my-project/locations/us-central2-b/queuedResources/q",
                     None)),
    "filestore": ([{}], ("POST", "projects/p/locations/z/instances?instanceId=fs1",
                         {"tier": "BASIC_SSD"})),
    "bucket-create": ([{"name": "bkt"}], ("POST", "b", {"name": "bkt", "location": "US"})),
    "object-write": ([{"name": "m"}], ("POST", "b/bkt/o?name=ready", {"signal": "SUCCESS"})),
    "object-read": ([{"signal": "SUCCESS"}], ("GET", "b/bkt/o/ready", None)),
    "404": ([_http_error(404)], ("GET", "b/bkt/o/missing", None)),
    "503-then-ok": ([_http_error(503), _http_error(503), {"ok": True}],
                    ("GET", "projects/p/locations/z/queuedResources/q", None)),
    "403": ([_http_error(403)], ("GET", "projects/p/locations/z/queuedResources/q", None)),
    "exhausted": ([_http_error(503)] * 5, ("DELETE", "projects/p/locations/z/nodes/n", None)),
    "401-refresh": ([_http_error(401), {"ok": True}],
                    ("GET", "projects/p/locations/z/queuedResources/q", None)),
}


@needs_jax
@pytest.mark.parametrize("case", list(TRANSPORT_CASES))
def test_transport_as_jax(case):
    responses, (method, path, body) = TRANSPORT_CASES[case]
    out = {}
    for side, mod, t in (("jax", jgcp_transport, jtimeouts), ("port", gcp_transport, timeouts)):
        tokens = []

        def provider():
            tokens.append(1)
            return (f"tok-{len(tokens)}", 1e18)

        clock = t.FakeClock()
        opener = _Opener(responses)
        transport = mod.GoogleAuthTransport(project="my-project", token_provider=provider,
                                            opener=opener, max_retries=2, backoff_s=0.5,
                                            clock=clock, seed=0)
        try:
            result = ("ok", transport(method, path, body))
        except (KeyError, RuntimeError) as e:
            result = (type(e).__name__, str(e), getattr(e, "status", None))
        out[side] = (result, opener.requests, len(tokens), clock.now(),
                     transport.resolve(method, path, body)[0])
    assert out["port"] == out["jax"]


# --- the GCS object store --------------------------------------------------------------


def _gcs_calls(mod) -> tuple:
    """One ``GCSObjectStore`` session over a transport that records every
    request and answers from an in-memory bucket (a missing object is
    ``KeyError``, as the transport seam raises for a 404)."""
    calls, bucket = [], {}

    def transport(method, path, body):
        calls.append((method, path, None if body is None else dict(body)))
        if method == "POST":
            bucket[path.rsplit("name=", 1)[1]] = body["data"]
            return {}
        obj = path.split("/o/", 1)[1] if "/o/" in path else None
        if obj is None:  # a listing
            prefix = path.rsplit("prefix=", 1)[1]
            return {"items": [{"name": k} for k in sorted(bucket) if k.startswith(prefix)]}
        key = obj.split("?", 1)[0]
        if key not in bucket:
            raise KeyError(key)
        return {"data": bucket[key]} if path.endswith("?alt=media") else {"name": key}

    store = mod.GCSObjectStore("stage-bucket", transport)
    store.put("runs/data.tar", b"\x00payload")
    store.put("runs/code.tar", b"code")
    out = [store.get("runs/data.tar"), store.exists("runs/code.tar"), store.exists("nope"),
           store.list("runs/"), store.list("other/")]
    return out, calls


@needs_jax
def test_gcs_object_store_requests_equal_jax():
    from deeplearning_cfn_tpu.provision import objectstore as jobjectstore

    from deeplearning_cfn_tpu_torch.provision import objectstore

    port = _gcs_calls(objectstore)
    assert port == _gcs_calls(jobjectstore)
    assert port[0] == [b"\x00payload", True, False, ["runs/code.tar", "runs/data.tar"], []]
    assert port[1][0][2]["size"] == 8 and len(port[1][0][2]["md5"]) == 32


def test_stage_hint_names_a_class_that_exists(capsys, monkeypatch, tmp_path):
    from deeplearning_cfn_tpu_torch.provision import objectstore

    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path))
    body = json.loads((REPO / "templates" / "v5p-cluster.json").read_text())
    body["Cluster"]["staging"] = {"bucket": "stage-bucket", "prefix": "runs"}
    template = tmp_path / "staged.json"
    template.write_text(json.dumps(body))
    with pytest.raises(SystemExit, match=r"Stager\(GCSObjectStore\(bucket, transport\)\)"):
        cli.main(["stage", str(template), *ARGS[1:]])
    assert callable(objectstore.GCSObjectStore)
