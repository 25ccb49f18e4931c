"""The port's cluster spec and template renderer against the JAX package's,
on the CPU.

``config/schema.py`` and ``config/template.py`` are copies: every committed
template renders to the same ``to_dict()`` under the same parameters, every
validation and template error gives the same type and message, and a spec
survives ``to_json``/``from_dict`` the same way.  Nothing here computes in
floating point, so the comparisons are exact.
"""

import json
from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.config import schema as jschema
    from deeplearning_cfn_tpu.config import template as jtemplate
except ImportError:  # the card's host has no JAX package to compare with
    jschema = jtemplate = None

from deeplearning_cfn_tpu_torch.config import schema, template  # noqa: E402

pytestmark = pytest.mark.skipif(jschema is None, reason="needs the JAX package, the reference")

REPO = Path(__file__).resolve().parent.parent
TEMPLATES = sorted((REPO / "templates").glob("*.json"))


def _outcome(fn):
    """``("ok", value)`` or ``("error", exception type name, message)``."""
    try:
        return ("ok", fn())
    except (ValueError, KeyError, TypeError) as e:
        return ("error", type(e).__name__, str(e))


def _both(call):
    """``call(schema_module, template_module)`` on the JAX side and the port's."""
    return (_outcome(lambda: call(jschema, jtemplate)),
            _outcome(lambda: call(schema, template)))


def test_five_templates_are_committed():
    assert [p.name for p in TEMPLATES] == [
        "detection-cluster-private.json", "detection-cluster.json", "local.json",
        "multislice-cluster.json", "v5p-cluster.json"]


# The parameters each committed template requires (no default).
REQUIRED = {"local": {},
            "detection-cluster-private": {"Project": "example-project", "Network": "vpc-1",
                                          "Subnetwork": "subnet-1"}}


@pytest.mark.parametrize("given", [False, True], ids=["defaults", "required"])
@pytest.mark.parametrize("path", TEMPLATES, ids=lambda p: p.stem)
def test_committed_template_renders_as_jax(path, given):
    params = REQUIRED.get(path.stem, {"Project": "example-project"}) if given else {}

    def render(s, t):
        spec = t.render_template_file(path, dict(params))
        return spec.to_dict(), spec.pool.total_chips, spec.pool.num_workers
    jax_side, port = _both(render)
    assert port == jax_side
    if given:  # every committed template renders once its required parameters are given
        assert port[0] == "ok"


SPEC_CASES = {
    "default": {},
    "bad-accelerator": {"pool": {"accelerator_type": "p3.16xlarge"}},
    "bad-name": {"name": "Bad Name!"},
    "bad-backend": {"backend": "aws"},
    "gcp-without-project": {"backend": "gcp"},
    "min-workers-high": {"pool": {"accelerator_type": "local-4", "min_workers": 9}},
    "min-workers-zero": {"pool": {"accelerator_type": "local-4", "min_workers": 0}},
    "no-workers": {"pool": {"accelerator_type": "local-1", "workers": 0}},
    "slices-zero": {"pool": {"accelerator_type": "local-1", "slices": 0}},
    "min-slices-high": {"pool": {"accelerator_type": "local-1", "slices": 2, "min_slices": 3}},
    "spot-and-reserved": {"pool": {"accelerator_type": "local-1", "spot": True,
                                   "reserved": True}},
    "small-disk": {"pool": {"accelerator_type": "local-1", "disk_size_gb": 5}},
    "bad-disk-type": {"pool": {"accelerator_type": "local-1", "disk_type": "nvme"}},
    "bad-storage-kind": {"storage": {"kind": "efs"}},
    "relative-mount": {"storage": {"kind": "local", "mount_point": "mnt"}},
    "byo-network-unnamed": {"network": {"create": False}},
    "staging-without-bucket": {"staging": {"datasets": ["coco.tar"]}},
    "suspicious-pip": {"setup": {"pip_packages": ["numpy; rm -rf /"]}},
    "ready-under-launch": {"timeouts": {"cluster_ready_s": 10.0,
                                       "controller_launch_s": 600.0}},
    "zero-poll": {"timeouts": {"poll_interval_s": 0}},
    "batch-indivisible": {"pool": {"accelerator_type": "local-8"},
                          "job": {"global_batch_size": 100}},
    "odd-workers": {"pool": {"accelerator_type": "local-1", "workers": 3},
                    "job": {"require_even_workers": True, "global_batch_size": 3}},
    "multislice": {"pool": {"accelerator_type": "local-4", "slices": 2, "min_slices": 1},
                   "job": {"global_batch_size": 64}},
    "full": {"name": "trip", "pool": {"accelerator_type": "local-8", "min_workers": 4},
             "storage": {"kind": "local", "mount_point": "/mnt/x", "existing_id": "fs-1"},
             "staging": {"bucket": "b", "datasets": ["d.tar"], "code": ["c.tar"]},
             "setup": {"pip_packages": ["numpy==2.0"], "commands": ["echo hi"],
                       "activate_env": "/srv/env"},
             "timeouts": {"cluster_ready_s": 100.0, "controller_launch_s": 10.0},
             "job": {"global_batch_size": 64, "args": {"steps": 3}}},
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_validates_as_jax(case):
    """The same verdict and, for a refusal, the same exception and message;
    an accepted spec's dict, JSON and round trip equal JAX's."""
    def check(s, t):
        spec = s.ClusterSpec.from_dict(json.loads(json.dumps(SPEC_CASES[case]))).validate()
        again = s.ClusterSpec.from_dict(json.loads(spec.to_json()))
        assert again == spec
        return (spec.to_dict(), spec.to_json(), spec.pool.total_workers,
                spec.timeouts.bootstrap_budget_s, spec.job.steps_per_epoch(spec.pool))
    jax_side, port = _both(check)
    assert port == jax_side


def test_accelerator_table_is_jax_s():
    assert schema.ALLOWED_ACCELERATOR_TYPES == jschema.ALLOWED_ACCELERATOR_TYPES


def test_schema_errors_are_config_errors():
    with pytest.raises(schema.ConfigError, match="accelerator_type"):
        schema.ClusterSpec(pool=schema.NodePool(accelerator_type="p3.16xlarge")).validate()
    assert issubclass(schema.ConfigError, ValueError)


TEMPLATE = {
    "Parameters": {
        "WorkerType": {"type": "str", "default": "local-8", "allowed": ["local-8", "v5p-32"]},
        "MinWorkers": {"type": "int", "default": 4, "min": 1, "max": 8},
        "StorageId": {"type": "str", "default": ""},
        "Zone": {"type": "str", "default": "us-central2-b"},
        "Spot": {"type": "bool", "default": False},
    },
    "Mappings": {
        "ZoneDefaults": {
            "us-central2-b": {"runtime": "tpu-ubuntu2204-base"},
            "europe-west4-b": {"runtime": "tpu-vm-v4-base"},
        }
    },
    "Conditions": {
        "CreateStorage": {"equals": [{"ref": "StorageId"}, ""]},
        "Reuse": {"not": {"equals": [{"ref": "StorageId"}, ""]}},
        "Europe": {"or": [{"equals": [{"ref": "Zone"}, "europe-west4-b"]}, False]},
        "SpotInEurope": {"and": [{"equals": [{"ref": "Spot"}, True]},
                                 {"equals": [{"ref": "Zone"}, "europe-west4-b"]}]},
    },
    "Cluster": {
        "name": "templated",
        "backend": "local",
        "pool": {
            "accelerator_type": {"ref": "WorkerType"},
            "min_workers": {"ref": "MinWorkers"},
            "runtime_version": {"find_in_map": ["ZoneDefaults", {"ref": "Zone"}, "runtime"]},
        },
        "storage": {
            "kind": "local",
            "existing_id": {"if": ["CreateStorage", None, {"ref": "StorageId"}]},
        },
        "job": {"global_batch_size": 64,
                "args": {"zone": {"if": ["Europe", "eu", "us"]},
                         "spot": {"if": ["SpotInEurope", "yes", "no"]},
                         "reuse": {"if": ["Reuse", 1, 0]}}},
    },
}

TEMPLATE_CASES = {
    "defaults": (TEMPLATE, {}),
    "overrides": (TEMPLATE, {"WorkerType": "v5p-32", "StorageId": "fs-0001",
                             "Zone": "europe-west4-b", "MinWorkers": "2", "Spot": "true"}),
    "disallowed": (TEMPLATE, {"WorkerType": "v6e-256"}),
    "unknown-parameter": (TEMPLATE, {"Nope": 1}),
    "below-min": (TEMPLATE, {"MinWorkers": "0"}),
    "above-max": (TEMPLATE, {"MinWorkers": "9"}),
    "not-an-int": (TEMPLATE, {"MinWorkers": "four"}),
    "unmapped-zone": (TEMPLATE, {"Zone": "mars-1"}),
    "required-missing": ({"Parameters": {"Req": {"type": "int"}}, "Cluster": {"name": "x"}}, {}),
    "undeclared-ref": ({"Cluster": {"name": {"ref": "Missing"}}}, {}),
    "unknown-condition": ({"Cluster": {"name": {"if": ["Nope", "a", "b"]}}}, {}),
    "bad-condition-op": ({"Conditions": {"C": {"xor": [1, 2]}},
                          "Cluster": {"name": "x"}}, {}),
    "no-cluster": ({"Parameters": {}}, {}),
}


@pytest.mark.parametrize("case", list(TEMPLATE_CASES))
def test_template_renders_as_jax(case):
    body, params = TEMPLATE_CASES[case]

    def render(s, t):
        return t.render_template(json.loads(json.dumps(body)), dict(params)).to_dict()
    jax_side, port = _both(render)
    assert port == jax_side


def test_parameters_resolve_as_jax():
    for params in ({}, {"Spot": "true", "MinWorkers": "3"}):
        assert (template.resolve_parameters(TEMPLATE, dict(params))
                == jtemplate.resolve_parameters(TEMPLATE, dict(params)))
