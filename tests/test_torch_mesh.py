"""The port's mesh and sharding rules against the JAX package's.

``MeshSpec``, ``AutoLayout`` and ``largest_pow2_dp`` are plain arithmetic
and must agree exactly; so must the fsdp dim each Llama parameter is
sharded on: from the explicit ``param_specs`` (the JAX spec less the stacked
layer axis) and from the FSDP rule (``_fsdp_spec_for_array`` on the conftest's
virtual CPU devices).  ``build_mesh`` is held on one gloo rank; meshes over
several ranks are held in ``test_torch_distributed.py``.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.parallel import mesh as jax_mesh  # noqa: E402
from deeplearning_cfn_tpu.parallel import sharding as jax_sharding  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel import mesh, sharding  # noqa: E402

torch.set_num_threads(1)

SPECS = [dict(), dict(dp=8), dict(fsdp=4, ep=2), dict(dp=2, fsdp=2, tp=2), dict(dp=0),
         dict(fsdp=3)]


@pytest.mark.parametrize("kw", SPECS)
def test_mesh_spec_matches_jax(kw):
    ours, ref = mesh.MeshSpec(**kw), jax_mesh.MeshSpec(**kw)
    assert ours.total == ref.total and ours.axis_sizes() == ref.axis_sizes()
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER
    for n in (1, 4, 8):
        try:
            ref.validate(n)
        except jax_mesh.MeshError as e:
            with pytest.raises(mesh.MeshError, match=str(e).split(" but ")[0]):
                ours.validate(n)
        else:
            assert ours.validate(n) is ours
    assert mesh.MeshSpec.data_parallel(4) == mesh.MeshSpec(**vars(jax_mesh.MeshSpec.data_parallel(4)))
    assert mesh.MeshSpec.fsdp_parallel(4) == mesh.MeshSpec(**vars(jax_mesh.MeshSpec.fsdp_parallel(4)))


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 64])
@pytest.mark.parametrize("param_bytes", [0, 10 << 20, 2 << 30, 40 << 30])
def test_auto_layout_and_pow2_dp_match_jax(n, param_bytes):
    ours = mesh.AutoLayout(n, param_bytes=param_bytes).choose()
    ref = jax_mesh.AutoLayout(n, param_bytes=param_bytes).choose()
    assert ours.axis_sizes() == ref.axis_sizes()
    assert mesh.largest_pow2_dp(n) == jax_mesh.largest_pow2_dp(n)


def _leaf_shapes(cfg) -> dict[str, tuple]:
    """The port's parameter names with their per-layer shapes."""
    return {n: tuple(p.shape) for n, p in llama.Llama(cfg).named_parameters()}


def _jax_spec(jspecs: dict, name: str):
    """The JAX spec of a port parameter name, less the stacked layer axis."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = jspecs["layers"]
        for key in parts[2:]:
            node = node[key]
        return tuple(node)[1:]
    return tuple(jspecs[name])


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_llama_fsdp_dims_match_param_specs(moe, fused):
    kw = dict(dtype=jnp.float32, n_experts=4 if moe else 0, fused_qkv=fused and not moe)
    jcfg = jax_llama.LlamaConfig.tiny(**kw)
    tcfg = llama.LlamaConfig.tiny(**{**kw, "dtype": torch.float32})
    jspecs = jax_llama.param_specs(jcfg)
    ours = llama.param_specs(tcfg)
    names = _leaf_shapes(tcfg)
    assert set(ours) == set(names)
    for name in names:
        ref = _jax_spec(jspecs, name)
        assert sharding.fsdp_dim(ours[name]) == sharding.fsdp_dim(ref), name
        assert sharding.axis_dim(ours[name], "ep") == sharding.axis_dim(ref, "ep"), name
        assert len(ours[name]) == len(names[name]), name


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_fsdp_rule_matches_jax_for_every_llama_leaf(fsdp):
    """The rule on each leaf's per-layer shape (the port shards per layer),
    at a width where some leaves cross the 2**14-element threshold."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, n_experts=4)
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=fsdp), jax.devices()[:fsdp])
    shapes = _leaf_shapes(cfg)
    shapes.update({"odd": (3, 5), "ragged": (6000, 3), "big": (128, 256), "scalar": ()})
    crossed = 0
    for name, shape in shapes.items():
        ref = tuple(jax_sharding._fsdp_spec_for_array(np.zeros(shape, np.float32), jmesh))
        ref = ref + (None,) * (len(shape) - len(ref))
        ours = sharding.fsdp_spec_for_shape(shape, fsdp)
        assert ours == ref, (name, shape)
        crossed += sharding.fsdp_dim(ours) is not None
    assert crossed >= 3


def test_spec_for_and_rules_match_jax():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    for axes in (["batch", "sequence"], ["embed", "mlp"], ["expert", None, "vocab"]):
        assert sharding.spec_for(axes) == tuple(jax_sharding.spec_for(axes))
        assert sharding.spec_for(axes, {"mlp": None}) == tuple(jax_sharding.spec_for(axes, {"mlp": None}))


def test_local_batch_is_the_contiguous_data_shard():
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = [sharding.local_batch(x, i, 4) for i in range(4)]
    assert torch.equal(torch.cat(parts), x) and parts[1][0, 0] == 6
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_batch(x, 0, 3)


def test_placement_fn_follows_the_spec():
    from torch.distributed.tensor import Shard

    a, b, c = (torch.nn.Parameter(torch.zeros(s)) for s in ((4, 6), (6, 4), (5,)))
    fn = sharding.placement_fn({id(a): ("fsdp", "tp"), id(b): ("tp", "fsdp"), id(c): (None,)})
    assert fn(a) == Shard(0) and fn(b) == Shard(1)
    with pytest.raises(ValueError, match="no fsdp dim"):
        fn(c)  # replicated parameters stay out of FSDP2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_build_mesh_on_one_rank_and_slice_5b_axes():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        m = mesh.build_mesh(mesh.MeshSpec())
        assert m.mesh_dim_names == mesh.AXIS_ORDER and m.shape == (1,) * 6
        assert mesh.mesh_spec(m) == mesh.MeshSpec() and mesh.data_rank(m) == (0, 1)
        with pytest.raises(mesh.MeshError):
            mesh.build_mesh(mesh.MeshSpec(fsdp=2))
        # pp and the hybrid meshes are ported (tests/test_torch_hybrid_mesh.py,
        # tests/test_torch_pipeline.py): on one rank pp=2 and two slices do
        # not fit.
        with pytest.raises(mesh.MeshError):
            mesh.build_mesh(mesh.MeshSpec(pp=2))
        assert mesh.mesh_spec(mesh.build_hybrid_mesh(mesh.MeshSpec(), mesh.MeshSpec())) == \
            mesh.MeshSpec()
        with pytest.raises(mesh.MeshError, match="do not divide"):
            mesh.hybrid_mesh_for_slices(2)
    finally:
        dist.destroy_process_group()
    with pytest.raises(mesh.MeshError, match="initialised"):
        mesh.build_mesh(mesh.MeshSpec())
