"""Hybrid (multi-slice) meshes in the port (``parallel/mesh.build_hybrid_mesh``,
``hybrid_mesh_for_slices``) against the JAX package's
(``tests/test_hybrid_mesh.py``, ``tests/test_multislice.py``).

The port's mesh is a ``DeviceMesh`` over an explicit grid of ranks, each
node's ranks consecutive; its grid must be JAX's device-id grid for the same
specs on the conftest's virtual devices (JAX's single-granule reshape, the
grouping its process-granule branch assumes).  The refusals are JAX's.  On
one gloo rank the builders run end to end; on the card (``cuda``), a
captured step over a one-rank NCCL mesh is bitwise its eager steps.  Llama on
``build_hybrid_mesh(MeshSpec(fsdp=2), MeshSpec(dp=2))`` over four ranks is
held to JAX's losses in ``test_torch_distributed.py`` (its four-rank spawn).
"""

import dataclasses
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's host has no JAX: there only the cuda-marked test runs
    import jax

    from deeplearning_cfn_tpu.parallel import mesh as jax_mesh
except ImportError:
    jax = None

from deeplearning_cfn_tpu_torch.parallel import mesh  # noqa: E402

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

SPECS = {  # name: (ici, dcn)
    "fsdp_in_dp_across": (dict(fsdp=4), dict(dp=2)),
    "dp_in_dp_across": (dict(dp=4), dict(dp=2)),
    "fsdp_tp_in_dp_across": (dict(fsdp=2, tp=2), dict(dp=2)),
    "tp_in_fsdp_across": (dict(tp=4), dict(fsdp=2)),
    "dp_in_pp_across": (dict(dp=4), dict(pp=2)),
    "ep_in_dp_fsdp_across": (dict(ep=2), dict(dp=2, fsdp=2)),
}


@needs_jax
@pytest.mark.parametrize("name", list(SPECS))
def test_rank_grid_is_jax_device_grid(name):
    ici, dcn = SPECS[name]
    want = jax_mesh.build_hybrid_mesh(jax_mesh.MeshSpec(**ici), jax_mesh.MeshSpec(**dcn),
                                      jax.devices()[:8])
    grid = mesh.hybrid_rank_grid(mesh.MeshSpec(**ici), mesh.MeshSpec(**dcn), 8)
    np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(want.devices))
    assert grid.shape == tuple(want.shape[a] for a in mesh.AXIS_ORDER)


def test_axes_combine_dcn_slowest_and_same_axis_multiplies():
    grid = mesh.hybrid_rank_grid(mesh.MeshSpec(fsdp=4), mesh.MeshSpec(dp=2), 8)
    rows = grid.reshape(2, 4).tolist()
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]  # node 0 = ranks 0..3
    assert mesh.hybrid_rank_grid(mesh.MeshSpec(dp=4), mesh.MeshSpec(dp=2), 8).shape[0] == 8


@needs_jax
@pytest.mark.parametrize("ici,dcn,match", [
    (dict(dp=4), dict(tp=2), "cannot span DCN"),
    (dict(dp=4), dict(sp=2), "cannot span DCN"),
    (dict(dp=4), dict(ep=2), "cannot span DCN"),
    (dict(fsdp=4), dict(dp=4), "devices"),
    (dict(dp=-4), dict(dp=-2), ">= 1"),
])
def test_refusals_match_jax(ici, dcn, match):
    with pytest.raises(jax_mesh.MeshError, match=match) as want:
        jax_mesh.build_hybrid_mesh(jax_mesh.MeshSpec(**ici), jax_mesh.MeshSpec(**dcn),
                                   jax.devices()[:8])
    with pytest.raises(mesh.MeshError) as got:
        mesh.hybrid_rank_grid(mesh.MeshSpec(**ici), mesh.MeshSpec(**dcn), 8)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


@needs_jax
def test_slice_specs_match_jax_hybrid_mesh_for_slices():
    """The specs ``hybrid_mesh_for_slices`` builds for 8 ranks in 2 nodes
    give JAX's mesh shapes; 3 nodes do not divide 8 ranks."""
    for ici in (None, mesh.MeshSpec.fsdp_parallel(4)):
        jici = None if ici is None else jax_mesh.MeshSpec(**vars(ici))
        want = jax_mesh.hybrid_mesh_for_slices(2, ici_spec=jici, devices=jax.devices()[:8])
        grid = mesh.hybrid_rank_grid(*mesh.slice_specs(8, 2, ici), 8)
        np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(want.devices))
    with pytest.raises(mesh.MeshError, match="do not divide"):
        mesh.slice_specs(8, 3)
    with pytest.raises(mesh.MeshError, match="unknown dcn axis"):
        mesh.slice_specs(8, 2, dcn_axis="xx")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_builders_on_one_gloo_rank(monkeypatch):
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.examples.common import default_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        m = mesh.build_hybrid_mesh(mesh.MeshSpec(), mesh.MeshSpec())
        assert m.mesh_dim_names == mesh.AXIS_ORDER and m.mesh.tolist() == [[[[[[0]]]]]]
        assert mesh.mesh_spec(mesh.hybrid_mesh_for_slices(1)) == mesh.MeshSpec()
        with pytest.raises(mesh.MeshError, match="do not divide"):
            mesh.hybrid_mesh_for_slices(2)
        monkeypatch.setenv("DEEPLEARNING_SLICES_COUNT", "2")
        with pytest.raises(mesh.MeshError, match="do not divide"):
            default_mesh("fsdp")
    finally:
        dist.destroy_process_group()
    with pytest.raises(mesh.MeshError, match="initialised"):
        mesh.build_hybrid_mesh(mesh.MeshSpec(), mesh.MeshSpec())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_steps_over_a_one_rank_mesh_match_eager_on_card(cuda_device):
    """``multi_step_fn(2)`` over ``build_mesh(MeshSpec(fsdp=1))`` on a
    one-rank NCCL group (FSDP2's collectives inside the graph) is bitwise two
    eager steps over the same mesh; so is the dp step's (DDP's sync without
    its wrapper, ``overlap.DDPGradSync``)."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        # m435's widths at two layers, seq 256 (tools/gloo_cuda_probe.py's step).
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=256), n_layers=2)
        tcfg = TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
                             weight_decay=0.1, grad_clip_norm=1.0)
        one = next(SyntheticTokenDataset(seq_len=256, vocab_size=cfg.vocab_size,
                                         batch_size=4).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * 2), 2)), cuda_device)
        trainer = llama.make_trainer(cfg, tcfg, device=cuda_device,
                                     mesh=mesh.build_mesh(mesh.MeshSpec(fsdp=1)))
        eager, losses = trainer.init(seed=0), []
        for i in range(2):
            eager, m = trainer.train_step(eager, xs[i], ys[i])
            losses.append(m["loss"].item())
        state = trainer.init(seed=0)
        kfn = trainer.multi_step_fn(2)
        state, captured = kfn(state, xs, ys)
        assert kfn.captures == 1 and captured.tolist() == losses
        for (n, p), q in zip(state.model.named_parameters(), eager.model.parameters()):
            assert torch.equal(p.to_local() if hasattr(p, "to_local") else p,
                               q.to_local() if hasattr(q, "to_local") else q), n
        ddp = llama.make_trainer(cfg, dataclasses.replace(tcfg, strategy="dp"),
                                 device=cuda_device, mesh=mesh.build_mesh(mesh.MeshSpec(dp=1)))
        eager, losses = ddp.init(seed=0), []
        assert isinstance(eager.grad_sync, overlap.DDPGradSync)
        for i in range(2):
            eager, m = ddp.train_step(eager, xs[i], ys[i])
            losses.append(m["loss"].item())
        state = ddp.init(seed=0)
        kfn = ddp.multi_step_fn(2)
        state, captured = kfn(state, xs, ys)
        assert kfn.captures == 1 and captured.tolist() == losses
        for (n, p), q in zip(state.model.named_parameters(), eager.model.parameters()):
            assert torch.equal(p, q), n
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True], ids=["f32", "int8"])
def test_captured_bucketed_sync_on_one_nccl_rank_is_bitwise_eager_on_card(cuda_device, compress):
    """``multi_step_fn(2)`` with ``comms_overlap`` (f32, and int8 with error
    feedback) over ``MeshSpec(dp=1)`` on a one-rank NCCL group, twice (a
    capture, then a replay), is bitwise four eager steps: losses, parameters
    and the int8 residuals.  JAX's gate refuses one data rank; it is lifted
    here, since the engine is the same at any rank count."""
    from unittest import mock

    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=256), n_layers=2)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy="dp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, comms_overlap=True, overlap_compress=compress),
            device=cuda_device, mesh=mesh.build_mesh(mesh.MeshSpec(dp=1)))
        one = next(SyntheticTokenDataset(seq_len=256, vocab_size=cfg.vocab_size,
                                         batch_size=4).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * 2), 2)), cuda_device)
        with mock.patch.object(overlap, "check_sync", lambda *a, **k: None):
            eager, state = trainer.init(seed=0), trainer.init(seed=0)
        losses = []
        for _ in range(2):
            for i in range(2):
                eager, m = trainer.train_step(eager, xs[i], ys[i])
                losses.append(m["loss"].item())
        kfn, captured = trainer.multi_step_fn(2), []
        for _ in range(2):
            state, got = kfn(state, xs, ys)
            captured += got.tolist()
        assert kfn.captures == 1 and captured == losses
        for (n, p), q in zip(state.model.named_parameters(), eager.model.parameters()):
            assert torch.equal(p, q), n
        if compress:
            for a, b in zip(state.error_feedback.residual, eager.error_feedback.residual):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
