"""``TrainerConfig.remat`` and ``train.data.donate_buffers``.

remat: ``torch.utils.checkpoint`` around the whole loss (``jax.checkpoint``
on the loss in JAX), nested under the model's own per-block remat.  On the
tiny f32 Llama (with and without accumulation, with per-block remat on and
off) the gradients equal those without it, and one step equals the JAX
trainer's with ``remat=True`` from the same weights (SGD, so the update is
the gradient: the parameters to 1e-6).  Over "dots" blocks the step's
CPU peak is at most the peak without it.  On a BatchNorm ResNet the
statistics move once a step, as JAX's functional remat moves them, and the
gradients equal those without remat.

donate_buffers: the bytes of a consumed batch freed and counted, idempotent,
leaves that are not resizable tensors skipped; ``fit`` frees each stacked
call's batch once the call is dispatched.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402

torch.set_num_threads(1)

SEQ, VOCAB, BATCH = 32, 256, 4


def _batch():
    rng = np.random.default_rng(3)
    x = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _jax_init(jcfg):
    return jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))


def _port_grads(tcfg, init, remat: bool, accum: int = 1):
    t = llama.make_trainer(tcfg, trainer.TrainerConfig(optimizer="sgd", learning_rate=0.5,
                                                       remat=remat, grad_accum_steps=accum),
                           device="cpu")
    state = t.init(seed=0)
    state.model.load_state_dict(interop.llama_params_from_jax(tcfg, init))
    x, y = (torch.from_numpy(a) for a in _batch())
    state, metrics = t.train_step(state, x, y)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return float(metrics["loss"]), grads, params


@pytest.mark.parametrize("block_remat,accum", [(False, 1), (True, 1), (True, 2), ("dots", 1)])
def test_remat_gradients_equal_those_without_it(block_remat, accum):
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32)
    tcfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32),
        remat=bool(block_remat), remat_policy="dots" if block_remat == "dots" else "full")
    init = _jax_init(jcfg)
    loss, plain, _ = _port_grads(tcfg, init, remat=False, accum=accum)
    loss_r, remat, _ = _port_grads(tcfg, init, remat=True, accum=accum)
    assert loss_r == loss
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, rtol=1e-6, atol=1e-7, msg=name)


def _cpu_peak_bytes(fn) -> int:
    """The CPU allocator's peak over ``fn()``, above what was allocated
    before it, from the profiler's memory events."""
    import json
    import os
    import tempfile

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    totals = [e["args"]["Total Allocated"] for e in events if e.get("name") == "[memory]"]
    first = next(e for e in events if e.get("name") == "[memory]")
    return max(totals) - (first["args"]["Total Allocated"] - first["args"]["Bytes"])


def test_remat_over_dots_blocks_does_not_raise_the_peak():
    """The loss's remat over blocks that save their products ("dots"): the
    outer checkpoint rebuilds the blocks whole, so no block's saved products
    are held twice, and the step's peak is at most the step's without it."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256, seq_len=256,
                                                     dtype=torch.float32),
                              remat=True, remat_policy="dots", n_layers=4, dim=128, mlp_dim=512)
    x = torch.randint(0, 256, (8, 256), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    y = torch.roll(x, -1, 1)
    peaks = {}
    for remat in (False, True):
        t = llama.make_trainer(cfg, trainer.TrainerConfig(optimizer="sgd", learning_rate=0.1,
                                                          remat=remat), device="cpu")
        state = t.init(seed=0)
        peaks[remat] = _cpu_peak_bytes(lambda: t.train_step(state, x, y))
    assert peaks[True] <= peaks[False], peaks


def test_remat_step_equals_the_jax_trainers():
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32)
    tcfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    jt = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(optimizer="sgd", learning_rate=0.5,
                                                             remat=True))
    x, y = _batch()
    jstate = jt.init(jax.random.key(0), jnp.asarray(x))
    init = jax.device_get(jstate.params)
    jstate, jm = jt.train_step(jstate, jnp.asarray(x), jnp.asarray(y))
    want = interop.llama_params_from_jax(tcfg, jax.device_get(jstate.params))
    loss, _, params = _port_grads(tcfg, init, remat=True)
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
    for name, p in params.items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=1e-6, msg=name)


def test_remat_keeps_one_batchnorm_update_a_step():
    arch = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    ds = data.SyntheticDataset(shape=(32, 32, 3), num_classes=10, batch_size=8)
    b = next(iter(ds.batches(1)))
    x, y = torch.from_numpy(b.x), torch.from_numpy(b.y)
    out = {}
    for remat in (False, True):
        t = trainer.Trainer(lambda g: resnet.ResNet(**arch, generator=g),
                            trainer.TrainerConfig(learning_rate=0.1, has_train_arg=True,
                                                  remat=remat, matmul_precision="float32"),
                            device="cpu")
        state = t.init(seed=0)
        state, m = t.train_step(state, x, y)
        out[remat] = (float(m["loss"]), {n: p.grad.clone() for n, p in state.model.named_parameters()},
                      {n: v.clone() for n, v in state.model.named_buffers()})
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][n], g, rtol=1e-6, atol=1e-7, msg=n)
    assert out[False][2]  # the model has running statistics
    for n, v in out[False][2].items():
        torch.testing.assert_close(out[True][2][n], v, rtol=0, atol=0, msg=n)


def test_donate_buffers_frees_and_counts():
    x = torch.ones((4, 4), dtype=torch.float32)
    y = torch.ones((4,), dtype=torch.int32)
    host = np.ones((2, 2), np.float32)  # not a tensor: skipped
    shared = torch.from_numpy(np.ones(3, np.float32))  # a numpy array's storage: skipped
    freed = data.donate_buffers({"x": x, "y": [y, host], "shared": shared})
    assert freed == 4 * 4 * 4 + 4 * 4
    assert x.untyped_storage().nbytes() == 0 and y.untyped_storage().nbytes() == 0
    assert shared.sum() == 3
    assert data.donate_buffers((x, y)) == 0  # a second call finds nothing


def test_fit_donates_each_stacked_batch(monkeypatch):
    seen = []

    def spy(tree):
        seen.append([tuple(t.shape) for t in tree])
        return 0

    monkeypatch.setattr(trainer, "donate_buffers", spy)
    t = llama.make_trainer(llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ,
                                                  dtype=torch.float32),
                           trainer.TrainerConfig(optimizer="adamw", learning_rate=1e-3),
                           device="cpu")
    ds = data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=BATCH)
    state, losses = t.fit(t.init(seed=0), ds.batches(5), steps=5, steps_per_call=2)
    assert len(losses) == 5
    assert seen == [[(2, BATCH, SEQ)] * 2] * 2  # two stacked calls; the remainder step is not
