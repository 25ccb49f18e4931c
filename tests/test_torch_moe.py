"""The port's mixture of experts against the JAX package's ``moe_mlp``, on
the CPU, on the same numpy weights and inputs.

- The cases of ``tests/test_moe.py`` on the port: capacity rounding; shapes
  and the aux loss; full capacity keeps every token; overflow is dropped;
  the top-1 gate passes the task gradient to the router.  Each also holds
  the port's output to JAX's.
- The routing decisions (chosen experts, claimed slots, which claims fit)
  equal JAX's exactly, read off JAX's own arithmetic.
- ``LlamaConfig.tiny_moe``: logits, loss and gradients, three trainer steps,
  and greedy decode, each against JAX on weights carried by ``interop``.

Here the port routes the whole batch as one group, as JAX does without a
mesh (``_n_data_groups`` is 1); the groups of a mesh are held in
``test_torch_distributed.py``.  Tolerance: f32 throughout; the port gathers
and scatter-adds where JAX multiplies by one-hot tensors (exact, but for the
order of <= k additions a token), and the batched expert products sum in
another order: 1e-5 relative on outputs, logits and losses, 1e-6 absolute on
single-step gradients of O(1e-2) and below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.models import llama_decode as jax_decode  # noqa: E402
from deeplearning_cfn_tpu.ops import moe as jax_moe  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, llama_decode  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import moe  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402

torch.set_num_threads(1)

RTOL, GRAD_ATOL = 1e-5, 1e-6
SEQ, VOCAB = 16, 64


def _params(cfg, d, m, seed=0):
    jp = jax_moe.init_moe_params(jax_moe.MoEConfig(**vars(cfg)), jax.random.key(seed), d, m,
                                 dtype=jnp.float32)
    jp = jax.device_get(jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(cfg, jp, tp, x):
    y_ref, aux_ref = jax_moe.moe_mlp(jax_moe.MoEConfig(**vars(cfg)), jp, jnp.asarray(x))
    y, aux = moe.moe_mlp(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=RTOL)
    return y, aux


def test_capacity_rounding():
    cfg = moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0)
    assert moe.expert_capacity(cfg, 64) == 32
    assert moe.expert_capacity(cfg, 65) % 8 == 0
    assert moe.expert_capacity(cfg, 1) >= 8
    for n in (1, 7, 64, 65, 1000, 16384):
        for e, k, f in ((4, 2, 1.0), (8, 2, 1.25), (2, 1, 0.01)):
            c = moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=f)
            assert moe.expert_capacity(c, n) == jax_moe.expert_capacity(
                jax_moe.MoEConfig(**vars(c)), n)


def test_moe_mlp_shapes_and_aux_match_jax():
    cfg = moe.MoEConfig(n_experts=4, top_k=2)
    jp, tp = _params(cfg, 16, 32)
    x = _x((2, 8, 16))
    y, aux = _both(cfg, jp, tp, x)
    assert y.shape == x.shape and np.isfinite(aux.item())
    assert aux.item() >= cfg.aux_loss_weight * 0.99


def test_full_capacity_preserves_all_tokens():
    cfg = moe.MoEConfig(n_experts=2, top_k=2, capacity_factor=2.0)
    d, m = 8, 16
    jp, tp = _params(cfg, d, m)
    x = _x((1, 4, d))
    y, _ = _both(cfg, jp, tp, x)
    xt = torch.from_numpy(x).reshape(-1, d)
    probs = torch.softmax(xt @ tp["router"], dim=-1)
    expected = torch.zeros_like(xt)
    for e in range(2):
        h = torch.nn.functional.silu(xt @ tp["w_gate"][e]) * (xt @ tp["w_up"][e])
        expected += probs[:, e:e + 1] * (h @ tp["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, d).detach().numpy(), expected.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_capacity_drops_overflow():
    cfg = moe.MoEConfig(n_experts=2, top_k=1, capacity_factor=0.01)
    jp, tp = _params(cfg, 8, 16)
    x = _x((4, 16, 8))
    y, _ = _both(cfg, jp, tp, x)
    assert torch.isfinite(y).all()
    r = moe.route(cfg, tp["router"], torch.from_numpy(x).reshape(-1, 8))
    assert r.capacity == 8 and r.kept.sum().item() <= 2 * 8 < 64
    dropped = (r.kept[:, 0] == 0).nonzero()[:, 0]
    assert torch.all(y.reshape(-1, 8)[dropped] == 0)


def test_top1_gate_passes_task_gradient_to_router():
    cfg = moe.MoEConfig(n_experts=4, top_k=1, capacity_factor=2.0, aux_loss_weight=0.0)
    jp, tp = _params(cfg, 8, 16)
    x = _x((2, 8, 8))
    jgrad = jax.grad(lambda p: jnp.sum(jax_moe.moe_mlp(jax_moe.MoEConfig(**vars(cfg)), p,
                                                      jnp.asarray(x))[0] ** 2))(jp)
    router = tp["router"].clone().requires_grad_(True)
    y, _ = moe.moe_mlp(cfg, {**tp, "router": router}, torch.from_numpy(x))
    (y ** 2).sum().backward()
    assert router.grad.norm().item() > 0.0
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(jgrad["router"]),
                               rtol=1e-4, atol=GRAD_ATOL)


def _jax_routing(cfg, router, x):
    """JAX's own routing arithmetic (``moe_mlp``'s lines, one group)."""
    xt = jnp.asarray(x)[None]
    E, k = cfg.n_experts, cfg.top_k
    t = xt.shape[1]
    C = jax_moe.expert_capacity(jax_moe.MoEConfig(**vars(cfg)), t)
    probs = jax.nn.softmax(xt @ router, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    pri = jnp.swapaxes(sel, 1, 2).reshape(1, k * t, E)
    pos = (jnp.cumsum(pri, axis=1) - pri).reshape(1, k, t, E).swapaxes(1, 2)
    within = sel * (pos < C)
    slot = jnp.sum(pos * within, axis=-1).astype(jnp.int32)
    return np.asarray(gate_idx[0]), np.asarray(slot[0]), np.asarray(within.sum(-1)[0])


@pytest.mark.parametrize("e,k,f", [(4, 2, 1.25), (8, 2, 0.5), (4, 1, 0.3), (8, 3, 1.0)])
def test_routing_indices_equal_jax(e, k, f):
    cfg = moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=f)
    jp, tp = _params(cfg, 16, 8)
    x = _x((96, 16), seed=e + k)
    idx, slot, kept = _jax_routing(cfg, jp["router"], x)
    r = moe.route(cfg, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(r.expert.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert 0 < kept.sum() <= kept.size


def _configs(**kw):
    jcfg = jax_llama.LlamaConfig.tiny_moe(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32, **kw)
    tcfg = llama.LlamaConfig.tiny_moe(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32, **kw)
    return jcfg, tcfg


def _models(**kw):
    jcfg, tcfg = _configs(**kw)
    jparams = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    model = llama.Llama(tcfg)
    model.load_state_dict(interop.llama_params_from_jax(tcfg, jparams))
    return jcfg, tcfg, jparams, model


def _tokens(seed=0, batch=4):
    tok = np.random.default_rng(seed).integers(1, VOCAB, size=(batch, SEQ), dtype=np.int32)
    return tok, np.roll(tok, -1, axis=1)


def test_tiny_moe_counts_match_jax():
    jcfg, tcfg = _configs()
    assert llama.param_count(tcfg) == jax_llama.param_count(jcfg)
    assert llama.active_param_count(tcfg) == jax_llama.active_param_count(jcfg)
    assert llama.train_flops_per_token(tcfg, SEQ) == jax_llama.train_flops_per_token(jcfg, SEQ)
    model = llama.Llama(tcfg)
    assert sum(p.numel() for p in model.parameters()) == llama.param_count(tcfg)
    assert model.layers[0].moe.router.dtype == torch.float32


@pytest.mark.parametrize("top_k", [1, 2])
def test_tiny_moe_logits_loss_and_gradients_match_jax(top_k):
    jcfg, tcfg, jparams, model = _models(moe_top_k=top_k)
    tok, tgt = _tokens()
    j_logits, j_aux = jax_llama.forward_with_aux(jcfg, jparams, jnp.asarray(tok))
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda p: jax_llama.causal_lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt)),
        has_aux=True)(jparams)
    logits, aux = llama.forward_with_aux(model, torch.from_numpy(tok))
    loss, metrics = llama.causal_lm_loss(model, torch.from_numpy(tok), torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(), float(j_metrics["moe_aux_loss"]),
                               rtol=RTOL)
    ref = interop.llama_params_from_jax(tcfg, jax.device_get(j_grads))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=GRAD_ATOL, err_msg=name)


def test_dense_model_reports_no_moe_aux_loss():
    tcfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    _, metrics = llama.causal_lm_loss(llama.Llama(tcfg), tok, tgt)
    assert "moe_aux_loss" not in metrics


def test_three_trainer_steps_match_jax():
    steps, lr = 3, 1e-3
    jcfg, tcfg = _configs()
    kwargs = dict(optimizer="adamw", learning_rate=lr, weight_decay=0.1, grad_clip_norm=1.0,
                  log_every=1, strategy="fsdp")
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    jtrainer = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(**kwargs))
    jds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=4)
    jstate = jtrainer.init(jax.random.key(0), jnp.asarray(next(iter(jds.batches(1))).x))
    init_params = jax.device_get(jstate.params)
    jstate, jlosses = jtrainer.fit(jstate, jds.batches(steps), steps=steps, prefetch=0)
    jfinal = jax.device_get(jstate.params)

    ttrainer = llama.make_trainer(tcfg, trainer.TrainerConfig(**kwargs), device="cpu")
    tstate = ttrainer.init(seed=0)
    tstate.model.load_state_dict(interop.llama_params_from_jax(tcfg, init_params))
    tds = data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB, batch_size=4)
    tstate, tlosses = ttrainer.fit(tstate, tds.batches(steps), steps=steps)
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    assert "moe_aux_loss" in ttrainer.last_metrics
    final = interop.llama_params_from_jax(tcfg, jfinal)
    for name, p in tstate.model.state_dict().items():
        # Adam's bound, as tests/test_torch_trainer.py holds it.
        diff = np.abs(p.numpy() - final[name].numpy())
        assert diff.max() <= lr * steps, name
        assert np.mean(diff > 2e-6) <= 1e-3, (name, diff.max())


def test_moe_greedy_decode_matches_jax_generate():
    jcfg, _, jparams, model = _models()
    prompt = np.random.default_rng(2).integers(1, VOCAB, size=(2, 6), dtype=np.int32)
    ref = jax_decode.generate(jcfg, jparams, jnp.asarray(prompt), jax.random.key(0),
                              max_new_tokens=10)
    with torch.no_grad():
        got = llama_decode.generate(model, torch.from_numpy(prompt), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_interop_splits_experts_per_ep_rank():
    _, tcfg, jparams, _ = _models()
    full = interop.llama_params_from_jax(tcfg, jparams)
    for rank in range(2):
        part = interop.llama_params_from_jax(tcfg, jparams, ep_rank=rank, ep_size=2)
        assert torch.equal(part["layers.1.moe.w_up"], full["layers.1.moe.w_up"][2 * rank:2 * rank + 2])
        assert torch.equal(part["layers.0.moe.router"], full["layers.0.moe.router"])
        model = llama.Llama(tcfg)
        for layer in model.layers:
            layer.moe.shard_experts(rank, 2, group=None)
        model.load_state_dict(part)
