"""The port's BERT against the JAX package's, on the CPU, on the same weights.

The JAX ``BertEncoder``/``BertClassifier`` is initialised from
``jax.random.key(0)``; its weights reach the port through
``interop.bert_params_from_jax``.  The MLP runs through plain dense layers
(``use_pallas_mlp`` off) or the fused dense (on: the Pallas kernel in
interpret mode in JAX, the plain fused dense in the port).  Tolerances:

- f32 (``BertConfig.tiny``): two layers of f32 products and LayerNorms
  summed in another order; logits of O(1) to 1e-4 relative and 1e-5
  absolute, the loss to 1e-5, gradients to 1e-5 of each tensor's largest
  entry (the embedding gradients are sparse sums, so an entry-wise relative
  bound would be meaningless at their zeros).
- bf16 (the tiny shape in bf16): both frameworks round every bf16 op, the
  port's tanh-form gelu included, so the forward agrees to a rare one-ulp
  flip: logits within one bf16 ulp at |logit| < 4 (2**-6) and a mean
  difference below 1e-4; the loss to 1e-4.  The bf16 backward rounds at
  other places (torch's backward kernels round a bf16 result once where
  JAX's autodiff rounds every op), so gradients agree to 2**-5 of each
  tensor's largest entry, a few bf16 ulps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from deeplearning_cfn_tpu.models import bert as jax_bert  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import bert  # noqa: E402

torch.set_num_threads(1)

VOCAB, SEQ, BATCH = 256, 32, 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {
    "f32": dict(logits=dict(rtol=1e-4, atol=1e-5), loss=1e-5, grad=1e-5, logits_mean=None),
    "bf16": dict(logits=dict(rtol=0.0, atol=2**-6), loss=1e-4, grad=2**-5, logits_mean=1e-4),
}


def _configs(dtype: str, pallas: bool):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_bert.BertConfig.tiny(vocab_size=VOCAB, seq_len=SEQ),
                               dtype=jdt, use_pallas_mlp=pallas)
    tcfg = dataclasses.replace(bert.BertConfig.tiny(vocab_size=VOCAB, seq_len=SEQ),
                               dtype=tdt, use_pallas_mlp=pallas)
    return jcfg, tcfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, VOCAB, size=(BATCH, SEQ), dtype=np.int32)
    y = np.where(rng.random((BATCH, SEQ)) < 0.3, tok, -1).astype(np.int32)
    return tok, y


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_JAX_RESULTS: dict = {}


def _jax_encoder(dtype: str, pallas: bool):
    """(numpy params, logits, loss, masked accuracy, grads) of the
    JAX encoder, computed once per configuration."""
    key = (dtype, pallas)
    if key not in _JAX_RESULTS:
        jcfg, _ = _configs(dtype, pallas)
        model = jax_bert.BertEncoder(jcfg)
        tok, y = _batch()
        params = model.init(jax.random.key(0), jnp.asarray(tok))["params"]
        logits = model.apply({"params": params}, jnp.asarray(tok))
        (loss, aux), grads = jax.value_and_grad(jax_bert.mlm_loss(model), has_aux=True)(
            params, jnp.asarray(tok), jnp.asarray(y))
        _JAX_RESULTS[key] = (jax.device_get(params), np.asarray(logits), float(loss),
                             float(aux["masked_accuracy"]), jax.device_get(grads))
    return _JAX_RESULTS[key]


def _port_encoder(dtype: str, pallas: bool, params_np):
    _, tcfg = _configs(dtype, pallas)
    model = bert.BertEncoder(tcfg)
    model.load_state_dict(interop.bert_params_from_jax(tcfg, params_np))
    return tcfg, model


CASES = [(d, p) for d in ("f32", "bf16") for p in (False, True)]
IDS = [f"{d}-{'fused' if p else 'dense'}" for d, p in CASES]


@pytest.mark.parametrize("dtype,pallas", CASES, ids=IDS)
def test_logits_and_mlm_loss_match_jax(dtype, pallas):
    params, j_logits, j_loss, j_acc, _ = _jax_encoder(dtype, pallas)
    _, model = _port_encoder(dtype, pallas, params)
    tok, y = _batch()
    tol = TOL[dtype]
    with torch.no_grad():
        logits = model(torch.from_numpy(tok))
        loss, aux = bert.mlm_loss(model, torch.from_numpy(tok), torch.from_numpy(y))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(logits.numpy(), j_logits, **tol["logits"])
    if tol["logits_mean"] is not None:
        assert np.abs(logits.numpy() - j_logits).mean() < tol["logits_mean"]
    np.testing.assert_allclose(loss.item(), j_loss, rtol=tol["loss"])
    assert aux["masked_accuracy"].item() == pytest.approx(j_acc)


@pytest.mark.parametrize("dtype,pallas", CASES, ids=IDS)
def test_one_step_gradients_match_jax(dtype, pallas):
    params, _, _, _, j_grads = _jax_encoder(dtype, pallas)
    tcfg, model = _port_encoder(dtype, pallas, params)
    tok, y = _batch()
    loss, _ = bert.mlm_loss(model, torch.from_numpy(tok), torch.from_numpy(y))
    loss.backward()
    ref = interop.bert_params_from_jax(tcfg, j_grads)
    assert ref.keys() == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        r = ref[name].to(torch.float32).numpy()
        assert p.grad.dtype == torch.float32, name  # the f32 master weight's gradient
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=TOL[dtype]["grad"] * np.abs(r).max(), err_msg=name)


def test_classifier_logits_and_trunk_transfer_match_jax():
    jcfg, tcfg = _configs("f32", False)
    tok, _ = _batch(1)
    jenc = jax_bert.BertEncoder(jcfg)
    jcls = jax_bert.BertClassifier(jcfg, num_classes=3)
    pre = jax.device_get(jenc.init(jax.random.key(0), jnp.asarray(tok))["params"])
    target = jax.device_get(jcls.init(jax.random.key(1), jnp.asarray(tok))["params"])
    merged = jax_bert.transfer_trunk_params(pre, target)
    j_logits = np.asarray(jcls.apply({"params": merged}, jnp.asarray(tok)))

    got = bert.transfer_trunk_params(interop.bert_params_from_jax(tcfg, pre),
                                     interop.bert_params_from_jax(tcfg, target))
    want = interop.bert_params_from_jax(tcfg, merged)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    model = bert.BertClassifier(tcfg, num_classes=3)
    model.load_state_dict(got)
    with torch.no_grad():
        logits = model(torch.from_numpy(tok))
    assert logits.shape == (BATCH, 3) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_param_count_matches_jax(preset):
    jcfg = getattr(jax_bert.BertConfig, preset)()
    shapes = jax.eval_shape(
        lambda: jax_bert.BertEncoder(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert bert.param_count(getattr(bert.BertConfig, preset)()) == n


def test_train_flops_per_token_matches_flop_counter():
    """On the plain dense path every product is an aten matmul the counter
    sees: forward and backward of the loss count 6 per matmul weight and
    12·L·dim·S of attention, per token."""
    _, tcfg = _configs("f32", False)
    model = bert.BertEncoder(tcfg)
    tok, y = _batch()
    with FlopCounterMode(display=False) as counter:
        loss, _ = bert.mlm_loss(model, torch.from_numpy(tok), torch.from_numpy(y))
        loss.backward()
    assert counter.get_total_flops() == bert.train_flops_per_token(tcfg, SEQ) * BATCH * SEQ


def test_base_config_and_flops_at_the_slice_shape():
    cfg = bert.BertConfig.base()
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_heads, cfg.mlp_dim) == (
        30522, 768, 12, 12, 3072)
    assert cfg.dtype == torch.bfloat16 and not cfg.use_pallas_mlp
    assert bert.matmul_param_count(cfg) == 108_965_376
    assert bert.train_flops_per_token(cfg, 128) == 6 * 108_965_376 + 12 * 12 * 768 * 128


def test_inits_follow_flax_distributions():
    cfg = dataclasses.replace(bert.BertConfig.tiny(vocab_size=4096), dim=256, mlp_dim=512)
    model = bert.BertEncoder(cfg, torch.Generator().manual_seed(0))
    emb = model.tok_embed.embedding.detach()
    np.testing.assert_allclose(emb.std().item(), cfg.dim**-0.5, rtol=0.02)  # normal, var 1/dim
    k = model.layers[0].mlp_in.kernel.detach()  # lecun normal, truncated at 2 sigma
    np.testing.assert_allclose(k.std().item(), cfg.dim**-0.5, rtol=0.03)
    assert k.abs().max().item() <= 2 * cfg.dim**-0.5 / 0.87962566103423978
    assert torch.count_nonzero(model.layers[0].qkv.bias) == 0
    assert torch.all(model.embed_ln.scale == 1)


def test_fused_and_dense_layers_share_parameter_names():
    _, dense_cfg = _configs("f32", False)
    _, fused_cfg = _configs("f32", True)
    dense = bert.BertEncoder(dense_cfg).state_dict()
    fused = bert.BertEncoder(fused_cfg).state_dict()
    assert {k: v.shape for k, v in dense.items()} == {k: v.shape for k, v in fused.items()}


def test_interop_accepts_bf16_leaves_and_checks_depth():
    jcfg, tcfg = _configs("f32", False)
    params = jax.device_get(jax_bert.BertEncoder(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    as_bf16 = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    sd = interop.bert_params_from_jax(tcfg, as_bf16)
    assert sd["layers.1.qkv.kernel"].dtype == torch.bfloat16
    assert sd["layers.1.qkv.kernel"].shape == (tcfg.dim, 3 * tcfg.dim)
    np.testing.assert_array_equal(  # [dim, 3, H, hd] flattened in that order
        sd["layers.0.qkv.kernel"].float().numpy(),
        _f32(as_bf16["layer0"]["qkv"]["kernel"]).reshape(tcfg.dim, 3 * tcfg.dim))
    with pytest.raises(ValueError, match="layers"):
        interop.bert_params_from_jax(dataclasses.replace(tcfg, n_layers=3), params)


def test_quantize_tree_matches_jax_on_bert_qkv():
    """The port quantizes BERT's qkv kernel in its JAX leaf shape
    [dim, 3, H, hd], per hd, as ``jax_quant.quantize_tree`` does: the same
    int8 values and scales at every kernel, and the same dequantized weights
    once both are flattened to the port's state dict."""
    from deeplearning_cfn_tpu.ops import quant as jax_quant
    from deeplearning_cfn_tpu_torch.ops import quant

    jcfg, tcfg = _configs("f32", False)
    tok, _ = _batch()
    params = jax_bert.BertEncoder(jcfg).init(jax.random.key(0), jnp.asarray(tok))["params"]
    jq, jp = jax_quant.quantize_tree(params)
    jback = interop.bert_params_from_jax(tcfg, jax.device_get(jax_quant.dequantize_tree(jq, jp)))
    jq_np = jax.device_get(jq)

    state = interop.bert_params_from_jax(tcfg, jax.device_get(params))
    q, p = quant.quantize_tree(state, bert.jax_kernel_shapes(tcfg))
    kernels = [name for name, v in q.items() if v is not None]
    assert "layers.0.qkv.kernel" in kernels and "layers.0.mlp_in.kernel" in kernels
    for name in kernels:
        leaf = jq_np
        for key in name.replace("layers.", "layer").split("."):
            leaf = leaf[key]
        np.testing.assert_array_equal(q[name]["wq"].numpy(), np.asarray(leaf["wq"]), err_msg=name)
        np.testing.assert_array_equal(q[name]["scale"].numpy(), np.asarray(leaf["scale"]),
                                      err_msg=name)
    assert q["layers.0.qkv.kernel"]["scale"].shape == (tcfg.dim // tcfg.n_heads,)
    back = quant.dequantize_tree(q, p)
    assert back.keys() == jback.keys()
    for name, t in back.items():
        assert t.shape == state[name].shape, name
        np.testing.assert_array_equal(t.numpy(), jback[name].numpy(), err_msg=name)
