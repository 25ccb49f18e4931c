"""The port's ResNet against the JAX package's, on the CPU, on the same weights.

``ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)`` is initialised
in JAX from ``jax.random.key(0)``, then every norm's scale, bias, mean and
variance is drawn at random (Flax's ``bn3`` scale of 0 would leave each
block's residual branch, its stride-2 ``conv2`` among them, out of the
logits); params and ``batch_stats`` reach the port through
``interop.resnet_params_from_jax``.  Inputs are NHWC numpy
draws, 32x32 (even: the stride-2 conv and the max-pool pad (0, 1)) and 33x33
(odd: (1, 1)).  The head is ``nn.Dense`` / the plain ``x @ kernel + bias``
(``use_pallas_head`` off) or ``FusedDense`` (on: the Pallas kernel in
interpret mode in JAX, the plain fused dense in the port).  Tolerances:

- f32 logits (train and eval mode, ``norm`` batch and group, each head):
  1e-4 absolute.  Both sides sum the same convolutions, statistics and the
  head in another order; logits are O(1).
- the running statistics after one train-mode call (momentum 0.9, biased
  variance): 1e-5 absolute.
- gradients of a fixed random projection of the logits: 1e-4 of each
  tensor's largest entry (a relative bound would be meaningless at zeros),
  and none of them all zeros.
- bf16 logits: 2**-5 of the largest logit.  Both round every conv and
  BatchNorm output to bf16, at other places (XLA fuses, PyTorch does not),
  and the differences carry through the network: a few bf16 ulps.
- ``return_features`` maps in NHWC, f32: 1e-4 absolute.
- ``fold_batchnorm`` then ``norm="folded"``, against JAX's fold and folded
  model, eval mode: 1e-5 absolute on the folded weights, 1e-4 on logits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from deeplearning_cfn_tpu.models import resnet as jax_resnet  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import resnet  # noqa: E402

torch.set_num_threads(1)

ARCH = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
BATCH = 4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _images(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((BATCH, size, size, 3)).astype(np.float32)


_INIT: dict = {}


def _randomise_norms(node, rng, path=()):
    """Numpy draws for every norm's scale and bias (params) and mean and var
    (batch_stats), in place of Flax's init (scale 1, or 0 for ``bn3``, which
    would hide each block's residual branch; bias and mean 0, var 1)."""
    for key, child in node.items():
        if isinstance(child, dict):
            _randomise_norms(child, rng, path + (key,))
        elif any(p.startswith("bn") for p in path):
            shape, dtype = np.shape(child), np.asarray(child).dtype
            draw = {"scale": lambda: rng.uniform(0.5, 1.5, shape),
                    "var": lambda: rng.uniform(0.5, 1.5, shape),
                    "bias": lambda: 0.2 * rng.standard_normal(shape),
                    "mean": lambda: 0.2 * rng.standard_normal(shape)}[key]
            node[key] = draw().astype(dtype)


def _jax_variables(norm: str, size: int):
    """Numpy params and batch_stats of the JAX model, once per (norm, size):
    Flax's conv and head weights, the norms' variables drawn at random
    (``_randomise_norms``), the same arrays on both sides."""
    key = (norm, size)
    if key not in _INIT:
        model = jax_resnet.ResNet(**ARCH, norm=norm)
        variables = model.init(jax.random.key(0), jnp.asarray(_images(size)), train=False)
        variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
        rng = np.random.default_rng(7)
        for tree in variables.values():
            _randomise_norms(tree, rng)
        _INIT[key] = variables
    return _INIT[key]


def _pair(norm: str, size: int, pallas: bool, dtype: str = "f32", **kw):
    """(JAX model, its variables, the port's model on the same weights)."""
    jdt, tdt = DTYPES[dtype]
    variables = _jax_variables(norm, size)
    jmodel = jax_resnet.ResNet(**ARCH, norm=norm, use_pallas_head=pallas, dtype=jdt, **kw)
    tmodel = resnet.ResNet(**ARCH, norm=norm, use_pallas_head=pallas, dtype=tdt, **kw)
    sd = interop.resnet_params_from_jax(variables["params"], variables.get("batch_stats"))
    if kw.get("return_features"):  # no head
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, variables, tmodel


def _jax_apply(jmodel, variables, x, train: bool):
    """Logits (and the new batch_stats in train mode with BatchNorm)."""
    if train and "batch_stats" in variables:
        return jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    return jmodel.apply(variables, jnp.asarray(x), train=train), None


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("n,k,s", [(56, 3, 2), (33, 3, 2), (56, 1, 2), (9, 3, 2), (8, 3, 1),
                                   (112, 3, 2), (17, 1, 1), (224, 7, 2)])
def test_same_pads_are_xlas(n, k, s):
    assert resnet.same_pads(n, k, s) == tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_even_input_pads_low_zero_high_one():
    assert resnet.same_pads(56, 3, 2) == (0, 1) and resnet.same_pads(33, 3, 2) == (1, 1)


@pytest.mark.parametrize("pallas", [False, True], ids=["dense-head", "fused-head"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("size", [32, 33])
def test_logits_match_jax(size, norm, train, pallas):
    jmodel, variables, tmodel = _pair(norm, size, pallas)
    x = _images(size, seed=1)
    want, new_vars = _jax_apply(jmodel, variables, x, train)
    got = tmodel(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (BATCH, ARCH["num_classes"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if new_vars is not None:
        stats = interop.resnet_params_from_jax({}, jax.device_get(new_vars["batch_stats"]))
        buffers = dict(tmodel.named_buffers())
        assert set(stats) == set(buffers)
        for name, value in stats.items():
            np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_running_statistics_move_in_train_mode_only(norm):
    _, _, tmodel = _pair(norm, 32, False)
    before = {k: v.clone() for k, v in tmodel.named_buffers()}
    tmodel(torch.from_numpy(_images(32)), train=False)
    assert all(torch.equal(v, before[k]) for k, v in tmodel.named_buffers())
    tmodel(torch.from_numpy(_images(32)), train=True)
    moved = [k for k, v in tmodel.named_buffers() if not torch.equal(v, before[k])]
    assert (len(moved) == len(before)) if norm == "batch" else not before


@pytest.mark.parametrize("pallas", [False, True], ids=["dense-head", "fused-head"])
@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("size", [32, 33])
def test_gradients_match_jax(size, norm, pallas):
    jmodel, variables, tmodel = _pair(norm, size, pallas)
    x = _images(size, seed=2)
    r = np.random.default_rng(3).standard_normal((BATCH, ARCH["num_classes"])).astype(np.float32)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        out = jmodel.apply({"params": params, **rest}, jnp.asarray(x), train=True,
                           mutable=list(rest))
        return jnp.sum(out[0] * r)

    grads = interop.resnet_params_from_jax(jax.device_get(jax.grad(loss)(variables["params"])))
    (tmodel(torch.from_numpy(x), train=True) * torch.from_numpy(r)).sum().backward()
    named = dict(tmodel.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        got = named[name].grad.numpy()
        scale = float(np.abs(g.numpy()).max())
        assert scale > 0, name  # every branch reaches the logits
        assert np.abs(got - g.numpy()).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_logits_match_jax(train):
    jmodel, variables, tmodel = _pair("batch", 32, True, dtype="bf16")
    x = _images(32, seed=4)
    want, _ = _jax_apply(jmodel, variables, x, train)
    got = tmodel(torch.from_numpy(x), train=train)
    want = _f32(want)
    assert got.dtype == torch.float32  # the head is f32 in both
    assert np.abs(got.detach().numpy() - want).max() <= 2**-5 * np.abs(want).max()


@pytest.mark.parametrize("size", [32, 33])
def test_return_features_match_jax_in_nhwc(size):
    jmodel, variables, tmodel = _pair("batch", size, False, return_features=True)
    x = _images(size, seed=5)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    got = tmodel(torch.from_numpy(x), train=False)
    assert sorted(got) == sorted(want) == ["C2", "C3"]
    for name, value in want.items():
        assert got[name].shape == value.shape  # NHWC
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(value), rtol=0, atol=1e-4)


def test_fold_batchnorm_matches_jax():
    _, variables, tmodel = _pair("batch", 32, False)
    x = _images(32, seed=6)
    # Move the statistics off their initial values first (one train step).
    jmodel = jax_resnet.ResNet(**ARCH)
    _, new = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tmodel(torch.from_numpy(x), train=True)
    stats = jax.device_get(new["batch_stats"])
    jfolded = jax.device_get(jax_resnet.fold_batchnorm(variables["params"], stats))
    want_sd = interop.resnet_params_from_jax(jfolded)
    got_sd = resnet.fold_batchnorm(tmodel.state_dict())
    assert set(got_sd) == set(want_sd)
    for name, value in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    folded = resnet.ResNet(**ARCH, norm="folded")
    folded.load_state_dict(got_sd, strict=True)
    want = jax_resnet.ResNet(**ARCH, norm="folded").apply({"params": jfolded}, jnp.asarray(x),
                                                          train=False)
    np.testing.assert_allclose(folded(torch.from_numpy(x), train=False).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)
    # Folding is exact up to f32 rounding: the folded model's logits are the
    # batch model's eval-mode logits.
    np.testing.assert_allclose(folded(torch.from_numpy(x), train=False).detach().numpy(),
                               tmodel(torch.from_numpy(x), train=False).detach().numpy(),
                               rtol=0, atol=1e-4)


def test_folded_model_refuses_train_mode():
    model = resnet.ResNet(**ARCH, norm="folded")
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros(1, 32, 32, 3), train=True)
    with pytest.raises(ValueError, match="unknown norm"):
        resnet.ResNet(**ARCH, norm="layer")


def test_interop_shapes_and_names():
    variables = _jax_variables("batch", 32)
    sd = interop.resnet_params_from_jax(variables["params"], variables["batch_stats"])
    kernel = variables["params"]["stage1_block1"]["conv2"]["kernel"]  # [kh, kw, in, out]
    assert sd["stage1_block1.conv2.weight"].shape == (kernel.shape[3], kernel.shape[2], 3, 3)
    np.testing.assert_array_equal(sd["stage1_block1.conv2.weight"].numpy(),
                                  np.asarray(kernel).transpose(3, 2, 0, 1))
    assert sd["head.kernel"].shape == (4 * 2 * ARCH["num_filters"], ARCH["num_classes"])
    assert "bn_init.mean" in sd and "stage2_block1.bn_proj.var" in sd
    gsd = interop.resnet_params_from_jax(_jax_variables("group", 32)["params"])
    assert "stage1_block1.bn1.weight" in gsd and not any(".gn." in k for k in gsd)


def test_initialisation_follows_flax():
    model = resnet.ResNet(**ARCH, generator=torch.Generator().manual_seed(0))
    w = model.stage1_block1.conv2.weight  # fan-in 3 * 3 * 8
    std = (1.0 / (9 * 8)) ** 0.5
    assert abs(w.std().item() - std) < 0.15 * std and w.abs().max() <= 2 * std / 0.8796 + 1e-6
    assert torch.all(model.stage1_block1.bn3.weight == 0)  # each block starts as identity
    assert torch.all(model.stage1_block1.bn1.weight == 1)
    assert torch.all(model.bn_init.var == 1) and torch.all(model.bn_init.mean == 0)
    assert torch.all(model.head.bias == 0)


@pytest.mark.parametrize("depth", [(3, 4, 6, 3), (1, 1)])
def test_train_flops_count_the_head_once_either_way(depth):
    arch = dict(stage_sizes=depth, dtype=torch.bfloat16)
    kernel = resnet.train_flops({**arch, "use_pallas_head": True}, (8, 64, 64, 3))
    plain = resnet.train_flops({**arch, "use_pallas_head": False}, (8, 64, 64, 3))
    assert kernel == plain == 8 * resnet.train_flops(arch, (1, 64, 64, 3))
    head = 3 * 2 * 8 * (64 * 2 ** (len(depth) - 1) * 4) * 1000
    assert plain > head
