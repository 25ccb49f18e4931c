"""The port's AdamW (``torch.optim.AdamW``), LAMB and Adafactor against optax, as the JAX trainer
builds them (``_make_optimizer``: decay under ``decay_mask``, adafactor's
decay at ``weight_decay × learning_rate``).

The tree has a 1-D leaf, an unfactored matrix (< 128), a factored matrix
(>= 128 × >= 128), a masked (never decayed) factored matrix, and a stacked
``[3, 128, 160]`` leaf that the port holds as three ``layers.{i}.stack``
parameters of one ``Leaf``, as the JAX Llama stacks its layers.  Five steps
on the same numpy gradients, f32.  Tolerance: each update is a few f32
operations on O(1) values whose order differs from XLA's in places (the
norms' and means' sums), so parameters agree to 1e-6 absolute and the
adafactor statistics to 1e-6 relative after five steps.  ``torch.optim.AdamW``
decays ``p · (1 − lr·wd)`` before its Adam step, where optax adds ``wd · p``
to the update: the same function in another order, a few ulp of parameters
up to 4.5 apart (1.4e-6 seen), so adamw's parameters also get 1e-6 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxConfig
    from deeplearning_cfn_tpu.train.trainer import _make_optimizer as jax_make_optimizer
except ImportError:  # a host without JAX (the card's): only the port's own tests run
    jax = None

from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, optimizers, trainer  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

SHAPES = {"bias": (200,), "small": (64, 100), "w": (128, 256), "final_norm": (130, 140)}
STACK = (3, 128, 160)
STEPS = 5
ATOL = 1e-6
RTOL = {"adamw": 1e-6, "lamb": 0.0, "adafactor": 0.0}


class _Layer(torch.nn.Module):
    def __init__(self, value):
        super().__init__()
        self.stack = torch.nn.Parameter(torch.from_numpy(value.copy()))


class _Tree(torch.nn.Module):
    stacked_layers = True

    def __init__(self, tree):
        super().__init__()
        for name in SHAPES:
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(tree[name].copy())))
        self.layers = torch.nn.ModuleList(_Layer(a) for a in tree["layers"]["stack"])


def _tree(rng, scale=1.0):
    t = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    t["layers"] = {"stack": (rng.standard_normal(STACK) * scale).astype(np.float32)}
    return t


def _port_tree(model) -> dict:
    t = {k: getattr(model, k).detach().numpy().copy() for k in SHAPES}
    t["layers"] = {"stack": np.stack([layer.stack.detach().numpy() for layer in model.layers])}
    return t


def _run(name, lr=1e-2, wd=0.1, steps=STEPS, zero_grads=False):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.0 if zero_grads else 0.3) for _ in range(steps)]
    cfg = dict(optimizer=name, learning_rate=lr, weight_decay=wd)
    tx = jax_make_optimizer(JaxConfig(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    model = _Tree(params)
    t = trainer.Trainer(lambda g: model, trainer.TrainerConfig(**cfg), device="cpu")
    opt = trainer._make_optimizer(model, t.config, t._leaves(model))
    history = []
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        for name_, p in model.named_parameters():
            key = name_.split(".")
            p.grad = torch.from_numpy(
                g[key[0]].copy() if key[0] != "layers" else g["layers"]["stack"][int(key[1])].copy())
        opt.step()
        history.append((jax.device_get(jparams), _port_tree(model)))
    return history, state, opt, model


def _assert_close(ref, ours, rtol):
    for k in SHAPES:
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ours["layers"]["stack"], ref["layers"]["stack"], rtol=rtol,
                               atol=ATOL)


@needs_jax
@pytest.mark.parametrize("name", ["adamw", "lamb", "adafactor"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_steps_match_optax(name, wd):
    history, _, _, _ = _run(name, wd=wd)
    moved = False
    for ref, ours in history:
        _assert_close(ref, ours, RTOL[name])
        moved = moved or not np.allclose(ours["w"], history[0][1]["w"])
    assert moved


@needs_jax
def test_adafactor_factored_state_matches_optax():
    _, state, opt, model = _run("adafactor")
    fac = state[0]  # scale_by_factored_rms
    for k in SHAPES:
        p = getattr(model, k)
        st = opt.state[p]
        if k in ("w", "final_norm"):  # factored: rows and columns
            for stat in ("v_row", "v_col"):
                ref = np.asarray(getattr(fac, stat)[k])
                assert st[stat].shape == ref.shape, (k, stat)
                np.testing.assert_allclose(st[stat].numpy(), ref, rtol=1e-6, err_msg=k)
            assert "v" not in st
        else:  # the 1-D leaf and the matrix below 128: the full second moment
            assert st["v"].shape == p.shape and "v_row" not in st
            np.testing.assert_allclose(st["v"].numpy(), np.asarray(fac.v[k]), rtol=1e-6)
    for i, layer in enumerate(model.layers):  # stacked: per-layer statistics
        st = opt.state[layer.stack]
        for stat in ("v_row", "v_col"):
            ref = np.asarray(getattr(fac, stat)["layers"]["stack"])[i]
            assert st[stat].shape == ref.shape
            np.testing.assert_allclose(st[stat].numpy(), ref, rtol=1e-6)
    assert all(float(st["step"]) == STEPS for st in opt.state.values())


def test_leaves_group_the_stacked_layers():
    rng = np.random.default_rng(0)
    model = _Tree(_tree(rng))
    t = trainer.Trainer(lambda g: model, trainer.TrainerConfig(optimizer="lamb"), device="cpu")
    leaves = {tuple(leaf.shape): leaf for leaf in t._leaves(model)}
    assert leaves[STACK].stacked and len(leaves[STACK].params) == 3
    assert not leaves[(128, 256)].stacked and len(leaves[(128, 256)].params) == 1
    assert optimizers.factored_dims(STACK) == (1, 2)
    assert optimizers.factored_dims((64, 100)) is None and optimizers.factored_dims((200,)) is None


def test_adafactor_decay_magnitude_matches_adamw_semantics():
    """With zero gradients the first step only decays: adamw by lr·wd, and
    adafactor, after the trainer's translation, by the same (a unit-scale
    weight), as tests/test_weight_decay.py holds the JAX trainer to."""
    lr, wd = 3e-4, 0.1
    moved = {}
    for name in ("adamw", "adafactor"):
        model = torch.nn.Linear(256, 256, bias=False)
        with torch.no_grad():
            model.weight.fill_(1.0)
        cfg = trainer.TrainerConfig(optimizer=name, learning_rate=lr, weight_decay=wd)
        t = trainer.Trainer(lambda g: model, cfg, device="cpu")
        opt = trainer._make_optimizer(model, cfg, t._leaves(model))
        model.weight.grad = torch.zeros_like(model.weight)
        opt.step()
        moved[name] = 1.0 - float(model.weight[0, 0].detach())
    assert moved["adamw"] == pytest.approx(lr * wd, rel=1e-3)
    assert moved["adafactor"] == pytest.approx(moved["adamw"], rel=1e-3)


def test_adafactor_state_is_factored_and_lean():
    model = torch.nn.Linear(1024, 2048)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    param_bytes = nbytes(model.parameters())
    states = {}
    for name in ("adamw", "adafactor"):
        cfg = trainer.TrainerConfig(optimizer=name)
        opt = trainer._make_optimizer(model, cfg, trainer.Trainer(
            lambda g: model, cfg, device="cpu")._leaves(model))
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()  # makes the state
        states[name] = nbytes(v for st in opt.state.values() for v in st.values()
                              if isinstance(v, torch.Tensor) and v.ndim)
    assert states["adamw"] >= 2 * param_bytes
    assert states["adafactor"] < 0.1 * param_bytes


# --- on the card --------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "lamb", "adafactor"])
def test_captured_steps_match_eager_steps_on_card(cuda_device, name):
    """multi_step_fn(k) captures k steps of each optimizer as one CUDA graph
    (the learning rate and the step count read from device tensors); its
    losses and final parameters equal k eager steps from the same state, up
    to the order of a few f32 sums (1e-5)."""
    k = 3
    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=32, dtype=torch.float32)
    tcfg = trainer.TrainerConfig(optimizer=name, learning_rate=1e-3, weight_decay=0.1,
                                 grad_clip_norm=1.0, log_every=1)
    batches = list(data.SyntheticTokenDataset(seq_len=32, vocab_size=64, batch_size=4).batches(k))
    xs, ys = data.device_put_batch(next(data.stack_batches(iter(batches), k)), cuda_device)
    t = llama.make_trainer(cfg, tcfg, device=cuda_device)
    eager_state = t.init(seed=0)
    eager = []
    for i in range(k):
        eager_state, m = t.train_step(eager_state, xs[i], ys[i])
        eager.append(m["loss"].item())
    state = t.init(seed=0)
    kfn = t.multi_step_fn(k)
    assert isinstance(kfn, trainer.CapturedSteps)
    state, captured = kfn(state, xs, ys)
    np.testing.assert_allclose(captured.cpu().numpy(), eager, rtol=1e-5)
    for (n, a), b in zip(state.model.named_parameters(), eager_state.model.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().cpu().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert kfn.captures == 1 and state.step == k


@pytest.mark.parametrize("name,torch_name", [("float32", "highest"), ("tensorfloat32", "high"),
                                             ("bfloat16", "medium")])
def test_matmul_precision_is_scoped_to_the_steps(name, torch_name):
    """JAX's precision names map to PyTorch's f32 matmul precision inside
    the trainer's steps, and the setting is restored after each."""
    seen = []

    def loss_fn(model, x, y):
        seen.append(torch.get_float32_matmul_precision())
        return ((model(x) - y) ** 2).mean(), {}

    before = torch.get_float32_matmul_precision()
    t = trainer.Trainer(lambda g: torch.nn.Linear(4, 1),
                        trainer.TrainerConfig(optimizer="sgd", matmul_precision=name),
                        loss_fn=loss_fn, device="cpu")
    state = t.init(seed=0)
    t.train_step(state, torch.ones(2, 4), torch.zeros(2, 1))
    t.eval_step(state, torch.ones(2, 4), torch.zeros(2, 1))
    assert seen == [torch_name, torch_name]
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="matmul_precision"):
        with trainer.matmul_precision("fast"):
            pass
