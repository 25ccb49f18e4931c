"""The 14 lint rules the port retargets at its own idiom, and DLC601's torch
extension: for each, one torch fixture that fires and one that does not.

DLC003/DLC008 (ungated) and DLC400-405 / DLC500-505 (the ``sharding`` and
``comms`` gates) keep the JAX package's ids, names and gates; their matchers
find the same bug class in CUDA-graph capture, in-place state, DTensor and
FSDP2, and ``donate_buffers``.  DLC502 fires on the gather that
``train/reshard.py``'s ``_move`` once made (``src = src.full_tensor()``, then
a slice of the whole), the code that killed the process over gloo.
"""

import textwrap

import pytest

from deeplearning_cfn_tpu_torch.analysis import FILE_RULES, lint_source
from deeplearning_cfn_tpu_torch.analysis.sharding import canonical_mesh_axes

TRAIN = "deeplearning_cfn_tpu_torch/train/x.py"
CHAOS = "deeplearning_cfn_tpu_torch/chaos/x.py"


def rules_for(src: str, rule: str, path: str = TRAIN) -> list[str]:
    return [v.rule for v in lint_source(path, textwrap.dedent(src), select={rule})]


CAPTURE = """\
    import torch

    def step(graph, x, w):
        with torch.cuda.graph(graph):
            y = x @ w
            {line}
        return y
"""

# rule -> (firing fixture, silent fixture, how many findings the first gives)
CASES = {
    "DLC003": (
        CAPTURE.format(line="s = y.sum().item()"),
        """\
        import torch

        def step(graph, x, w):
            with torch.cuda.graph(graph):
                y = x @ w
            return y.sum().item()
        """,
        1,
    ),
    "DLC008": (
        """\
        def train_step(state, grads, lr):
            for p, g in zip(state.params, grads):
                p.data = p.data - lr * g
            state.params = state.params * 0.5
            return state
        """,
        """\
        import torch

        def train_step(state, grads, lr):
            torch._foreach_add_(state.params, grads, alpha=-lr)
            state.step += 1
            return state
        """,
        2,
    ),
    "DLC400": (
        """\
        import time
        import numpy as np
        import torch

        class CapturedSteps:
            def _run(self, state, n):
                t0 = time.time()
                noise = torch.randn(4)
                drop = np.random.rand(3)
                return t0, noise, drop
        """,
        """\
        import time
        import torch

        class CapturedSteps:
            def _run(self, state, n):
                return torch.randn(4, generator=self.gen)

        def outside():
            return time.time(), torch.randn(4)
        """,
        3,
    ),
    "DLC401": (
        """\
        def restore(train_state, sd):
            train_state.optimizer.load_state_dict(sd["opt"])
            train_state.model.weight.data = sd["w"]
        """,
        """\
        def restore(train_state, sd):
            train_state.model.weight.copy_(sd["w"])

        def eval_step(state, x):
            state.cache.data = x
        """,
        2,
    ),
    "DLC402": (
        """\
        import torch

        def decode(x, lr: float = 0.1, greedy: bool = True):
            return x * lr if greedy else x

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = decode(x)
            return y
        """,
        """\
        import torch

        def decode(x, lrs, i: int = 0):
            return x * lrs[i]

        def capture(graph, x, lrs):
            with torch.cuda.graph(graph):
                y = decode(x, lrs)
            return y
        """,
        2,
    ),
    "DLC403": (
        """\
        def groups(mesh):
            return mesh["fspd"], mesh.get_group("data"), mesh["dp", "tpp"]
        """,
        """\
        def groups(mesh):
            return mesh["fsdp"], mesh.get_group("dp"), mesh["dp", "fsdp"]
        """,
        3,
    ),
    "DLC404": (
        """\
        def fit(trainer, state, batches):
            for x, y in batches:
                state, m = trainer.train_step(state, x, y)
                print(m["loss"].item())
        """,
        """\
        def fit(trainer, state, batches, every):
            for i, (x, y) in enumerate(batches):
                state, m = trainer.train_step(state, x, y)
                if i % every == 0:
                    print(m["loss"].item())
        """,
        1,
    ),
    "DLC405": (
        CAPTURE.format(line="z = torch.ones(3).cuda() + y.to(device)"),
        CAPTURE.format(line="z = y.to(torch.float32)"),
        2,
    ),
    "DLC500": (
        """\
        from torch.distributed.tensor import Shard, Replicate, distribute_tensor

        def place(t, mesh, fn):
            a = distribute_tensor(t, mesh["fdsp"], [Shard(0)])
            return local_map(fn, in_placements=([Shard(0)],), out_placements=[Replicate()])
        """,
        """\
        from torch.distributed.tensor import Shard, distribute_tensor

        def place(t, mesh, fn):
            a = distribute_tensor(t, mesh["fsdp"], [Shard(0)])
            return local_map(fn, in_placements=([Shard(0)],), out_placements=[Shard(0)])
        """,
        2,
    ),
    "DLC501": (
        """\
        from torch.distributed.tensor import distribute_tensor, Shard

        def mlp(x, w1, w2, mesh):
            w1 = distribute_tensor(w1, mesh, [Shard(1)])
            h = x @ w1
            return h @ w2
        """,
        """\
        from torch.distributed.tensor import distribute_tensor, Replicate, Shard

        def mlp(x, w1, w2, mesh):
            w1 = distribute_tensor(w1, mesh, [Shard(1)])
            h = x @ w1
            h = h.redistribute(mesh, [Replicate()])
            return h @ w2
        """,
        1,
    ),
    "DLC502": (
        """\
        import numpy as np

        def show(t, mesh):
            a = t.full_tensor().cpu()
            b = np.asarray(t.redistribute(mesh, [Replicate()]))
            return a, b
        """,
        """\
        def show(t):
            return t.to_local().cpu(), t.full_tensor()
        """,
        2,
    ),
    "DLC503": (
        """\
        def resume(trainer, state, xs, ys, mesh2):
            kfn = trainer.multi_step_fn(2)
            state, _ = kfn(state, xs, ys)
            trainer.rebind_mesh(mesh2)
            state, _ = kfn(state, xs, ys)
        """,
        """\
        def resume(trainer, state, xs, ys, mesh2):
            kfn = trainer.multi_step_fn(2)
            state, _ = kfn(state, xs, ys)
            trainer.rebind_mesh(mesh2)
            kfn = trainer.multi_step_fn(2)
            state, _ = kfn(state, xs, ys)
        """,
        1,
    ),
    "DLC504": (
        """\
        def grad_norm(g):
            local = g.to_local()
            return local.pow(2).sum() + g.to_local().norm()
        """,
        """\
        import torch.distributed as dist

        def grad_norm(g, group):
            total = g.to_local().pow(2).sum()
            dist.all_reduce(total, group=group)
            return total
        """,
        2,
    ),
    "DLC505": (
        """\
        from deeplearning_cfn_tpu_torch.train.data import donate_buffers

        def call(kfn, state, x, y):
            state, loss = kfn(state, x, y)
            donate_buffers((x, y))
            return loss, x.shape
        """,
        """\
        from deeplearning_cfn_tpu_torch.train.data import donate_buffers

        def call(kfn, state, x, y):
            state, loss = kfn(state, x, y)
            shape = x.shape
            donate_buffers((x, y))
            x = None
            return loss, shape, x
        """,
        1,
    ),
}

# train/reshard.py's _move as it stood before its gather was removed
# (its body, unchanged): the whole of every sharded leaf gathered on every
# rank, then the rank's region sliced out of it.
RESHARD_MOVE = '''\
@torch.no_grad()
def _move(state: Any, new: Any, group: Any) -> Any:
    old = _flat(state.state_dict())
    targets = _flat(new.state_dict()) if new is not None else {}
    local = 1 if new is None else int(all(_region(targets[k]) == _region(v)
                                          for k, v in old.items()))
    gather = not _agree(local, group)
    for key in sorted(old):
        src = old[key]
        if gather and hasattr(src, "device_mesh"):
            src = src.full_tensor()
            region = tuple(slice(0, n) for n in src.shape)
        else:
            src, region = local_part(src), _region(src)
        if new is None:
            continue
        dst = targets[key]
        want = _region(dst)
        part = src[tuple(slice(w.start - r.start, w.stop - r.start)
                         for w, r in zip(want, region))]
        local_part(dst).copy_(part)
    return new
'''


@pytest.mark.parametrize("rule", sorted(CASES))
def test_retargeted_rule_fires(rule):
    fire, _, n = CASES[rule]
    assert rules_for(fire, rule) == [rule] * n


@pytest.mark.parametrize("rule", sorted(CASES))
def test_retargeted_rule_stays_silent_on_the_idiom(rule):
    _, quiet, _ = CASES[rule]
    assert rules_for(quiet, rule) == []


def test_dlc502_fires_on_the_removed_reshard_gather():
    found = lint_source("deeplearning_cfn_tpu_torch/train/reshard.py", RESHARD_MOVE,
                        select={"DLC502"})
    assert [v.rule for v in found] == ["DLC502"]
    assert "src = ....full_tensor()" in found[0].message
    assert "a slice of it" in found[0].message


def test_captured_scope_closes_over_same_file_calls():
    """``paged_decode_logits`` is a captured root; a helper it calls by bare
    name, and a method a captured body calls through ``self``, are
    captured too."""
    src = """\
        def helper(x):
            return x.tolist()

        def paged_decode_logits(model, x):
            return helper(x)

        class CapturedDecode:
            def __init__(self, graph, x):
                with torch.cuda.graph(graph):
                    self.out = self._body(x)

            def _body(self, x):
                return x.cpu()

            def read(self):
                return self.out.cpu()
        """
    found = lint_source("deeplearning_cfn_tpu_torch/serve/x.py", textwrap.dedent(src),
                        select={"DLC003"})
    assert [(v.rule, v.line) for v in found] == [("DLC003", 2), ("DLC003", 13)]


def test_compute_rules_scope_to_the_compute_tree():
    fire = CASES["DLC400"][0]
    assert rules_for(fire, "DLC400", path="deeplearning_cfn_tpu_torch/cluster/x.py") == []
    assert rules_for(CASES["DLC504"][0], "DLC504",
                     path="deeplearning_cfn_tpu_torch/obs/x.py") == []


def test_mesh_axes_are_read_from_the_ports_mesh():
    from deeplearning_cfn_tpu_torch.parallel.mesh import AXIS_ORDER

    assert canonical_mesh_axes() == AXIS_ORDER


def test_dlc601_flags_torch_global_generator_draws():
    fire = """\
        import torch

        def jitter(n, t):
            a = torch.rand(n)
            b = torch.randperm(n)
            t.normal_()
            return a, b, torch.randint(0, 9, (n,))
        """
    quiet = """\
        import torch

        def jitter(n, t, seed):
            g = torch.Generator().manual_seed(seed)
            t.normal_(generator=g)
            return torch.rand(n, generator=g), torch.randperm(n, generator=g)
        """
    found = lint_source(CHAOS, textwrap.dedent(fire), select={"DLC601"})
    assert [v.rule for v in found] == ["DLC601"] * 4
    assert all("torch's global generator" in v.message for v in found)
    assert rules_for(quiet, "DLC601", path=CHAOS) == []
    # Out of the determinism tree, as every DLC6xx rule.
    assert rules_for(fire, "DLC601") == []


def test_every_retargeted_rule_is_registered_under_its_gate():
    gates = {r: FILE_RULES[r].gate for r in CASES}
    assert gates == {**{r: None for r in ("DLC003", "DLC008")},
                     **{f"DLC40{i}": "sharding" for i in range(6)},
                     **{f"DLC50{i}": "comms" for i in range(6)}}
