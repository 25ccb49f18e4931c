"""ResNet-50 v1.5 and its training step, plain PyTorch.

He et al., arXiv:1512.03385, Table 1 (50-layer: bottleneck stages of 3, 4,
6 and 3 blocks at 64·2^i filters, expansion 4), with the stride of each
stage's first block on its 3×3 convolution (v1.5, as NVIDIA's and Flax's
ResNet-50 put it), a 1×1 projection where the shape changes, batch
normalisation after every convolution (statistics of the whole batch,
ε 1e-5), a zero-initialised scale on each block's last norm (Goyal et
al., arXiv:1706.02677), global average pooling and a dense head.  Padding
follows XLA's ``SAME`` rule (``total = max((ceil(n/s)−1)·s + k − n, 0)``,
``lo = total // 2``), the stem pads 3 a side and the 3×3/2 max-pool pads
with −inf.  Images are ``[B, H, W, 3]``, normalised by the caller.

The step is SGD with Nesterov momentum (``t = μt + g``, ``p −= lr(g +
μt)``), on the label-smoothed cross-entropy, as the configuration's
``training`` block states.  ``train`` recomputes every block in the
backward (``checkpoint_blocks``), so that a global batch of 1,024 fits;
``portbench/flops.py`` counts the step without the recompute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.lowp import Products

EPS = 1e-5


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ReferenceResNet:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.blocks: list[tuple[str, int, int, int]] = []  # (name, in, filters, stride)
        ch, f0 = cfg["num_filters"], cfg["num_filters"]
        for i, count in enumerate(cfg["stage_sizes"]):
            for j in range(count):
                filters = f0 * 2 ** i
                self.blocks.append((f"stage{i + 1}_block{j + 1}", ch, filters,
                                    2 if i > 0 and j == 0 else 1))
                ch = cfg["expansion"] * filters
        self.features = ch

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        e, f0 = self.cfg["expansion"], self.cfg["num_filters"]
        shapes = {"conv_init.weight": (f0, 3, 7, 7), "bn_init.weight": (f0,), "bn_init.bias": (f0,)}
        for name, cin, f, s in self.blocks:
            for conv, bn, (o, i, k) in (("conv1", "bn1", (f, cin, 1)), ("conv2", "bn2", (f, f, 3)),
                                        ("conv3", "bn3", (e * f, f, 1))):
                shapes[f"{name}.{conv}.weight"] = (o, i, k, k)
                shapes[f"{name}.{bn}.weight"] = shapes[f"{name}.{bn}.bias"] = (o,)
            if cin != e * f or s != 1:
                shapes[f"{name}.conv_proj.weight"] = (e * f, cin, 1, 1)
                shapes[f"{name}.bn_proj.weight"] = shapes[f"{name}.bn_proj.bias"] = (e * f,)
        shapes["head.kernel"] = (self.features, self.cfg["num_classes"])
        shapes["head.bias"] = (self.cfg["num_classes"],)
        return shapes

    @staticmethod
    def initial_value(name: str) -> float | None:
        """The constant a leaf starts at, or None for a drawn one (the
        convolutions and the head's kernel)."""
        if name.endswith("bn3.weight"):
            return 0.0
        if ".bn" in name or name.startswith("bn_init"):
            return 1.0 if name.endswith(".weight") else 0.0
        if name == "head.bias":
            return 0.0
        return None

    @staticmethod
    def fan_in(shape) -> int:
        n = 1
        for s in shape[1:] if len(shape) == 4 else shape[:1]:
            n *= s
        return n

    def _conv(self, x, w, stride, prod: Products, pads=None):
        k = w.shape[-1]
        if pads is None:
            pads = [same_pads(n, k, stride) for n in x.shape[2:]]
        x = F.pad(x, (*pads[1], *pads[0]))
        return prod.conv(x, w, stride, 0)

    @staticmethod
    def _bn(x, w, b):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + EPS) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    def _block(self, x, p: dict, stride: int, prod: Products):
        y = torch.relu(self._bn(self._conv(x, p["conv1.weight"], 1, prod),
                                p["bn1.weight"], p["bn1.bias"]))
        y = torch.relu(self._bn(self._conv(y, p["conv2.weight"], stride, prod),
                                p["bn2.weight"], p["bn2.bias"]))
        y = self._bn(self._conv(y, p["conv3.weight"], 1, prod), p["bn3.weight"], p["bn3.bias"])
        if "conv_proj.weight" in p:
            x = self._bn(self._conv(x, p["conv_proj.weight"], stride, prod),
                         p["bn_proj.weight"], p["bn_proj.bias"])
        return torch.relu(x + y)

    def logits(self, params: dict, x: torch.Tensor, prod: Products | None = None,
               checkpoint_blocks: bool = False) -> torch.Tensor:
        prod = prod or Products("f32")
        x = x.permute(0, 3, 1, 2)
        x = self._conv(x, params["conv_init.weight"], 2, prod, pads=[(3, 3), (3, 3)])
        x = torch.relu(self._bn(x, params["bn_init.weight"], params["bn_init.bias"]))
        ph, pw = (same_pads(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (*pw, *ph), value=float("-inf")), 3, 2)
        for name, _, _, stride in self.blocks:
            p = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}
            if checkpoint_blocks:
                x = checkpoint(self._block, x, p, stride, prod, use_reentrant=False)
            else:
                x = self._block(x, p, stride, prod)
        x = x.mean(dim=(2, 3))
        return prod.mm(x, params["head.kernel"]) + params["head.bias"]

    def loss(self, params: dict, x, y, label_smoothing: float, prod: Products | None = None,
             checkpoint_blocks: bool = False) -> torch.Tensor:
        logits = self.logits(params, x, prod, checkpoint_blocks)
        return F.cross_entropy(logits, y.long(), label_smoothing=label_smoothing)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """``(x/255 − mean)/std`` per channel, in f32."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def train(cfg: dict, weights: dict, batches, steps: int, precision: str = "f32",
          rows: slice | None = None) -> dict:
    """``steps`` Nesterov-momentum steps from ``weights`` on ``batches``
    (``(uint8 images [B, H, W, 3], labels [B])`` device tensors).  Returns the
    loss of each step, each leaf's momentum trace after the last step (the
    optimizer's state, which the program's captured call leaves to be read),
    and each leaf's change.  ``rows`` keeps only those rows (a planted
    fault)."""
    tr = cfg["training"]
    model = ReferenceResNet(cfg)
    prod = Products(precision)
    params = {n: w.detach().float().clone().requires_grad_(True) for n, w in weights.items()}
    trace = {n: torch.zeros_like(p) for n, p in params.items()}
    mu, lr = tr["momentum"], tr["learning_rate"]
    losses = []
    for x, y in batches[:steps]:
        if rows is not None:
            x, y = x[rows], y[rows]
        loss = model.loss(params, normalize(x, *tr["input_stats"]), y, tr["label_smoothing"],
                          prod, checkpoint_blocks=True)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad
                trace[n].mul_(mu).add_(g)
                p.sub_(lr * (g + mu * trace[n]))
                p.grad = None
    with torch.no_grad():
        change = {n: float((p - weights[n].float()).norm()) for n, p in params.items()}
        traces = {n: float(t.norm()) for n, t in trace.items()}
    return {"losses": losses, "trace": traces, "change": change}
