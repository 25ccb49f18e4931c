"""Llama-3-family decoder — counterpart of ``deeplearning_cfn_tpu/models/llama.py``.

The same model as the JAX package's: GQA + RoPE + RMSNorm + SwiGLU, compute
in ``cfg.dtype`` (bf16) with the softmax, norms and SiLU in f32, optional
tied embeddings and fused q/k/v and gate/up projections.  In PyTorch idiom:

- An ``nn.Module`` with one ``LlamaBlock`` per layer in place of the stacked
  ``[L, ...]`` parameters and ``lax.scan``; the leaf names are the JAX
  package's (``attn_norm``, ``wq`` ... ``w_down``, ``embed``, ``final_norm``,
  ``output``), so the weight-decay mask reads the same.  Weights keep the
  ``[in, out]`` orientation: the forward is ``x @ W``.
- Remat per layer: ``"full"`` recomputes the whole block in the backward;
  ``"dots"`` saves the outputs of ``aten.mm`` (the products without batch
  dims, as ``dots_with_no_batch_dims_saveable`` does) and recomputes the
  rest, the flash-attention forward included.  Under the trainer's remat
  of the whole loss (``train/remat.py``) "dots" blocks are checkpointed
  whole, so that the outer remat only lowers the peak, as in JAX.
- Attention dispatch (:func:`attention_kind`): ring attention when
  ``use_ring_attention`` is set and ``sp > 1``, the CUDA flash kernel at and
  above ``FLASH_CROSSOVER_SEQ`` on CUDA, materialised-score attention
  otherwise.
- Mixture of experts (``n_experts > 0``): each block's MLP is an
  ``ops.moe.MoE`` named ``moe`` (JAX's ``layers/moe`` leaves, ``[E, d, m]``);
  the blocks' aux losses are summed into the objective.
- :func:`param_specs`: each parameter's spec over the mesh axes, the JAX
  package's, less the stacked layer axis; the trainer reads the ``fsdp``,
  ``tp`` and ``ep`` dims from it.
- Over a mesh (``Llama(cfg, mesh=...)``), what GSPMD derives from the specs
  in JAX is explicit (``parallel/tensor_parallel.py``): under ``tp`` the
  blocks run their rank's heads and MLP columns (a sum over ``tp`` after
  ``wo`` and ``w_down``), the lookup and the loss are vocab-parallel (the
  logits are gathered over ``tp`` only for a caller that reads them); the
  fused ``wqkv``/``w_gate_up`` outputs are gathered and each rank takes its
  q, k, v (gate, up) columns, as GSPMD reshards at the split (whole outputs
  on every rank, their gradients summed whole: a known cost until each
  rank's columns are laid out together).  ``wk``/``wv`` keep JAX's spec
  when ``tp`` does not divide the kv heads: a rank's columns may hold part
  of a head, so k and v are gathered over ``tp`` (their gradients summed
  back) and each rank keeps the kv heads its ``n_heads/tp`` q heads read,
  expanded as JAX's ``_repeat_kv`` expands them.  Under ``sp`` each rank
  holds a block of the sequence: RoPE positions start at ``sp_rank × S/sp``;
  without ring attention k and v are gathered over ``sp`` and attended with
  the causal offset (what GSPMD gives the JAX "xla" path; the flash kernel,
  whose causal mask starts at row 0, takes the keys up to the block's end:
  past sp rank 0 it runs twice on the block's q rows, once over the keys
  before them unmasked and once over the diagonal block causally, the two
  merged by their lse, ``ops/flash_attention.py``); the loss leaves out
  only the global last position and divides by the global token count.
  ``tp`` must divide the heads, ``mlp_dim``, the vocabulary and the kv
  columns (``n_kv_heads × head_dim``).
  MoE blocks split their experts' columns over ``tp`` and route the ``sp``
  ranks' tokens as one group (``ops/moe.py``).

- Pipeline stages (``pp_stages > 1``, ``parallel/pipeline.py``): over a mesh
  whose ``pp`` is ``pp_stages``, each ``pp`` rank holds its stage's blocks
  (``layers.{i}`` by their global index, so the ranks' names together are
  the whole model's: JAX's stage-stacked ``[pp, L/pp, ...]`` tree is the
  same weights, ``pipeline.stack_stages`` of them) and a copy of the
  embedding, final norm and output, which JAX keeps replicated over ``pp``.
  The model's forward is also its stage's: stage 0 looks the tokens up, the
  last stage adds the final norm and the logits (tied to the embedding on
  m435), and GPipe runs ``pp_microbatches`` (default ``pp_stages``)
  microbatches through them; the MoE aux rides along as a ``[1]`` tensor a
  microbatch.  :func:`causal_lm_loss` runs the schedule with the backward:
  each microbatch's loss is its nll sum over the whole local batch's count,
  plus its aux over M, so that their sum is JAX's objective.  The
  trainer sums the gradients of the replicated parameters over ``pp``
  (the tied embedding's two parts among them).  Without a ``pp`` axis the
  stage-stacked model runs its layers in sequence, as JAX's does.  A
  stage's blocks run their ``tp`` and ``sp`` collectives inside the
  schedule; ring attention with stages is refused, as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from functools import partial
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.ops.attention import (
    dot_product_attention,
    rms_norm,
    rotary_embedding,
)
from deeplearning_cfn_tpu_torch.ops.flash_attention import (
    FLASH_CROSSOVER_SEQ,
    flash_attention,
    flash_attention_reference,
)
from deeplearning_cfn_tpu_torch.ops.moe import MoE, MoEConfig, moe_param_specs
from deeplearning_cfn_tpu_torch.parallel import pipeline
from deeplearning_cfn_tpu_torch.parallel.ring_attention import ring_attention
from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import (
    ModelParallel,
    local,
    model_parallel,
)
from deeplearning_cfn_tpu_torch.train.remat import carry_into_recompute, under_outer_remat


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    # "full": recompute the whole block in the backward (lowest memory);
    # "dots": save the matmul outputs, recompute the rest.
    remat_policy: str = "full"
    tied_embeddings: bool = False
    use_flash_attention: bool = False
    fused_qkv: bool = False
    # Mixture of experts (ops/moe.py): n_experts > 0 replaces each block's
    # SwiGLU with a top-k routed expert bank.  0 = dense.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Ring attention over sp (parallel/ring_attention.py) in place of
    # k/v gathered over sp; used only when the mesh's sp > 1.
    use_ring_attention: bool = False
    # Pipeline stages (parallel/pipeline.py): over a mesh whose pp is
    # pp_stages, each pp rank holds n_layers / pp_stages blocks and GPipe runs
    # pp_microbatches microbatches (0 = pp_stages) through them.
    pp_stages: int = 1
    pp_microbatches: int = 0

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}")
        if self.n_experts > 0 and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, n_experts={self.n_experts}]")
        if self.pp_stages > 1:
            if self.n_layers % self.pp_stages:
                raise ValueError(f"n_layers={self.n_layers} not divisible by "
                                 f"pp_stages={self.pp_stages}")
            if self.use_ring_attention:
                raise ValueError(
                    "ring attention (manual sp collectives) cannot nest inside the pipeline "
                    "stages; use dense or flash attention with pp_stages > 1")

    @property
    def moe(self) -> MoEConfig | None:
        if self.n_experts <= 0:
            return None
        return MoEConfig(n_experts=self.n_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         aux_loss_weight=self.moe_aux_weight)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()  # the defaults are the 8B shape

    @classmethod
    def m435(cls, seq_len: int = 1024) -> "LlamaConfig":
        """The ~435M single-device training shape: head_dim 128 (8 heads),
        tied embeddings, flash attention, "dots" remat."""
        return cls(
            vocab_size=32000,
            dim=1024,
            n_layers=24,
            n_heads=8,
            n_kv_heads=8,
            mlp_dim=4096,
            max_seq_len=seq_len,
            tied_embeddings=True,
            use_flash_attention=True,
            remat_policy="dots",
        )

    @classmethod
    def b1(cls, seq_len: int = 1024) -> "LlamaConfig":
        """~1.1B: head_dim 128, flash attention, tied embeddings, full remat."""
        return cls(
            vocab_size=32000,
            dim=2048,
            n_layers=20,
            n_heads=16,
            n_kv_heads=16,
            mlp_dim=5632,
            max_seq_len=seq_len,
            tied_embeddings=True,
            use_flash_attention=True,
            remat_policy="full",
        )

    @classmethod
    def b3(cls, seq_len: int = 1024) -> "LlamaConfig":
        """~2.9B: the b1 conventions at a wider, deeper shape."""
        return cls(
            vocab_size=32000,
            dim=2560,
            n_layers=36,
            n_heads=20,
            n_kv_heads=20,
            mlp_dim=6912,
            max_seq_len=seq_len,
            tied_embeddings=True,
            use_flash_attention=True,
            remat_policy="full",
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256, seq_len: int = 128, **kw) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size,
            dim=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            mlp_dim=128,
            max_seq_len=seq_len,
            remat=False,
            tied_embeddings=True,
            **kw,
        )

    @classmethod
    def tiny_moe(cls, n_experts: int = 4, **kw) -> "LlamaConfig":
        return cls.tiny(n_experts=n_experts, **kw)


def _check_parallel(cfg: LlamaConfig, mp: ModelParallel, pp: int) -> None:
    if pp > 1 and cfg.pp_stages != pp:
        raise pipeline.PipelineError(
            f"the layers are stacked into {cfg.pp_stages} stages but mesh axis 'pp' is {pp}")
    for what, n in (("n_heads", cfg.n_heads), ("mlp_dim", cfg.mlp_dim),
                    ("vocab_size", cfg.vocab_size),
                    ("the kv columns (n_kv_heads x head_dim)", cfg.n_kv_heads * cfg.head_dim)):
        if n % mp.tp:
            raise ValueError(f"tp={mp.tp} must divide {what} ({n})")


# --- parameters ---------------------------------------------------------


def layer_param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes, in creation order."""
    d, hd = cfg.dim, cfg.head_dim
    shapes: dict[str, tuple[int, ...]] = {"attn_norm": (d,)}
    if cfg.fused_qkv:
        shapes["wqkv"] = (d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd)
    else:
        shapes["wq"] = (d, cfg.n_heads * hd)
        shapes["wk"] = (d, cfg.n_kv_heads * hd)
        shapes["wv"] = (d, cfg.n_kv_heads * hd)
    shapes["wo"] = (cfg.n_heads * hd, d)
    shapes["mlp_norm"] = (d,)
    if cfg.moe is not None:
        E, m = cfg.n_experts, cfg.mlp_dim
        shapes.update({"moe.router": (d, E), "moe.w_gate": (E, d, m), "moe.w_up": (E, d, m),
                       "moe.w_down": (E, m, d)})
    elif cfg.fused_qkv:
        shapes["w_gate_up"] = (d, 2 * cfg.mlp_dim)
    else:
        shapes["w_gate"] = (d, cfg.mlp_dim)
        shapes["w_up"] = (d, cfg.mlp_dim)
    if cfg.moe is None:
        shapes["w_down"] = (cfg.mlp_dim, d)
    return shapes


def _dense(shape, dtype, generator) -> nn.Parameter:
    """Normal / sqrt(fan_in), drawn in f32 on the generator's device (the
    CPU's unless the caller asks for another: a seed gives the same weights
    on any device), stored in ``dtype``.  With no generator, on the default
    device (``torch.device("meta")`` builds shapes only)."""
    device = generator.device if generator is not None else None
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return nn.Parameter((w / shape[0] ** 0.5).to(dtype))


def _ones(n: int) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=torch.float32))


# --- attention dispatch ---------------------------------------------------

# Set again in a remat recompute, which the card runs in autograd's thread.
_FORCED_KIND: contextvars.ContextVar[str | None] = carry_into_recompute(contextvars.ContextVar(
    "llama_forced_attention_kind", default=None
))
_KINDS = ("flash", "xla", "flash_reference")


@contextlib.contextmanager
def force_attention_kind(kind: str) -> Iterator[None]:
    """Override :func:`attention_kind` inside the block — for tests and for
    checking the kernel path against the plain one.  ``"flash_reference"``
    runs the plain PyTorch flash forward on any device."""
    if kind not in _KINDS:
        raise ValueError(f"attention kind must be one of {_KINDS}, got {kind!r}")
    token = _FORCED_KIND.set(kind)
    try:
        yield
    finally:
        _FORCED_KIND.reset(token)


def attention_kind(cfg: LlamaConfig, seq_len: int, device: torch.device | str,
                   sp: int = 1) -> str:
    """``"ring"`` when ``use_ring_attention`` is set and ``sp > 1``;
    ``"flash"`` (the CUDA kernel) on CUDA when ``use_flash_attention`` is set
    and ``seq_len`` (the whole sequence) ``>= FLASH_CROSSOVER_SEQ``;
    ``"xla"`` (materialised-score attention) otherwise, the CPU included, as
    the JAX package does off-TPU."""
    if cfg.use_ring_attention and sp > 1:
        return "ring"
    forced = _FORCED_KIND.get()
    if forced is not None:
        return forced
    if (
        cfg.use_flash_attention
        and torch.device(device).type == "cuda"
        and seq_len >= FLASH_CROSSOVER_SEQ
    ):
        return "flash"
    return "xla"


# --- modules --------------------------------------------------------------


class LlamaBlock(nn.Module):
    """One decoder block (the JAX package's ``_block``); under ``tp`` it
    runs its rank's heads and MLP columns."""

    def __init__(self, cfg: LlamaConfig, generator: torch.Generator | None = None,
                 mp: ModelParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.mp = mp or ModelParallel()
        for name, shape in layer_param_shapes(cfg).items():
            if name.startswith("moe."):
                continue
            if name.endswith("norm"):
                setattr(self, name, _ones(shape[0]))
            else:
                setattr(self, name, _dense(shape, cfg.dtype, generator))
        if cfg.moe is not None:
            self.moe = MoE(cfg.moe, cfg.dim, cfg.mlp_dim, cfg.dtype, generator, self.mp)

    def _attend(self, q, k, v) -> torch.Tensor:
        cfg, mp = self.cfg, self.mp
        kind = attention_kind(cfg, q.shape[1] * mp.sp, q.device, mp.sp)
        if kind == "ring":
            return ring_attention(q, k, v, mp.sp_group, causal=True)
        off = 0
        if mp.sp > 1:  # K and V gathered over sp, attended with this block's causal offset
            s = q.shape[1]
            off = mp.sp_rank * s
            k, v = mp.gather_sp(k), mp.gather_sp(v)
            if kind == "xla":
                q_pos = torch.arange(s, device=q.device) + off
                mask = torch.arange(s * mp.sp, device=q.device)[None, :] <= q_pos[:, None]
                return dot_product_attention(q, k, v, causal=False, mask=mask[None, None])
            k, v = k[:, :off + s], v[:, :off + s]  # the keys up to the block's end
        if kind == "flash":
            return flash_attention(q, k, v, causal=True, q_offset=off)
        if kind == "flash_reference":
            return flash_attention_reference(q, k, v, causal=True, q_offset=off)[0]
        return dot_product_attention(q, k, v, causal=True)

    def _kv_heads(self, kv: torch.Tensor, gathered: bool) -> torch.Tensor:
        """Under a ``tp`` that does not divide the kv heads: ``kv`` (this
        rank's columns, unless ``gathered``) gathered over ``tp`` and cut to
        the kv heads of this rank's q heads, one a q head (JAX's
        ``_repeat_kv`` of them)."""
        cfg, mp = self.cfg, self.mp
        B, S = kv.shape[:2]
        if not gathered:
            kv = mp.gather_tp(kv, sum_grads=True)
        whole = kv.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        nh = cfg.n_heads // mp.tp
        heads = torch.arange(mp.tp_rank * nh, (mp.tp_rank + 1) * nh, device=kv.device)
        return whole.index_select(2, heads // (cfg.n_heads // cfg.n_kv_heads))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The block's output; with MoE, ``(output, aux_loss)``."""
        cfg, mp = self.cfg, self.mp
        B, S, _ = x.shape
        hd = cfg.head_dim
        nh = cfg.n_heads // mp.tp  # this rank's q heads
        kv_split = cfg.n_kv_heads % mp.tp == 0  # else each rank reads whole kv heads
        h = mp.copy_to_tp(rms_norm(x, self.attn_norm, cfg.norm_eps))
        if cfg.fused_qkv:
            qkv = h @ local(self.wqkv)
            nq, nk = cfg.n_heads * hd, cfg.n_kv_heads * hd
            if mp.tp == 1:
                q, k, v = qkv[..., :nq], qkv[..., nq : nq + nk], qkv[..., nq + nk :]
            else:
                full = mp.gather_tp(qkv, sum_grads=True)
                if kv_split:
                    q, k, v = mp.own_columns(full, [nq, nk, nk])
                else:
                    (q,) = mp.own_columns(full[..., :nq], [nq])
                    k, v = full[..., nq : nq + nk], full[..., nq + nk :]
        else:
            q, k, v = h @ local(self.wq), h @ local(self.wk), h @ local(self.wv)
        q = q.reshape(B, S, nh, hd)
        if kv_split:
            k, v = (t.reshape(B, S, cfg.n_kv_heads // mp.tp, hd) for t in (k, v))
        else:  # the fused path gathered them whole already
            k, v = (self._kv_heads(t, gathered=cfg.fused_qkv) for t in (k, v))
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        attn = self._attend(q, k, v)
        x = x + mp.sum_over_tp(attn.reshape(B, S, nh * hd) @ local(self.wo))
        h = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        if cfg.moe is not None:
            y, aux = self.moe(h)
            return x + y, aux
        h = mp.copy_to_tp(h)
        m = cfg.mlp_dim // mp.tp
        if cfg.fused_qkv:
            gu = h @ local(self.w_gate_up)
            if mp.tp > 1:
                g, up = mp.own_columns(mp.gather_tp(gu, sum_grads=True), [cfg.mlp_dim] * 2)
            else:
                g, up = gu[..., :m], gu[..., m:]
            gate = F.silu(g.to(torch.float32)).to(h.dtype)
            return x + mp.sum_over_tp((gate * up) @ local(self.w_down))
        gate = F.silu((h @ local(self.w_gate)).to(torch.float32)).to(h.dtype)
        return x + mp.sum_over_tp((gate * (h @ local(self.w_up))) @ local(self.w_down))


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class Llama(nn.Module):
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` in the compute dtype (the
    loss converts inside its reductions, as the JAX package's does).  With
    a ``mesh`` whose ``sp`` > 1, tokens and logits are this rank's block of
    the sequence; the parameters are built whole, and the trainer lays them
    out over the mesh.  With a ``pp`` > 1 (``cfg.pp_stages``) the model holds
    this rank's stage of the blocks (every layer is drawn from the
    generator, so a seed gives the unstaged model's weights)."""

    # The JAX model stacks each layer weight into one [L, ...] leaf; the
    # per-leaf optimizers (lamb, adafactor) read layers.{i}.<name> as one.
    stacked_layers = True

    def __init__(self, cfg: LlamaConfig, generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mp = ModelParallel.from_mesh(mesh)
        self.mesh = mesh
        pp = mesh.size(mesh.mesh_dim_names.index("pp")) if mesh is not None else 1
        _check_parallel(cfg, self.mp, pp)
        self.n_stages = pp
        self.stage_index = mesh.get_local_rank("pp") if pp > 1 else 0
        self.embed = _dense((cfg.vocab_size, cfg.dim), cfg.dtype, generator)
        blocks = [LlamaBlock(cfg, generator, self.mp) for _ in range(cfg.n_layers)]
        if pp > 1:
            own = pipeline.stage_layers(cfg.n_layers, pp, self.stage_index)
            self.layers = nn.ModuleDict({str(i): blocks[i] for i in own})
        else:
            self.layers = nn.ModuleList(blocks)
        del blocks
        self.final_norm = _ones(cfg.dim)
        if not cfg.tied_embeddings:
            self.output = _dense((cfg.dim, cfg.vocab_size), cfg.dtype, generator)

    @property
    def pipelined(self) -> bool:
        """Whether the blocks are split over ``pp`` ranks (GPipe)."""
        return self.n_stages > 1

    @property
    def runs_own_backward(self) -> bool:
        """A pipelined model's loss runs the backward inside its schedule
        (``causal_lm_loss``); the trainer then calls no ``backward``."""
        return self.pipelined and torch.is_grad_enabled()

    @property
    def n_microbatches(self) -> int:
        return self.cfg.pp_microbatches or self.cfg.pp_stages

    def blocks(self) -> list[LlamaBlock]:
        """This rank's blocks, in layer order."""
        return list(self.layers.values() if isinstance(self.layers, nn.ModuleDict)
                    else self.layers)

    def replicated_over_pp(self, name: str) -> bool:
        """Whether parameter ``name`` is held by every pp rank (everything
        but the blocks), its gradient summed over them."""
        return not name.startswith("layers.")

    def _remat_kw(self) -> dict | None:
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return None
        kw = {"use_reentrant": False}
        # Under the trainer's remat of the whole loss the blocks are
        # checkpointed whole: "dots" caches would be held twice.
        if self.cfg.remat_policy == "dots" and not under_outer_remat():
            kw["context_fn"] = partial(create_selective_checkpoint_contexts, _save_matmuls)
        return kw

    def _run_blocks(self, x: torch.Tensor, aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device) + self.mp.sp_rank * S
        remat_kw = self._remat_kw()
        for layer in self.blocks():
            if remat_kw is None:
                x = layer(x, positions)
            else:
                x = checkpoint(layer, x, positions, **remat_kw)
            if self.cfg.moe is not None:
                x, layer_aux = x
                aux = aux + layer_aux
        return x, aux

    def _logits(self, x: torch.Tensor, gather_logits: bool) -> torch.Tensor:
        cfg, mp = self.cfg, self.mp
        x = mp.copy_to_tp(rms_norm(x, self.final_norm, cfg.norm_eps))
        if cfg.tied_embeddings:
            logits = x @ local(self.embed).to(cfg.dtype).T
        else:
            logits = x @ local(self.output)
        if gather_logits:
            logits = mp.gather_tp(logits, sum_grads=False)
        return logits

    def _stage_forward(self, x: torch.Tensor, aux: torch.Tensor | None):
        """This rank's stage on one microbatch: stage 0 takes tokens, the
        last returns vocab-parallel logits; with MoE ``(act, aux [1])``."""
        if self.stage_index == 0:
            x = self.mp.embed(x, local(self.embed).to(self.cfg.dtype))
        x, aux = self._run_blocks(x, aux)
        if self.stage_index == self.n_stages - 1:
            x = self._logits(x, gather_logits=False)
        return x if self.cfg.moe is None else (x, aux)

    def _pipelined_forward(self, tokens: torch.Tensor, gather_logits: bool):
        """The whole model through GPipe, forward only: the logits and the
        aux (summed over stages, averaged over microbatches) on every rank."""
        logits, aux = pipeline.pipeline_apply(self, tokens, self.mesh, self.n_microbatches,
                                              self.n_stages, aux=self.cfg.moe is not None)
        if gather_logits:
            logits = self.mp.gather_tp(logits, sum_grads=False)
        return logits, aux

    def forward(self, tokens: torch.Tensor, aux: torch.Tensor | None = None, *,
                return_aux: bool = False, gather_logits: bool = True):
        """Logits; with ``return_aux``, ``(logits, aux)``: the blocks' MoE
        balancing losses summed (0 for a dense model).  Under tp the logits
        are gathered over the vocabulary unless ``gather_logits`` is off
        (the loss's case: it is vocab-parallel).  A pipelined model called
        by its schedule runs its stage (``aux``: the carried MoE aux);
        called otherwise, it runs the whole pipeline, forward only."""
        if self.pipelined:
            if pipeline.in_stage():
                return self._stage_forward(tokens, aux)
            logits, aux = self._pipelined_forward(tokens, gather_logits)
            return (logits, aux) if return_aux else logits
        x = self.mp.embed(tokens, local(self.embed).to(self.cfg.dtype))
        x, aux = self._run_blocks(x, torch.zeros((), dtype=torch.float32, device=tokens.device))
        logits = self._logits(x, gather_logits)
        return (logits, aux) if return_aux else logits


def init_model(
    cfg: LlamaConfig, seed: int = 0, device: torch.device | str | None = None
) -> Llama:
    """A model with weights drawn from ``seed`` on the CPU, moved to
    ``device``: the card unless the CPU is asked for."""
    gen = torch.Generator().manual_seed(seed)
    return Llama(cfg, gen).to(resolve_device(device))


def param_count(cfg: LlamaConfig) -> int:
    per_layer = sum(_numel(s) for s in layer_param_shapes(cfg).values())
    total = cfg.vocab_size * cfg.dim + cfg.n_layers * per_layer + cfg.dim
    if not cfg.tied_embeddings:
        total += cfg.dim * cfg.vocab_size
    return total


def _numel(shape: tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def active_param_count(cfg: LlamaConfig) -> int:
    """Parameters a token flows through: MoE expert banks count at
    top_k/n_experts, the router and everything else fully."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    expert = 3 * cfg.n_layers * cfg.n_experts * cfg.dim * cfg.mlp_dim
    return total - expert + expert * cfg.moe_top_k // cfg.n_experts


def param_specs(cfg: LlamaConfig) -> dict[str, tuple]:
    """Each parameter's spec over the mesh axes (by ``named_parameters``
    name): the JAX package's ``param_specs`` less the stacked layer axis.
    FSDP shards the input dim of ``wq``/``wk``/``wv``/``w_gate``/``w_up``,
    the output dim of ``wo``/``w_down``, the model dim of ``embed``; experts
    split over ``ep``; norms and the router are replicated.  Under pipeline
    stages a block's spec is the same (its ``pp`` is the stage it lives on)."""
    layer = {"attn_norm": (None,), "wo": ("tp", "fsdp"), "mlp_norm": (None,)}
    if cfg.fused_qkv:
        layer["wqkv"] = ("fsdp", "tp")
    else:
        layer.update(wq=("fsdp", "tp"), wk=("fsdp", "tp"), wv=("fsdp", "tp"))
    if cfg.moe is not None:
        layer.update({f"moe.{k}": v for k, v in moe_param_specs().items()})
    elif cfg.fused_qkv:
        layer.update(w_gate_up=("fsdp", "tp"), w_down=("tp", "fsdp"))
    else:
        layer.update(w_gate=("fsdp", "tp"), w_up=("fsdp", "tp"), w_down=("tp", "fsdp"))
    specs = {"embed": ("tp", "fsdp"), "final_norm": (None,)}
    if not cfg.tied_embeddings:
        specs["output"] = ("fsdp", "tp")
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return specs


def train_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Analytic forward+backward FLOPs per trained token: 6N over the active
    parameters plus the causal attention term (12·L·dim·S halved)."""
    return 6.0 * active_param_count(cfg) + 6.0 * cfg.n_layers * cfg.dim * seq_len


# --- forward and loss -------------------------------------------------------


def forward_with_aux(model: Llama, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits in the compute dtype, aux loss): aux is the MoE balancing
    loss summed over layers, 0 for a dense model.  ``model`` may be the
    ``Llama`` or a wrapper that forwards keywords (DDP)."""
    return model(tokens, return_aux=True)


def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """f32 logits — the inspection/eval entry point."""
    return model(tokens).to(torch.float32)


def causal_lm_loss(
    model: Llama, tokens: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy, last position excluded (its rolled
    target wraps to the sequence start).  ``lse(logits) - gold`` with the
    logsumexp in f32, reading the compute-dtype logits; under tp
    vocab-parallel (``ModelParallel.nll``).  MoE models add the
    aux loss to the objective (not to perplexity) and report it as
    ``moe_aux_loss``.  Under ``sp`` each rank holds a block of the sequence:
    only the global last position is left out, each rank divides its sum by
    the global count, and the value is the sum over ``sp`` (the gradient
    each rank's own part, which the trainer sums over ``sp``)."""
    if getattr(model, "pipelined", False):
        return _pipelined_lm_loss(model, tokens, targets)
    logits, aux = model(tokens, return_aux=True, gather_logits=False)
    mp = model_parallel(model)
    nll = mp.nll(logits, targets)
    mask = torch.ones_like(nll)
    if mp.sp == 1:
        mask[:, -1] = 0.0
        loss = (nll * mask).sum() / mask.sum()
    else:
        if mp.sp_rank == mp.sp - 1:
            mask[:, -1] = 0.0
        count = nll.shape[0] * (nll.shape[1] * mp.sp - 1)
        loss = mp.sum_over_sp_value((nll * mask).sum() / count)
    metrics = {"perplexity": torch.exp(loss.detach())}
    if getattr(model, "module", model).cfg.moe is not None:  # DDP holds the Llama as .module
        metrics["moe_aux_loss"] = aux.detach()
    return loss + aux, metrics


def _pipelined_lm_loss(model: Llama, tokens: torch.Tensor,
                       targets: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`causal_lm_loss` of a pipelined model: GPipe over the pp ranks,
    the backward inside the schedule when gradients are enabled.  Microbatch
    m's loss is its nll sum over the local batch's count of scored positions
    plus its aux over M: their sum, and its gradient, are the unpipelined
    loss's.  Under ``sp`` the count is the whole sequence's and each rank's
    nll is its own part (its gradient too; the reported loss sums the parts
    over ``sp``).  The returned loss (the value on every pp rank) carries no
    graph."""
    cfg, mp = model.cfg, model.mp
    M = model.n_microbatches
    count = tokens.shape[0] * (tokens.shape[1] * mp.sp - 1)
    moe = cfg.moe is not None
    parts: list[torch.Tensor] = []

    def loss_fn(out, target):
        logits, aux = out if moe else (out, None)
        nll = mp.nll(logits, target)
        mask = torch.ones_like(nll)
        if mp.sp_rank == mp.sp - 1:
            mask[:, -1] = 0.0
        nll_part = (nll * mask).sum() / count
        aux_part = aux.sum() / M if moe else torch.zeros_like(nll_part)
        parts.append(torch.stack([nll_part.detach(), aux_part.detach()]))
        return nll_part + aux_part

    inputs = (tokens,)
    if moe:
        inputs += (torch.zeros(M, dtype=torch.float32, device=tokens.device),)
    if torch.is_grad_enabled():
        pipeline.run_schedule(model, inputs, model.mesh, M, model.n_stages,
                              loss_fn=loss_fn, target=targets)
    else:
        out = pipeline.run_schedule(model, inputs, model.mesh, M, model.n_stages)
        if out is not None:  # the last stage: the loss of each microbatch
            logits, aux = out if moe else (out, None)
            for m, (lg, tg) in enumerate(zip(pipeline.microbatch(logits, M),
                                             pipeline.microbatch(targets, M))):
                loss_fn(lg if not moe else (lg, aux[m:m + 1]), tg)
    last = model.stage_index == model.n_stages - 1
    total = torch.stack(parts).sum(0) if last else None
    if last and mp.sp > 1:  # the nll's parts over the sequence; the aux is the group's
        total = torch.stack([mp.sum_over_sp_value(total[0]), total[1]])
    # Every rank knows the layout: no object exchange (a captured step holds none).
    (total,) = pipeline.from_last_stage([total.to(torch.float32)] if last else None, model.mesh,
                                        layout=[((2,), torch.float32)])
    loss, aux = total[0], total[1]
    metrics = {"perplexity": torch.exp(loss)}
    if moe:
        metrics["moe_aux_loss"] = aux
    return loss + aux, metrics


def make_trainer(cfg: LlamaConfig, trainer_config, device: torch.device | str | None = None,
                 mesh=None):
    """Wire a Llama config into the Trainer: causal-LM loss, the model and
    the explicit parameter specs (:func:`param_specs`) over ``mesh`` when
    given, and the analytic FLOPs numerator (the flash kernel's work is
    counted analytically)."""
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    return Trainer(
        partial(Llama, cfg, mesh=mesh),
        trainer_config,
        loss_fn=causal_lm_loss,
        device=device,
        mesh=mesh,
        param_specs=param_specs(cfg),
        analytic_flops_fn=lambda x: (
            train_flops_per_token(cfg, x.shape[1]) * x.shape[0] * x.shape[1]
        ),
    )
