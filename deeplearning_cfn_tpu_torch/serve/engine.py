"""Continuous-batching decode engine over the paged K/V pool — counterpart of
``deeplearning_cfn_tpu/serve/engine.py``.

Two step functions and one host-side scheduler:

- :func:`paged_prefill` — forward one (padded) prompt, write its K/V into
  the slot's pages and sample the first token.
- :func:`paged_decode_step` — advance every slot by one token in one call:
  write each slot's newest K/V to its pages, gather each slot's block table
  back into a contiguous context, attend under a per-slot validity mask,
  sample.  Slot occupancy, request lengths and page placement are data
  (inactive slots write to the pool's sink page), so every call has the
  same shapes.
- :class:`ContinuousBatchingEngine` — admits queued requests into free
  slots at step boundaries, decodes every active slot at once, retires
  finished requests, recycles their pages, and reports serve metrics
  (TTFT, inter-token latency, queue depth, tokens/s) on an injectable clock.

Both step functions update the pool in place, the counterpart of JAX's
``donate_argnums``, and run under ``torch.inference_mode()``.  The decode
math is ``models/llama_decode``'s op for op (the same projections, rotary,
attention and ``sample_token``, write-then-attend), so with a pool whose
gathered context equals ``generate``'s ``max_seq`` greedy tokens equal
``generate``'s.

**One decode program.**  JAX serves mixed-length traffic on one compiled
decode step.  Here, on a CUDA device, the engine captures the decode
forward once, at construction, as a CUDA graph over static input buffers
(tokens, lengths, tables, active) and the pool; every step copies its
inputs in and replays the graph (``decode_captures`` counts captures).  A
failed capture raises.  Sampling runs after the replay on the graph's
logits, from the engine's generator, so it is the eager step's arithmetic.
On the CPU, which cannot capture graphs, decode runs eagerly.  Prefill is
eager everywhere: one large forward per admission.

**Sampling keys.**  JAX passes one fixed key at every step; the port's
engine draws from one ``torch.Generator`` (seed 0) that advances.  Only
greedy decoding (temperature 0) is held to ``generate`` token for token.

Prefill/decode disaggregation (``serve/placement.py``): :func:`prefill_kv`
computes a prompt's K/V on a prefill device with local causal attention,
and :func:`scatter_prompt_kv` lands it in the decode device's pool.
"""

from __future__ import annotations

import copy
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from deeplearning_cfn_tpu_torch.models.llama import Llama
from deeplearning_cfn_tpu_torch.models.llama_decode import (
    check_decodable,
    embed,
    finish_block,
    logits_f32,
    project_qkv,
    sample_token,
)
from deeplearning_cfn_tpu_torch.ops.attention import dot_product_attention
from deeplearning_cfn_tpu_torch.serve.paged_cache import (
    BlockAllocator,
    PagedKVCache,
    init_paged_cache,
)


class ServeAdmissionError(ValueError):
    """A request the engine can never serve (or backpressure rejected):
    raised at submit(); an accepted request is never silently dropped."""


@dataclass(frozen=True)
class ServeConfig:
    """Host-side scheduler shape.  Everything the step functions need is
    carried by tensor shapes."""

    num_slots: int = 8
    block_size: int = 16
    blocks_per_slot: int = 8  # max context = block_size * blocks_per_slot
    prefill_len: int = 64  # static prompt pad length
    num_blocks: int = 0  # 0 -> num_slots * blocks_per_slot (full occupancy)
    temperature: float = 0.0
    max_queue: int = 0  # 0 -> unbounded; else submit() rejects when full

    @property
    def max_context(self) -> int:
        return self.block_size * self.blocks_per_slot

    @property
    def resolved_num_blocks(self) -> int:
        return self.num_blocks or self.num_slots * self.blocks_per_slot


@dataclass
class ServeRequest:
    request_id: str
    prompt: np.ndarray  # [P] int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0


@dataclass
class Completion:
    request_id: str
    tokens: list[int]  # the max_new_tokens sampled tokens
    prompt_len: int
    arrival_s: float
    first_token_s: float
    finish_s: float
    token_times_s: list[float] = field(default_factory=list)


@dataclass
class _Slot:
    request: ServeRequest
    blocks: list[int]
    table: np.ndarray  # [blocks_per_slot] int64, 0-padded past the owned blocks
    length: int  # tokens resident in the pool (prompt + decoded-in)
    generated: list[int]
    token_times: list[float]


def _paged_block(cfg, x, layer, lk, lv, positions, write_blk, write_off, table, qpos, valid_len):
    """One decoder block over the paged pool; returns x.

    ``x`` is ``[B, T, d]`` (prefill: B 1, T prefill_len; decode: B
    num_slots, T 1); ``lk``/``lv`` are one layer's pool ``[pages, bs, Hkv,
    D]``, written in place; ``write_blk``/``write_off`` are the flattened
    ``[B*T]`` write targets (dropped writes name the sink page); ``table``
    ``[B, blocks_per_slot]`` gathers each row's contiguous context; ``qpos``
    ``[B, T]`` and ``valid_len`` ``[B]`` give the causal and validity mask
    of ``_attend_cached``.
    """
    B, T, _ = x.shape
    hd, nkv = cfg.head_dim, cfg.n_kv_heads
    q, k, v = project_qkv(cfg, layer, x, positions)
    # Write-then-attend, as _block_cached: each token attends to itself
    # through the pool.
    lk[write_blk, write_off] = k.to(lk.dtype).reshape(B * T, nkv, hd)
    lv[write_blk, write_off] = v.to(lv.dtype).reshape(B * T, nkv, hd)
    ctx_k = lk[table].reshape(B, -1, nkv, hd)  # [B, max_ctx, Hkv, D]
    ctx_v = lv[table].reshape(B, -1, nkv, hd)
    kpos = torch.arange(ctx_k.shape[1], device=x.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
        kpos[None, None, :] < valid_len[:, None, None]
    )
    attn = dot_product_attention(q, ctx_k, ctx_v, causal=False, mask=mask[:, None])
    return finish_block(cfg, layer, x, attn)


@torch.inference_mode()
def paged_prefill(
    model: Llama,
    cache: PagedKVCache,
    tokens: torch.Tensor,  # [1, prefill_len] int32, zero-padded past `length`
    length: int,  # real prompt length
    blocks: torch.Tensor,  # [blocks_per_slot] int64 physical pages, 0-padded
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Prefill one slot through the pool; returns (first token, cache).

    Pad rows (p >= length) write to the sink page, so every prompt length
    runs the same shapes; the first token is sampled from row
    ``length - 1``, the only row whose logits are computed."""
    S = tokens.shape[1]
    dev = tokens.device
    x = embed(model, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    pidx = torch.arange(S, device=dev)
    write_blk = torch.where(pidx < length, blocks[pidx // cache.block_size], cache.sink)
    write_off = pidx % cache.block_size
    table = blocks[None, :]
    qpos = positions[None, :]
    valid_len = torch.full((1,), length, device=dev)
    for layer, lk, lv in zip(model.layers, cache.k, cache.v):
        x = _paged_block(model.cfg, x, layer, lk, lv, positions, write_blk, write_off, table,
                         qpos, valid_len)
    logits = logits_f32(model, x[:, length - 1])  # [1, V]
    return sample_token(logits[0], generator, temperature), cache


@torch.inference_mode()
def paged_decode_logits(
    model: Llama,
    cache: PagedKVCache,
    tokens: torch.Tensor,  # [num_slots] int32: each slot's last sampled token
    lengths: torch.Tensor,  # [num_slots] int64: tokens resident per slot
    tables: torch.Tensor,  # [num_slots, blocks_per_slot] int64
    active: torch.Tensor,  # [num_slots] bool
) -> torch.Tensor:
    """The decode step's forward: f32 logits ``[num_slots, V]``, the pool
    updated in place.  Every operation keeps its shape whatever the data,
    and none waits for the host, so a CUDA graph can capture it."""
    S = tokens.shape[0]
    bs = cache.block_size
    x = embed(model, tokens)[:, None, :]  # [S, 1, d]
    positions = lengths[:, None]  # each new token sits at position `length`
    rows = torch.arange(S, device=tokens.device)
    write_blk = torch.where(active, tables[rows, lengths // bs], cache.sink)
    write_off = lengths % bs
    valid_len = lengths + 1
    for layer, lk, lv in zip(model.layers, cache.k, cache.v):
        x = _paged_block(model.cfg, x, layer, lk, lv, positions, write_blk, write_off, tables,
                         positions, valid_len)
    return logits_f32(model, x)[:, 0]


def paged_decode_step(
    model: Llama,
    cache: PagedKVCache,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    tables: torch.Tensor,
    active: torch.Tensor,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for every slot at once; returns (next tokens, cache).
    Inactive slots write to the sink page and their tokens are discarded
    by the scheduler."""
    logits = paged_decode_logits(model, cache, tokens, lengths, tables, active)
    return sample_token(logits, generator, temperature), cache


@torch.inference_mode()
def prefill_kv(
    model: Llama,
    tokens: torch.Tensor,  # [1, prefill_len] int32
    length: int,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Disaggregated prefill: a prompt's K/V with local causal attention (no
    pool), for a dedicated prefill device.  Returns (first token, ks ``[L,
    prefill_len, Hkv, D]``, vs); the caller moves ks/vs to the decode device
    and lands them with :func:`scatter_prompt_kv`."""
    cfg = model.cfg
    S = tokens.shape[1]
    dev = tokens.device
    x = embed(model, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    kpos = torch.arange(S, device=dev)
    mask = (kpos[None, :] <= kpos[:, None]) & (kpos[None, :] < length)
    ks, vs = [], []
    for layer in model.layers:
        q, k, v = project_qkv(cfg, layer, x, positions)
        attn = dot_product_attention(q, k, v, causal=False, mask=mask[None, None])
        x = finish_block(cfg, layer, x, attn)
        ks.append(k[0].to(cfg.dtype))
        vs.append(v[0].to(cfg.dtype))
    first = sample_token(logits_f32(model, x[:, length - 1])[0], generator, temperature)
    return first, torch.stack(ks), torch.stack(vs)


@torch.inference_mode()
def scatter_prompt_kv(
    cache: PagedKVCache,
    ks: torch.Tensor,  # [L, prefill_len, Hkv, D]
    vs: torch.Tensor,
    length: int,
    blocks: torch.Tensor,  # [blocks_per_slot] int64
) -> PagedKVCache:
    """Land a transferred prompt K/V in the pool, in place (the decode
    device's side of disaggregated prefill)."""
    pidx = torch.arange(ks.shape[1], device=cache.k.device)
    bs = cache.block_size
    write_blk = torch.where(pidx < length, blocks[pidx // bs], cache.sink)
    write_off = pidx % bs
    cache.k[:, write_blk, write_off] = ks.to(cache.k.dtype)
    cache.v[:, write_blk, write_off] = vs.to(cache.v.dtype)
    return cache


class CapturedDecode:
    """:func:`paged_decode_logits` captured once as a CUDA graph.

    The inputs live in static buffers; :meth:`__call__` copies a step's
    inputs in, replays the graph and returns its logits buffer, which the
    next replay overwrites.  The capture is preceded by one eager run on a
    side stream (libraries allocate their workspaces there) with every slot
    inactive, so it writes only the sink page."""

    def __init__(self, model: Llama, cache: PagedKVCache, num_slots: int, blocks_per_slot: int):
        dev = cache.k.device
        with torch.inference_mode():
            self.tokens = torch.zeros(num_slots, dtype=torch.int32, device=dev)
            self.lengths = torch.zeros(num_slots, dtype=torch.int64, device=dev)
            self.tables = torch.zeros(num_slots, blocks_per_slot, dtype=torch.int64, device=dev)
            self.active = torch.zeros(num_slots, dtype=torch.bool, device=dev)
            args = (model, cache, self.tokens, self.lengths, self.tables, self.active)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                paged_decode_logits(*args)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = paged_decode_logits(*args)

    @torch.inference_mode()
    def __call__(self, tokens, lengths, tables, active) -> torch.Tensor:
        for buf, value in ((self.tokens, tokens), (self.lengths, lengths),
                           (self.tables, tables), (self.active, active)):
            buf.copy_(torch.as_tensor(value))
        self.graph.replay()
        return self.logits


class ContinuousBatchingEngine:
    """Slot scheduler: admit at step boundaries, decode everyone at once.

    ``model`` is the port's ``Llama``; the engine decodes on the device its
    weights are on, or on ``placement.decode_devices[0]`` (the model is moved
    there).  ``clock`` is any zero-argument float callable (``VirtualClock``
    in tests, ``time.monotonic`` in production); every latency metric is
    measured on it.  ``placement`` (optional, ``serve/placement.py``)
    switches prefill to the disaggregated path.
    """

    def __init__(
        self,
        model: Llama,
        serve_cfg: ServeConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        name: str = "serve0",
        placement=None,
        journal: bool = True,
    ):
        self.cfg = model.cfg
        check_decodable(self.cfg)
        self.serve_cfg = serve_cfg or ServeConfig()
        self.clock = clock
        self.name = name
        self.placement = placement
        self.journal = journal
        scfg = self.serve_cfg
        if scfg.prefill_len > scfg.max_context:
            raise ValueError(
                f"prefill_len {scfg.prefill_len} exceeds max context {scfg.max_context}"
            )
        if placement is not None:
            model = model.to(placement.decode_devices[0])
        self.model = model
        self.device = next(model.parameters()).device
        self.disaggregated = bool(placement is not None and placement.disaggregated)
        self._prefill_model = model
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._prefill_generator = self._generator
        if self.disaggregated:
            prefill_device = torch.device(placement.prefill_devices[0])
            if prefill_device != self.device:
                self._prefill_model = copy.deepcopy(model).to(prefill_device)
                self._prefill_generator = torch.Generator(device=prefill_device).manual_seed(0)
        with torch.inference_mode():
            self.cache = init_paged_cache(
                self.cfg, scfg.resolved_num_blocks, scfg.block_size, self.device
            )
        self.allocator = BlockAllocator(scfg.resolved_num_blocks)
        self.slots: list[_Slot | None] = [None] * scfg.num_slots
        self.queue: deque[ServeRequest] = deque()
        self.decode_captures = 0
        self.captured: CapturedDecode | None = None  # the decode step's graph, on CUDA
        if self.device.type == "cuda":
            self.captured = CapturedDecode(self.model, self.cache, scfg.num_slots,
                                         scfg.blocks_per_slot)
            self.decode_captures += 1
        # --- metrics (on self.clock) ------------------------------------
        self.steps = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.prefills = 0
        self.tokens_out = 0
        self.kv_transfer_bytes = 0
        self.max_wait_steps = 0
        self._enqueued_step: dict[str, int] = {}
        self._ttft_s: list[float] = []
        self._itl_s: list[float] = []
        self._started_at = self.clock()

    # --- admission ------------------------------------------------------
    def submit(self, request: ServeRequest, arrival_s: float | None = None) -> None:
        """Accept a request (or raise ServeAdmissionError).  Acceptance is a
        promise: an accepted request always completes or is replayed."""
        scfg = self.serve_cfg
        prompt = np.asarray(request.prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ServeAdmissionError(
                f"{request.request_id}: prompt must be a non-empty 1-D "
                f"token array, got shape {prompt.shape}"
            )
        if request.max_new_tokens < 1:
            raise ServeAdmissionError(f"{request.request_id}: max_new_tokens must be >= 1")
        if prompt.size > scfg.prefill_len:
            raise ServeAdmissionError(
                f"{request.request_id}: prompt of {prompt.size} tokens "
                f"exceeds prefill_len={scfg.prefill_len}"
            )
        if prompt.size + request.max_new_tokens - 1 > scfg.max_context:
            raise ServeAdmissionError(
                f"{request.request_id}: prompt {prompt.size} + "
                f"{request.max_new_tokens} new tokens exceeds max context "
                f"{scfg.max_context}"
            )
        if scfg.max_queue and len(self.queue) >= scfg.max_queue:
            self.rejected += 1
            raise ServeAdmissionError(
                f"{request.request_id}: queue full ({scfg.max_queue}); "
                "backpressure — retry against another replica"
            )
        request.prompt = prompt
        if arrival_s is not None:
            request.arrival_s = arrival_s
        elif request.arrival_s == 0.0:
            request.arrival_s = self.clock()
        self._enqueued_step[request.request_id] = self.steps
        self.queue.append(request)

    def _blocks_needed(self, request: ServeRequest) -> int:
        # Resident tokens peak at prompt + max_new - 1: the final sampled
        # token is returned but never written back to the pool.
        resident = request.prompt.size + request.max_new_tokens - 1
        return max(1, math.ceil(resident / self.serve_cfg.block_size))

    def _prefill(self, prompt: np.ndarray, table: np.ndarray) -> int:
        """Prefill one prompt into the slot's pages; returns the first token."""
        scfg = self.serve_cfg
        dev = next(self._prefill_model.parameters()).device
        padded = torch.zeros((1, scfg.prefill_len), dtype=torch.int32)
        padded[0, : prompt.size] = torch.from_numpy(prompt)
        padded = padded.to(dev)
        blocks = torch.from_numpy(table).to(self.device)
        if self.disaggregated:
            first, ks, vs = prefill_kv(self._prefill_model, padded, prompt.size,
                                       self._prefill_generator, scfg.temperature)
            # The K/V handoff: the real cost of disaggregated serving.
            ks, vs = ks.to(self.device), vs.to(self.device)
            self.kv_transfer_bytes += ks.nbytes + vs.nbytes
            scatter_prompt_kv(self.cache, ks, vs, prompt.size, blocks)
        else:
            first, _ = paged_prefill(self.model, self.cache, padded, prompt.size, blocks,
                                     self._generator, scfg.temperature)
        return int(first)

    def _admit_one(self, slot_idx: int, completions: list[Completion]) -> bool:
        scfg = self.serve_cfg
        request = self.queue[0]
        blocks = self.allocator.allocate(self._blocks_needed(request))
        if blocks is None:
            return False  # page pressure: stay queued, FIFO (no overtaking)
        self.queue.popleft()
        wait = self.steps - self._enqueued_step.pop(request.request_id, self.steps)
        self.max_wait_steps = max(self.max_wait_steps, wait)
        table = np.zeros(scfg.blocks_per_slot, np.int64)
        table[: len(blocks)] = blocks
        first_token = self._prefill(request.prompt, table)
        self.prefills += 1
        self.admitted += 1
        now = self.clock()
        self._ttft_s.append(now - request.arrival_s)
        self.tokens_out += 1
        slot = _Slot(
            request=request,
            blocks=blocks,
            table=table,
            length=int(request.prompt.size),
            generated=[first_token],
            token_times=[now],
        )
        if request.max_new_tokens == 1:
            self._retire(slot, completions)
        else:
            self.slots[slot_idx] = slot
        return True

    def _retire(self, slot: _Slot, completions: list[Completion]) -> None:
        self.allocator.free(slot.blocks)
        self.completed += 1
        completions.append(
            Completion(
                request_id=slot.request.request_id,
                tokens=list(slot.generated),
                prompt_len=int(slot.request.prompt.size),
                arrival_s=slot.request.arrival_s,
                first_token_s=slot.token_times[0],
                finish_s=slot.token_times[-1],
                token_times_s=list(slot.token_times),
            )
        )

    # --- the step boundary ----------------------------------------------
    def decode_inputs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The decode step's inputs for the current slots: (tokens,
        lengths, tables, active)."""
        scfg = self.serve_cfg
        tokens = np.zeros(scfg.num_slots, np.int32)
        lengths = np.zeros(scfg.num_slots, np.int64)
        tables = np.zeros((scfg.num_slots, scfg.blocks_per_slot), np.int64)
        active = np.zeros(scfg.num_slots, bool)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i] = s.generated[-1]
                lengths[i] = s.length
                tables[i] = s.table
                active[i] = True
        return tokens, lengths, tables, active

    def decode(self, inputs) -> np.ndarray:
        """One decode step on ``inputs`` (:meth:`decode_inputs`): the
        captured graph on a CUDA device, the eager step on the CPU.
        Returns the sampled tokens of every slot."""
        temperature = self.serve_cfg.temperature
        if self.captured is not None:
            logits = self.captured(*inputs)
            nxt = sample_token(logits, self._generator, temperature)
        else:
            tensors = [torch.from_numpy(a).to(self.device) for a in inputs]
            nxt, _ = paged_decode_step(self.model, self.cache, *tensors, self._generator,
                                       temperature)
        return nxt.cpu().numpy()

    def step(self) -> list[Completion]:
        """One continuous-batching step: admit newcomers into free slots
        (prefill), then one batched decode for every active slot, then
        retire finished requests and recycle their pages."""
        completions: list[Completion] = []
        for i, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot is None and not self._admit_one(i, completions):
                break
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        if active_idx:
            nxt = self.decode(self.decode_inputs())
            now = self.clock()
            for i in active_idx:
                s = self.slots[i]
                s.length += 1
                s.generated.append(int(nxt[i]))
                self._itl_s.append(now - s.token_times[-1])
                s.token_times.append(now)
                self.tokens_out += 1
                if len(s.generated) >= s.request.max_new_tokens:
                    self._retire(s, completions)
                    self.slots[i] = None
        self.steps += 1
        return completions

    # --- introspection ---------------------------------------------------
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def inflight_requests(self) -> list[ServeRequest]:
        """Queued and slotted requests: what a front-end must replay if this
        replica dies (completions already emitted are safe)."""
        out = [s.request for s in self.slots if s is not None]
        out.extend(self.queue)
        return out

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @staticmethod
    def _quantiles_ms(samples: list[float]) -> dict[str, float]:
        if not samples:
            return {}
        arr = np.asarray(samples, np.float64) * 1e3
        return {
            "p50": round(float(np.quantile(arr, 0.50)), 3),
            "p95": round(float(np.quantile(arr, 0.95)), 3),
            "p99": round(float(np.quantile(arr, 0.99)), 3),
            "max": round(float(arr.max()), 3),
        }

    def snapshot(self) -> dict:
        elapsed = self.clock() - self._started_at
        return {
            "replica": self.name,
            "steps": self.steps,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "active_slots": self.active_slots,
            "queue_depth": self.queue_depth,
            "tokens_out": self.tokens_out,
            "tokens_per_s": round(self.tokens_out / elapsed, 3) if elapsed > 0 else 0.0,
            "ttft_ms": self._quantiles_ms(self._ttft_s),
            "itl_ms": self._quantiles_ms(self._itl_s),
            "free_blocks": self.allocator.free_blocks,
            "recycled_blocks": self.allocator.recycled,
            "max_wait_steps": self.max_wait_steps,
            "kv_transfer_bytes": self.kv_transfer_bytes,
            "disaggregated": self.disaggregated,
            "decode_captures": self.decode_captures,
        }

    def journal_metrics(self) -> dict:
        """Record the ``serve_metrics`` journal event (the JAX package's
        exporter folds it into its ``dlcfn_serve_*`` gauges)."""
        snap = self.snapshot()
        if self.journal:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record("serve_metrics", **snap)
        return snap
