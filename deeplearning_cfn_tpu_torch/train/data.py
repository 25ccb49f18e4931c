"""Input data — the port's own copy of the parts of
``deeplearning_cfn_tpu/train/data.py`` that the Llama, BERT, ResNet, VGG and
detection slices use.

``SyntheticDataset``, ``SyntheticTokenDataset``, ``SyntheticMLMDataset``,
``SyntheticSeqClassificationDataset`` and ``SyntheticDetectionDataset`` draw
the same numpy streams as the JAX package's for the same seeds, so both
frameworks see byte-identical batches.  ``probe_data_source`` picks the
first existing directory of ``--data_dir``'s candidates.
Batches reach the card through pinned host memory with a non-blocking copy;
:class:`DevicePrefetcher` does that on producer threads, ahead of the step,
and :func:`stack_batches` folds ``k`` batches into one ``[k, B, ...]`` stack
for ``Trainer.multi_step_fn(k)``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from deeplearning_cfn_tpu_torch.train.batch import Batch


def probe_data_source(candidates: list[str | Path], marker: str = "") -> Path | None:
    """The first candidate directory that exists (and holds ``marker`` if
    given): the speed-ordered probe of storage tiers, fastest first."""
    for cand in candidates:
        p = Path(cand)
        if p.is_dir() and (not marker or (p / marker).exists()):
            return p
    return None


@dataclass
class SyntheticDataset:
    """Deterministic synthetic classification images: a fixed random
    template per class plus noise, so the labels can be learnt.

    ``dtype="uint8"`` maps samples affinely into [0, 255] and quantizes them
    (4x fewer bytes to the card than f32); ``input_stats`` gives the
    ``(mean, std)`` that make ``dequantize_normalize`` invert the map.
    ``template_seed`` seeds the templates (the task) apart from the samples,
    so a held-out stream (another ``seed``) scores the same task.
    ``pool_batches`` draws that many batches once and cycles through them."""

    shape: tuple[int, ...] = (28, 28, 1)
    num_classes: int = 10
    batch_size: int = 32
    seed: int = 0
    dtype: str = "float32"
    noise_scale: float = 1.0
    template_seed: int | None = None
    pool_batches: int | None = None

    _U8_OFFSET = 0.5
    _U8_SCALE = 0.125

    @property
    def input_stats(self) -> tuple[tuple[float, ...], tuple[float, ...]] | None:
        """Per-channel (mean, std) in the /255 domain for
        ``TrainerConfig.input_stats``; None for float dtypes."""
        if self.dtype != "uint8":
            return None
        c = int(self.shape[-1])
        return ((self._U8_OFFSET,) * c, (self._U8_SCALE,) * c)

    def _quantize(self, x: np.ndarray) -> np.ndarray:
        scaled = (x * self._U8_SCALE + self._U8_OFFSET) * 255.0
        return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)

    def _finalize(self, x: np.ndarray) -> np.ndarray:
        return self._quantize(x) if self.dtype == "uint8" else x.astype(self.dtype)

    def _templates(self, rng: np.random.Generator) -> np.ndarray:
        template_rng = (
            np.random.default_rng(self.template_seed) if self.template_seed is not None else rng
        )
        return template_rng.standard_normal((self.num_classes, *self.shape)).astype(np.float32)

    def batches(self, steps: int) -> Iterator[Batch]:
        if self.pool_batches:
            yield from self._pooled_batches(steps)
            return
        rng = np.random.default_rng(self.seed)
        templates = self._templates(rng)
        for _ in range(steps):
            y = rng.integers(0, self.num_classes, size=self.batch_size).astype(np.int32)
            noise = rng.standard_normal((self.batch_size, *self.shape)).astype(np.float32)
            yield Batch(x=self._finalize(templates[y] + self.noise_scale * noise), y=y)

    def _pooled_batches(self, steps: int) -> Iterator[Batch]:
        """The whole pool in two draws (labels, then noise), then cycled.  The
        pool is always ``pool_batches`` long, whatever ``steps`` is, so a short
        run and a long one see the same stream."""
        rng = np.random.default_rng(self.seed)
        templates = self._templates(rng)
        k = max(1, int(self.pool_batches))
        y = rng.integers(0, self.num_classes, size=(k, self.batch_size)).astype(np.int32)
        noise = rng.standard_normal((k, self.batch_size, *self.shape), dtype=np.float32)
        x = self._finalize(templates[y] + self.noise_scale * noise)
        for i in range(steps):
            yield Batch(x=x[i % k], y=y[i % k])

    @classmethod
    def mnist_like(cls, batch_size: int, seed: int = 0) -> "SyntheticDataset":
        return cls(shape=(28, 28, 1), num_classes=10, batch_size=batch_size, seed=seed)

    @classmethod
    def imagenet_like(
        cls,
        batch_size: int,
        image_size: int = 224,
        seed: int = 0,
        dtype: str = "float32",
        pool_batches: int | None = None,
    ) -> "SyntheticDataset":
        return cls(shape=(image_size, image_size, 3), num_classes=1000, batch_size=batch_size,
                   seed=seed, dtype=dtype, pool_batches=pool_batches)


@dataclass
class SyntheticTokenDataset:
    """Synthetic LM token streams for BERT/Llama-style trainers."""

    seq_len: int = 512
    vocab_size: int = 32000
    batch_size: int = 8
    seed: int = 0

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        for _ in range(steps):
            tokens = rng.integers(
                1, self.vocab_size, size=(self.batch_size, self.seq_len), dtype=np.int32
            )
            # Next-token targets: inputs shifted left (causal LM objective).
            yield Batch(x=tokens, y=np.roll(tokens, -1, axis=1))


@dataclass
class SyntheticMLMDataset:
    """Masked-LM batches: 15% of tokens masked; targets are the original
    ids at masked positions and -1 (ignore) elsewhere.  Each token is a fixed
    permutation of the one before it, so the MLM loss can fall.  The
    permutation (the task) is seeded by ``structure_seed`` apart from the
    samples, so a held-out stream (another ``seed``) scores the same task."""

    seq_len: int = 128
    vocab_size: int = 1000
    batch_size: int = 8
    seed: int = 0
    mask_token: int = 0
    mask_prob: float = 0.15
    structure_seed: int = 0

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        perm = np.random.default_rng(self.structure_seed).permutation(self.vocab_size)
        for _ in range(steps):
            tokens = np.empty((self.batch_size, self.seq_len), np.int32)
            tokens[:, 0] = rng.integers(1, self.vocab_size, self.batch_size)
            for i in range(1, self.seq_len):
                tokens[:, i] = perm[tokens[:, i - 1]]
            masked = rng.random((self.batch_size, self.seq_len)) < self.mask_prob
            x = np.where(masked, self.mask_token, tokens).astype(np.int32)
            y = np.where(masked, tokens, -1).astype(np.int32)
            yield Batch(x=x, y=y)


@dataclass
class SyntheticSeqClassificationDataset:
    """Labelled token sequences: each class has its own categorical
    distribution over the vocabulary (template logits), so labels are
    learnable from token statistics.  With ``template_seed`` the templates
    come from their own stream (the same task for another ``seed``)."""

    batch_size: int = 32
    seq_len: int = 32
    vocab_size: int = 64
    num_classes: int = 4
    seed: int = 0
    template_seed: int | None = None

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        template_rng = (
            np.random.default_rng(self.template_seed) if self.template_seed is not None else rng
        )
        logits = 2.0 * template_rng.standard_normal((self.num_classes, self.vocab_size))
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        for _ in range(steps):
            y = rng.integers(0, self.num_classes, size=self.batch_size).astype(np.int32)
            x = np.stack(
                [rng.choice(self.vocab_size, size=self.seq_len, p=probs[label]) for label in y]
            ).astype(np.int32)
            yield Batch(x=x, y=y)



@dataclass
class SyntheticDetectionDataset:
    """Synthetic detection batches: coloured rectangles on noise, one colour
    template per class, with padded ground truth: ``y = {"boxes": [B, M, 4]
    (y1, x1, y2, x2 pixels), "classes": [B, M]}`` padded with zeros / -1.
    ``template_seed`` seeds the colours (the task) apart from the samples.
    ``with_masks`` adds ``y["masks"]`` ``[B, M, S/stride, S/stride]`` uint8,
    the rectangles' fills at ``mask_stride``."""

    image_size: int = 128
    num_classes: int = 8
    max_boxes: int = 5
    batch_size: int = 8
    seed: int = 0
    template_seed: int | None = None
    with_masks: bool = False
    mask_stride: int = 8

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        template_rng = (
            np.random.default_rng(self.template_seed) if self.template_seed is not None else rng
        )
        colors = template_rng.uniform(0.5, 1.5, size=(self.num_classes, 3)).astype(np.float32)
        s = self.image_size
        ms = s // self.mask_stride
        for _ in range(steps):
            x = rng.normal(0.0, 0.05, size=(self.batch_size, s, s, 3)).astype(np.float32)
            boxes = np.zeros((self.batch_size, self.max_boxes, 4), np.float32)
            classes = np.full((self.batch_size, self.max_boxes), -1, np.int32)
            masks = (np.zeros((self.batch_size, self.max_boxes, ms, ms), np.uint8)
                     if self.with_masks else None)
            for b in range(self.batch_size):
                n = int(rng.integers(1, self.max_boxes + 1))
                for i in range(n):
                    h = int(rng.integers(s // 8, s // 2))
                    w = int(rng.integers(s // 8, s // 2))
                    y0 = int(rng.integers(0, s - h))
                    x0 = int(rng.integers(0, s - w))
                    c = int(rng.integers(0, self.num_classes))
                    x[b, y0:y0 + h, x0:x0 + w] += colors[c]
                    boxes[b, i] = (y0, x0, y0 + h, x0 + w)
                    classes[b, i] = c
                    if masks is not None:
                        st = self.mask_stride
                        masks[b, i,
                              y0 // st:max(y0 // st + 1, (y0 + h) // st),
                              x0 // st:max(x0 // st + 1, (x0 + w) // st)] = 1
            y = {"boxes": boxes, "classes": classes}
            if masks is not None:
                y["masks"] = masks
            yield Batch(x=x, y=y)

def tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees of dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def to_device(a, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  For CUDA the array is staged in
    pinned memory and copied without blocking the host; PyTorch's pinned
    allocator keeps the staging buffer alive until the copy is done.  A
    tensor already on ``device`` (a prefetched batch) passes as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_put_batch(batch: Batch, device: torch.device):
    return (tree_map(lambda a: to_device(a, device), batch.x),
            tree_map(lambda a: to_device(a, device), batch.y))


def stack_batches(batches: Iterator[Batch], k: int) -> Iterator[Batch]:
    """Fold ``k`` consecutive host batches into one ``Batch(x=[k, B, ...],
    y=[k, B, ...])`` (numpy, before the prefetcher's copy, so a stack crosses
    to the card as one transfer): the input ``Trainer.multi_step_fn(k)``
    takes.  A trailing group of fewer than ``k`` batches is not yielded."""
    if k < 1:
        raise ValueError(f"stack_batches needs k >= 1, got {k}")
    group: list[Batch] = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield Batch(x=tree_map(lambda *ls: np.stack(ls), *[g.x for g in group]),
                        y=tree_map(lambda *ls: np.stack(ls), *[g.y for g in group]))
            group = []


def donate_buffers(tree) -> int:
    """Free the storage of a consumed batch's tensors and return the bytes
    released (JAX's ``donate_buffers``, which deletes the device buffers a
    loop placed itself once the step that reads them is dispatched).

    Safe while the step still runs: the caching allocator hands a freed
    block out again only in its stream's order, and for a tensor that
    another stream reads it waits for that stream's work too.  So a tensor
    copied on a prefetch producer's side stream must have been marked with
    ``record_stream`` on the compute stream before this runs, as
    :class:`DevicePrefetcher` marks every batch it hands over.  Leaves that
    are not tensors, and tensors whose storage the caller cannot resize (a
    numpy array's), are skipped; a second call finds nothing to free.  Only
    call it on tensors the caller placed, never on ones handed in from
    outside the loop."""
    freed = 0

    def free(leaf) -> None:
        nonlocal freed
        if isinstance(leaf, torch.Tensor):
            storage = leaf.untyped_storage()
            if storage.nbytes() and storage.resizable():
                freed += storage.nbytes()
                storage.resize_(0)

    tree_map(free, tree)
    return freed


class DevicePrefetcher:
    """Background host-to-device pipeline: producer threads pull batches from
    the host iterator and copy them to ``device``, up to ``size`` batches
    ahead of the consumer, so the copy overlaps the previous step.

    On CUDA each producer stages a batch in pinned memory and copies it
    without blocking on a side stream of its own; the batch carries an event
    recorded after its copy, which the consumer's stream waits on, and its
    tensors are marked as used on the consumer's stream (``record_stream``)
    so that the allocator does not hand their memory out while the step
    reads them.  On the CPU a producer copies with no streams.

    The JAX package's reorder-buffer contract: the source is pulled under a
    lock (sequence numbers in source order) while copies proceed in
    parallel, so iteration order is exactly the source order at any
    ``workers``, and a source exception re-raises at the position it
    occurred.  ``close()`` (or exhausting the iterator) stops every
    producer.  ``stats`` (a ``train.pipeline.PipelineStats``) counts
    transfer bytes, host-input seconds, producer stalls and consumer waits;
    ``close()`` journals it once.  With ``profiler`` (an
    ``obs.profiler.StepProfiler``) each producer's copy folds into its
    ``h2d`` phase with ``critical=False``: it overlaps the step, so it shows
    in the phase's stats and is not taken from the host residual."""

    _DONE = object()

    def __init__(self, batches: Iterator[Batch], device, size: int = 2, workers: int = 1,
                 stats=None, profiler=None):
        self._src = iter(batches)
        self._device = torch.device(device)
        self._size = max(1, size)
        self._stats = stats
        self._profiler = profiler
        self._stop = threading.Event()
        # _src_lock serialises source pulls (sequence numbers); _cond guards
        # the reorder buffer and the consumer's cursor.
        self._src_lock = threading.Lock()
        self._cond = threading.Condition()
        self._buf: dict[int, object] = {}  # seq -> (Batch, event) | exception | _DONE
        self._next_pull = 0
        self._next_out = 0
        self._done = False
        cuda = self._device.type == "cuda"
        self._threads = [
            threading.Thread(target=self._produce,
                             args=(torch.cuda.Stream(self._device) if cuda else None,),
                             daemon=True)
            for _ in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    def _pull(self):
        """One serialised source pull -> (seq, item): a Batch, an exception
        (re-raised by the consumer at this position), _DONE, or (None, None)
        once the source is done or the prefetcher stopped."""
        with self._src_lock:
            if self._done or self._stop.is_set():
                return None, None
            seq = self._next_pull
            t0 = time.perf_counter()
            try:
                item = next(self._src)
            except StopIteration:
                item = self._DONE
            except BaseException as e:  # re-raised in the consumer's __iter__
                item = e
            if self._stats is not None:
                self._stats.add_host_input(time.perf_counter() - t0)
            self._next_pull = seq + 1
            if item is self._DONE or isinstance(item, BaseException):
                self._done = True
            return seq, item

    def _copy(self, batch: Batch, stream):
        if stream is None:
            # Tensors of their own, as a device's are (a numpy array's
            # tensor shares its storage, which donate_buffers cannot free).
            return tree_map(torch.clone, device_put_batch(batch, self._device)), None
        with torch.cuda.stream(stream):
            placed = device_put_batch(batch, self._device)
            event = torch.cuda.Event()
            event.record(stream)
        return placed, event

    def _produce(self, stream) -> None:
        while not self._stop.is_set():
            seq, item = self._pull()
            if seq is None:
                return
            terminal = item is self._DONE or isinstance(item, BaseException)
            if not terminal:
                if self._stats is not None:
                    from deeplearning_cfn_tpu_torch.train.pipeline import nbytes_of

                    self._stats.add_transfer(nbytes_of((item.x, item.y)))
                t_put = time.perf_counter()
                item = self._copy(item, stream)
                if self._profiler is not None:
                    self._profiler.fold("h2d", time.perf_counter() - t_put, critical=False)
            t0 = time.perf_counter()
            with self._cond:
                # At most ``size`` batches ahead of the consumer (the
                # stream's end always lands).
                while (not terminal and seq >= self._next_out + self._size
                       and not self._stop.is_set()):
                    self._cond.wait(0.1)
                if self._stop.is_set():
                    return
                self._buf[seq] = item
                self._cond.notify_all()
            if self._stats is not None and not terminal:
                self._stats.add_producer_stall(time.perf_counter() - t0)
            if terminal:
                return

    def __iter__(self) -> Iterator[Batch]:
        try:
            while True:
                t0 = time.perf_counter()
                with self._cond:
                    while self._next_out not in self._buf and not self._stop.is_set():
                        self._cond.wait(0.1)
                    if self._next_out not in self._buf:
                        return  # stopped
                    item = self._buf.pop(self._next_out)
                    self._next_out += 1
                    self._cond.notify_all()
                if self._stats is not None:
                    self._stats.add_consumer_wait(time.perf_counter() - t0)
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                (x, y), event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    consumer.wait_event(event)
                    tree_map(lambda t: t.record_stream(consumer), (x, y))
                yield Batch(x=x, y=y)
        finally:
            self.close()

    def buffered(self) -> list[Batch]:
        """The batches staged ahead of the consumer, each already on the
        device (its producer issued the copy before inserting it):
        introspection for the structural overlap check of
        ``deeplearning_cfn_tpu_torch/scripts/perf_smoke.py``, not part of
        the hot loop."""
        with self._cond:
            return [Batch(x=item[0][0], y=item[0][1]) for item in self._buf.values()
                    if isinstance(item, tuple)]

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._stats is not None:
            self._stats.journal()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
