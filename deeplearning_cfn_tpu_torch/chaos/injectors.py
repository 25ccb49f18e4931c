"""Seeded fault injectors over the stack's real seams — counterpart of
``deeplearning_cfn_tpu/chaos/injectors.py``; like it, it imports no
framework (no ``torch``), so the control-plane scenarios stay light.

Every injector takes a ``seed`` and owns a private ``random.Random``, so
a chaos soak replays byte-for-byte: the same seed produces the same
faults in the same order.  None of them read the wall clock — time, when
it matters, comes from an injected :class:`~..utils.timeouts.Clock` (the
chaos scenarios pass fakes, so soaks run in microseconds).

Seams covered:

* :class:`FlakyOpener` — ``GoogleAuthTransport.opener``: HTTP error
  bursts (429/500/503), connection resets, and full hard-down outages.
* :class:`StallingConnectionFactory` — ``Heartbeater.connection_factory``:
  heartbeat stalls (the agent is alive; its beats don't land).
* :class:`ChaosQueue` — any :class:`RendezvousQueue`: message drop,
  delay, duplication, and reorder, the SQS pathologies consumers must
  already tolerate.
* :class:`TornDisk` / :class:`SlowDisk` / :class:`ManifestCrashDisk` —
  checkpoint ``CheckpointIO``: torn writes (a prefix lands, then
  OSError), high-latency disks on virtual time, and a writer crash at
  the async sharded checkpointer's manifest commit point.  All disk
  injectors share the :class:`DiskInjector` ``wrap()`` seam, so two
  faults stack deterministically (outermost injector first):
  ``SlowDisk(clock).wrap(TornDisk(seed))``.
"""

from __future__ import annotations

import io
import json
import os
import random
import urllib.error
from pathlib import Path
from typing import Any, Callable, Sequence

from deeplearning_cfn_tpu_torch.cluster.queue import Message, RendezvousQueue
from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, FakeClock


class RecordingClock(FakeClock):
    """A FakeClock that remembers every sleep — the jitter-bounds probe:
    a retry loop run over this clock exposes its exact backoff schedule
    without a single real sleep."""

    def __init__(self, start: float = 0.0):
        super().__init__(start)
        self.sleeps: list[float] = []

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        super().sleep(seconds)


# --- RPC layer ---------------------------------------------------------------


class _CannedResponse:
    def __init__(self, payload: dict):
        self._data = json.dumps(payload).encode()

    def read(self) -> bytes:
        return self._data

    def __enter__(self) -> "_CannedResponse":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


class FlakyOpener:
    """Drop-in for ``GoogleAuthTransport.opener``: seeded bursts of
    retryable HTTP errors and connection resets around canned successes.

    ``hard_down=True`` models a full control-plane outage: every request
    raises a connection reset (what a circuit breaker must convert into
    fail-fast refusals).
    """

    def __init__(
        self,
        seed: int = 0,
        error_rate: float = 0.4,
        reset_rate: float = 0.1,
        errors: Sequence[int] = (429, 500, 503),
        payload: dict | None = None,
        hard_down: bool = False,
    ):
        self._rng = random.Random(seed)
        self.error_rate = error_rate
        self.reset_rate = reset_rate
        self.errors = tuple(errors)
        self.payload = payload if payload is not None else {"ok": True}
        self.hard_down = hard_down
        self.requests: list[Any] = []

    def __call__(self, req: Any, timeout: float | None = None) -> _CannedResponse:
        self.requests.append(req)
        if self.hard_down:
            raise urllib.error.URLError("injected hard outage")
        roll = self._rng.random()
        if roll < self.reset_rate:
            raise urllib.error.URLError("injected connection reset")
        if roll < self.reset_rate + self.error_rate:
            code = self._rng.choice(self.errors)
            raise urllib.error.HTTPError(
                "https://chaos", code, "injected", hdrs=None, fp=io.BytesIO(b"{}")
            )
        return _CannedResponse(self.payload)


# --- heartbeat layer ---------------------------------------------------------


class _StallingConnection:
    """Wraps a heartbeat connection; seeded beats raise instead of landing."""

    def __init__(self, conn: Any, rng: random.Random, stall_rate: float):
        self._conn = conn
        self._rng = rng
        self.stall_rate = stall_rate

    def heartbeat(self, worker_id: str) -> int:
        if self._rng.random() < self.stall_rate:
            raise ConnectionError("injected heartbeat stall")
        return self._conn.heartbeat(worker_id)

    def close(self) -> None:
        self._conn.close()


class StallingConnectionFactory:
    """``Heartbeater.connection_factory`` wrapper: each dialed connection
    stalls a seeded fraction of beats, exercising the real
    drop-and-redial path under sustained (not one-shot) flakiness."""

    def __init__(
        self,
        inner_factory: Callable[[], Any],
        seed: int = 0,
        stall_rate: float = 0.3,
    ):
        self._inner = inner_factory
        self._rng = random.Random(seed)
        self.stall_rate = stall_rate
        self.dials = 0

    def __call__(self) -> _StallingConnection:
        self.dials += 1
        return _StallingConnection(self._inner(), self._rng, self.stall_rate)


# --- queue layer -------------------------------------------------------------


class ChaosQueue(RendezvousQueue):
    """Seeded drop/delay/duplicate/reorder wrapper over any queue.

    These are exactly the SQS behaviors the consumers already claim to
    tolerate (at-least-once, visibility churn, no ordering); the wrapper
    makes the claim falsifiable.  Delay is measured in *operations* (the
    message reappears after ``delay_ops`` further send/receive calls),
    which keeps it deterministic without a clock.
    """

    def __init__(
        self,
        inner: RendezvousQueue,
        seed: int = 0,
        drop_rate: float = 0.0,
        delay_rate: float = 0.0,
        delay_ops: int = 3,
        duplicate_rate: float = 0.0,
        reorder: bool = False,
    ):
        self.name = inner.name
        self._inner = inner
        self._rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.delay_rate = delay_rate
        self.delay_ops = delay_ops
        self.duplicate_rate = duplicate_rate
        self.reorder = reorder
        self._ops = 0
        self._held: list[tuple[int, dict]] = []
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0

    def _tick(self) -> None:
        self._ops += 1
        due = [body for release, body in self._held if release <= self._ops]
        self._held = [
            (release, body)
            for release, body in self._held
            if release > self._ops
        ]
        for body in due:
            self._inner.send(body)

    def send(self, body: dict) -> str:
        self._tick()
        roll = self._rng.random()
        if roll < self.drop_rate:
            self.dropped += 1
            return "chaos-dropped"
        if roll < self.drop_rate + self.delay_rate:
            self.delayed += 1
            self._held.append((self._ops + self.delay_ops, body))
            return "chaos-delayed"
        if roll < self.drop_rate + self.delay_rate + self.duplicate_rate:
            self.duplicated += 1
            mid = self._inner.send(body)
            self._inner.send(body)
            return mid
        return self._inner.send(body)

    def receive(
        self,
        max_messages: int = 10,
        visibility_timeout_s: float = 60.0,
    ) -> list[Message]:
        self._tick()
        out = self._inner.receive(max_messages, visibility_timeout_s)
        if self.reorder and len(out) > 1:
            self._rng.shuffle(out)
        return out

    def delete(self, receipt: str) -> None:
        self._inner.delete(receipt)

    def purge(self) -> None:
        self._held.clear()
        self._inner.purge()

    def approximate_depth(self) -> int:
        depth = getattr(self._inner, "approximate_depth", None)
        inner_depth = depth() if depth is not None else 0
        return inner_depth + len(self._held)

    def flush_held(self) -> int:
        """Deliver every delayed message now (end-of-schedule drain)."""
        held = [body for _release, body in self._held]
        self._held.clear()
        for body in held:
            self._inner.send(body)
        return len(held)


# --- disk layer --------------------------------------------------------------


class _RealDisk:
    """The default delegation target: plain durable IO with the same
    fsync discipline as ``train.checkpoint.CheckpointIO`` (kept local so
    importing injectors never drags in torch)."""

    def write_bytes(self, path: Path, data: bytes) -> None:
        with open(path, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())

    def replace(self, src: Path, dst: Path) -> None:
        os.replace(src, dst)

    def read_bytes(self, path: Path) -> bytes:
        return Path(path).read_bytes()


class DiskInjector:
    """Base for CheckpointIO-compatible disk injectors: the uniform
    ``wrap()`` seam.

    Every disk injector runs its fault logic at the OUTER layer and
    delegates the raw bytes to ``inner`` (a real durable disk by
    default), so two faults stack deterministically and order is
    explicit::

        io = SlowDisk(clock).wrap(TornDisk(seed=1))   # outermost first

    reads "consume latency, then roll for a torn write".  ``wrap``
    re-points the delegation and returns ``self``, so stacks compose
    fluently and the outermost injector is handed to the checkpointer.
    """

    def __init__(self, inner: Any | None = None):
        self.inner: Any = inner if inner is not None else _RealDisk()

    def wrap(self, inner: Any) -> "DiskInjector":
        """Delegate raw IO to ``inner`` (another injector or a real
        CheckpointIO); returns self so stacks read outermost-first."""
        self.inner = inner
        return self

    def write_bytes(self, path: Path, data: bytes) -> None:
        self.inner.write_bytes(path, data)

    def replace(self, src: Path, dst: Path) -> None:
        self.inner.replace(src, dst)

    def read_bytes(self, path: Path) -> bytes:
        return self.inner.read_bytes(path)


class TornDisk(DiskInjector):
    """Torn-write disk: seeded writes persist only a prefix of the bytes
    (through the inner disk), then raise OSError — the fault the atomic
    write-temp -> fsync -> rename protocol must make unobservable."""

    def __init__(self, seed: int = 0, fail_rate: float = 0.5, inner: Any | None = None):
        super().__init__(inner)
        self._rng = random.Random(seed)
        self.fail_rate = fail_rate
        self.writes = 0
        self.torn = 0

    def write_bytes(self, path: Path, data: bytes) -> None:
        self.writes += 1
        if self._rng.random() < self.fail_rate:
            self.torn += 1
            self.inner.write_bytes(path, data[: max(1, len(data) // 2)])
            raise OSError("injected torn write")
        self.inner.write_bytes(path, data)


class ManifestCrashDisk(DiskInjector):
    """Disk that dies exactly at the manifest write once :meth:`arm`\\ ed
    — the async sharded writer's commit point
    (train/datastream.AsyncShardedCheckpointer writes every shard file,
    THEN the manifest).  Shard files written before the crash land
    normally, so the fault leaves realistic litter on disk; the manifest
    never lands, so ``restore_latest`` must fall back to the previous
    checkpoint untouched.  Deterministic by construction — no RNG, the
    crash fires on the first armed manifest write.  With ``once=True``
    (the default) the crash disarms itself after firing, so a run that
    keeps checkpointing past the incident recovers on the next save."""

    def __init__(self, marker: str = "manifest", once: bool = True, inner: Any | None = None):
        super().__init__(inner)
        self.marker = marker
        self.once = once
        self.armed = False
        self.crashes = 0
        self.writes = 0

    def arm(self) -> None:
        self.armed = True

    def write_bytes(self, path: Path, data: bytes) -> None:
        self.writes += 1
        if self.armed and self.marker in Path(path).name:
            self.crashes += 1
            if self.once:
                self.armed = False
            raise OSError("injected writer crash at the manifest commit point")
        self.inner.write_bytes(path, data)


class SlowDisk(DiskInjector):
    """Slow disk: every write consumes ``latency_s`` of injected-clock
    time before the inner disk lands it (virtually slow, wall-clock
    instant)."""

    def __init__(self, clock: Clock, latency_s: float = 5.0, inner: Any | None = None):
        super().__init__(inner)
        self.clock = clock
        self.latency_s = latency_s
        self.writes = 0

    def write_bytes(self, path: Path, data: bytes) -> None:
        self.writes += 1
        self.clock.sleep(self.latency_s)
        self.inner.write_bytes(path, data)
