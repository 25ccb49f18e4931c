"""Rendezvous queues — the control-plane transport.  Counterpart of
``deeplearning_cfn_tpu/cluster/queue.py``, copied.

The reference's control plane is two SQS queues: the *master queue* carries
Lambda -> master lifecycle events, and the *worker queue* carries the
master -> workers cluster-contract broadcast (SURVEY §2.4).  Three SQS
behaviors are load-bearing and are reproduced exactly here:

1. **At-least-once delivery** — consumers must dedup; the reference dedups
   asg-setup messages by ASG name (dl_cfn_setup_v2.py:142-149).
2. **Visibility timeout** — a received message becomes invisible for N
   seconds, then reappears unless deleted (receive args at
   dl_cfn_setup_v2.py:139-141: batch of 10, visibility 60 s).
3. **The broadcast trick** — receiving with ``visibility_timeout=0`` and
   never deleting lets one message fan out to every worker
   (dl_cfn_setup_v2.py:180-190).

On TPU deployments the same interface is served by the native C++ broker
(native/broker) over TCP, or by a GCS-object mailbox; the in-memory
implementation backs unit tests and the local backend.
"""

from __future__ import annotations

import itertools
import json
import threading
from dataclasses import dataclass, field
from typing import Any

from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, MonotonicClock


@dataclass
class Message:
    message_id: str
    body: dict[str, Any]
    receipt: str
    receive_count: int = 1


class RendezvousQueue:
    """Abstract queue with SQS-compatible semantics."""

    name: str

    def send(self, body: dict[str, Any]) -> str:
        raise NotImplementedError

    def receive(
        self,
        max_messages: int = 10,
        visibility_timeout_s: float = 60.0,
    ) -> list[Message]:
        raise NotImplementedError

    def delete(self, receipt: str) -> None:
        raise NotImplementedError

    def purge(self) -> None:
        raise NotImplementedError


@dataclass
class _Stored:
    message_id: str
    body: dict[str, Any]
    enqueued_seq: int
    invisible_until: float = 0.0
    receive_count: int = 0
    receipts: set[str] = field(default_factory=set)


class InMemoryQueue(RendezvousQueue):
    """Thread-safe in-memory queue with visibility-timeout semantics.

    ``duplicate_next_send`` simulates SQS at-least-once duplication so tests
    can prove consumers dedup correctly.
    """

    def __init__(self, name: str, clock: Clock | None = None):
        self.name = name
        self._clock = clock or MonotonicClock()
        self._lock = threading.Lock()
        self._messages: dict[str, _Stored] = {}
        self._duplicate_next_send = False
        # Counter-derived ids, not uuid4: chaos scenarios replay this
        # queue twice per seed and diff report bytes, so every id a
        # fresh instance mints must be identical run over run.  In-queue
        # uniqueness is all SQS semantics need (delete-by-receipt and
        # visibility are per queue; consumers dedup by body content).
        self._seq = itertools.count()
        self._mids = itertools.count(1)

    @property
    def duplicate_next_send(self) -> bool:
        with self._lock:
            return self._duplicate_next_send

    @duplicate_next_send.setter
    def duplicate_next_send(self, value: bool) -> None:
        # Tests arm this from the main thread while worker threads are
        # mid-send; route the write through the queue lock so the flag
        # cannot be torn between send()'s read and clear.
        with self._lock:
            self._duplicate_next_send = bool(value)

    def send(self, body: dict[str, Any]) -> str:
        # Bodies must be JSON-serializable: the wire protocol is JSON, as in
        # the reference (lambda_function.py:51-62, dl_cfn_setup_v2.py:346-357).
        json.dumps(body)
        with self._lock:
            # The backing field, not the property: the lock is already
            # held and threading.Lock does not re-enter.
            copies = 2 if self._duplicate_next_send else 1
            self._duplicate_next_send = False
            mid = ""
            for _ in range(copies):
                mid = f"{self.name}-m{next(self._mids):06d}"
                self._messages[mid] = _Stored(
                    message_id=mid,
                    body=json.loads(json.dumps(body)),
                    enqueued_seq=next(self._seq),
                )
            return mid

    def receive(
        self,
        max_messages: int = 10,
        visibility_timeout_s: float = 60.0,
    ) -> list[Message]:
        now = self._clock.now()
        out: list[Message] = []
        with self._lock:
            visible = sorted(
                (m for m in self._messages.values() if m.invisible_until <= now),
                key=lambda m: m.enqueued_seq,
            )
            for stored in visible[:max_messages]:
                stored.receive_count += 1
                stored.invisible_until = now + max(visibility_timeout_s, 0.0)
                # Unique per (message, receive): receive_count was just
                # incremented under the lock, and the mid prefix keeps
                # receipts distinct across messages.
                receipt = f"{stored.message_id}-r{stored.receive_count}"
                stored.receipts.add(receipt)
                out.append(
                    Message(
                        message_id=stored.message_id,
                        body=json.loads(json.dumps(stored.body)),
                        receipt=receipt,
                        receive_count=stored.receive_count,
                    )
                )
        return out

    def delete(self, receipt: str) -> None:
        with self._lock:
            for mid, stored in list(self._messages.items()):
                if receipt in stored.receipts:
                    del self._messages[mid]
                    return
        # Deleting an unknown receipt is a no-op, as in SQS.

    def purge(self) -> None:
        with self._lock:
            self._messages.clear()

    def approximate_depth(self) -> int:
        with self._lock:
            return len(self._messages)
