"""Cluster lifecycle events — counterpart of ``deeplearning_cfn_tpu/provision/events.py``,
copied (the port imports nothing of the JAX package).

The reference's elasticity loop is driven by ASG lifecycle notifications
fanned through SNS to a Lambda (deeplearning.template:681-689,755-768); the
Lambda dispatches on ``message['Event']`` strings like
``autoscaling:EC2_INSTANCE_LAUNCH`` (lambda_function.py:37-44).  This module
defines the typed TPU-native equivalents plus the event bus that replaces
SNS: synchronous fan-out to subscribed handlers, with the same at-least-once
caveat (a backend may deliver an event twice; handlers must be idempotent).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.events")


class EventKind(enum.Enum):
    # Names mirror the ASG event vocabulary the reference dispatches on
    # (lambda_function.py:37-44) so operators can map alarms 1:1.
    INSTANCE_LAUNCH = "instance-launch"
    INSTANCE_LAUNCH_ERROR = "instance-launch-error"
    INSTANCE_TERMINATE = "instance-terminate"
    INSTANCE_TERMINATE_ERROR = "instance-terminate-error"
    TEST_NOTIFICATION = "test-notification"  # autoscaling:TEST_NOTIFICATION analog
    # SLO alert transitions (obs/slo.py): detail carries rule name, state
    # ("firing"/"resolved"), metric, observed value.  Published on the same
    # bus as lifecycle so one subscription sees both planes — the CloudWatch
    # alarm -> SNS topic analog.
    ALERT = "alert"


@dataclass
class LifecycleEvent:
    kind: EventKind
    group: str  # worker-group (ASG analog) name
    instance_id: str | None = None
    detail: dict[str, Any] = field(default_factory=dict)


EventHandler = Callable[[LifecycleEvent], None]


class EventBus:
    """Synchronous SNS-topic analog: publish fans out to all subscribers.

    Delivery is at-least-once by contract — tests exercise duplicate
    publishes — so subscribers (the elasticity controller) must be
    idempotent, exactly as the reference's Lambda had to tolerate SQS/SNS
    redelivery (dedup at dl_cfn_setup_v2.py:142-149 exists because of this).
    """

    def __init__(self) -> None:
        self._subscribers: list[EventHandler] = []

    def subscribe(self, handler: EventHandler) -> None:
        self._subscribers.append(handler)

    def unsubscribe(self, handler: EventHandler) -> None:
        """Remove a handler (no-op if absent) — a retired controller must
        not keep answering lifecycle events for a recreated cluster."""
        try:
            self._subscribers.remove(handler)
        except ValueError:
            pass

    def publish(self, event: LifecycleEvent) -> None:
        """Fan out to every subscriber, isolating per-handler failures.

        One broken observer (a flight-recorder sink with a full disk, a
        metrics hook) must not starve the elasticity controller of the
        INSTANCE_TERMINATE it recovers from — SNS likewise delivers to
        the remaining subscriptions when one endpoint errors.
        """
        for handler in list(self._subscribers):
            try:
                handler(event)
            except Exception:
                log.exception(
                    "event handler %r failed on %s for group %s",
                    handler, event.kind.value, event.group,
                )
