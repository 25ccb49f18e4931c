"""Elasticity controller — the event-driven capacity policy.  Counterpart of
``deeplearning_cfn_tpu/cluster/elasticity.py``, copied.

TPU-native rebuild of cfn-lambda_function/lambda_function.py.  Subscribes to
the provisioner's event bus (the SNS-topic analog) and implements the same
policy, per worker group:

- On INSTANCE_LAUNCH (lambda_function.py:94-134): count healthy
  launched/pending instances; when launched == desired, post a
  ``group-setup`` success message to the coordinator queue (:51-62,119),
  signal the group's readiness resource (the CloudFormation
  ``signal_resource`` analog, :121-128), and freeze group membership so
  discovery and autoscaling cannot race (suspend ReplaceUnhealthy, :129-132).
- On INSTANCE_LAUNCH_ERROR (:142-169): **degrade-and-continue** — if healthy
  >= group minimum, shrink desired capacity to what actually launched,
  freeze membership, and still report success; otherwise signal FAILURE.
- On INSTANCE_TERMINATE after the membership freeze: record the loss and
  surface recreate-and-resume guidance (the reference documents but does not
  automate this: StackSetup.md:107-117).

Like the Lambda, the controller is stateless across events with respect to
success reporting: a duplicated event can produce a duplicated success
message.  Consumers dedup by group name, exactly as the master bootstrap did
(dl_cfn_setup_v2.py:142-149).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.provision.backend import Backend, InstanceState, ResourceSignal
from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.elasticity")

GROUP_SETUP_EVENT = "group-setup"


@dataclass
class GroupPolicy:
    name: str
    minimum: int
    signal_resource: str  # resource name to signal when this group settles
    coordinator: bool = False  # True for the group hosting worker 0


@dataclass
class TerminateDebouncer:
    """Coalesce per-group INSTANCE_TERMINATE bursts into one notification.

    A multi-host slice death arrives as N terminate events (one per host,
    possibly duplicated — the event bus is at-least-once).  Resharding once
    per event would tear the mesh down N times; this debouncer opens a
    window at the first loss in a group, buffers everything that lands
    inside it (deduplicating by instance id), and hands the whole burst to
    ``on_flush`` exactly once when the window elapses.  A loss arriving
    after a flush opens a *new* window — two genuinely separate bursts are
    two notifications, by design.

    Time comes from the injected ``clock`` (``time.monotonic`` by default;
    a virtual clock in tests and chaos scenarios), and flushing is pull —
    callers decide the safe point, matching the detection/recovery split
    documented in cluster/recovery.py.  Single-threaded by construction:
    observe() runs inside synchronous event dispatch, flush() at the
    caller's safe point.
    """

    window_s: float = 0.0
    clock: Callable[[], float] = time.monotonic
    on_flush: Callable[[str, list[LifecycleEvent]], None] | None = None
    _pending: dict[str, list[LifecycleEvent]] = field(default_factory=dict)
    _opened_at: dict[str, float] = field(default_factory=dict)
    _seen: dict[str, set[str]] = field(default_factory=dict)

    def observe(self, group: str, event: LifecycleEvent) -> None:
        if group not in self._pending:
            self._pending[group] = []
            self._seen[group] = set()
            self._opened_at[group] = self.clock()
        if event.instance_id:
            if event.instance_id in self._seen[group]:
                return
            self._seen[group].add(event.instance_id)
        self._pending[group].append(event)

    def flush(self, force: bool = False) -> list[tuple[str, list[LifecycleEvent]]]:
        """Fire ``on_flush`` for every group whose window elapsed (or all
        buffered groups when ``force``); returns the flushed bursts."""
        now = self.clock()
        ripe = [
            g
            for g, opened in self._opened_at.items()
            if force or now - opened >= self.window_s
        ]
        out = []
        for group in ripe:
            burst = self._pending.pop(group)
            self._opened_at.pop(group)
            self._seen.pop(group)
            out.append((group, burst))
            if self.on_flush is not None:
                self.on_flush(group, burst)
        return out


@dataclass
class ElasticityController:
    backend: Backend
    coordinator_queue_name: str
    policies: dict[str, GroupPolicy] = field(default_factory=dict)
    lost_instances: list[str] = field(default_factory=list)
    degraded_groups: set[str] = field(default_factory=set)
    # Called on every post-provision instance loss (terminate events for a
    # managed group).  The recovery automation (cluster/recovery.py) hangs
    # off this seam; the reference had no equivalent — its Lambda only
    # logged terminations (lambda_function.py:173-199).
    on_instance_loss: Callable[[GroupPolicy, LifecycleEvent], None] | None = None
    # Called with (group, burst) once per coalesced terminate burst — the
    # live-reshard seam (train/reshard.py).  Unlike on_instance_loss this
    # fires from flush_slice_losses() at the caller's safe point, never
    # inside event dispatch, so a reshard cannot re-enter the event bus.
    on_slice_loss: Callable[[str, list[LifecycleEvent]], None] | None = None
    slice_loss_window_s: float = 0.0
    clock: Callable[[], float] = time.monotonic
    # Hooks run on every flush_slice_losses() call — i.e. at the caller's
    # safe point (the trainer's step boundary), never inside event
    # dispatch.  The fleet arbiter (sched/arbiter.py) registers its
    # reconcile() here so capacity decisions land between steps, with the
    # same re-entrancy guarantee the slice-loss seam has.
    safe_point_hooks: list[Callable[[], None]] = field(default_factory=list)
    _debounce: TerminateDebouncer | None = field(default=None, repr=False)

    def register(self, policy: GroupPolicy) -> None:
        self.policies[policy.name] = policy

    def attach(self) -> None:
        self.backend.events.subscribe(self.handle)

    def detach(self) -> None:
        self.backend.events.unsubscribe(self.handle)

    # --- event dispatch (lambda_handler + get_handler analog) -----------
    def handle(self, event: LifecycleEvent) -> None:
        policy = self.policies.get(event.group)
        if policy is None:
            log.debug("event for unmanaged group %s ignored", event.group)
            return
        if event.kind is EventKind.INSTANCE_LAUNCH:
            self._on_launch(policy)
        elif event.kind is EventKind.INSTANCE_LAUNCH_ERROR:
            self._on_launch_error(policy, event)
        elif event.kind in (EventKind.INSTANCE_TERMINATE, EventKind.INSTANCE_TERMINATE_ERROR):
            self._on_terminate(policy, event)
        elif event.kind is EventKind.TEST_NOTIFICATION:
            log.info("test notification for group %s", event.group)
        elif event.kind is EventKind.ALERT:
            # SLO alerts (obs/slo.py) share the bus; capacity arbitration
            # on them belongs to the fleet arbiter (sched/arbiter.py),
            # which subscribes alongside.  The controller only surfaces
            # them — its job stays per-group lifecycle, not fleet policy.
            log.info(
                "alert %s for group %s: %s",
                event.detail.get("state", "?"), event.group, event.detail,
            )

    # --- helpers ---------------------------------------------------------
    def _counts(self, name: str) -> tuple[int, int]:
        group = self.backend.describe_group(name)
        healthy = [
            i
            for i in group.instances
            if i.healthy and i.state in (InstanceState.PENDING, InstanceState.RUNNING)
        ]
        return len(healthy), group.desired

    def _send_success(self, policy: GroupPolicy, launched: int) -> None:
        queue = self.backend.get_queue(self.coordinator_queue_name)
        queue.send(
            {
                "event": GROUP_SETUP_EVENT,
                "status": "success",
                "group": policy.name,
                "launched": launched,
                "degraded": policy.name in self.degraded_groups,
            }
        )
        self.backend.signal_resource(policy.signal_resource, ResourceSignal.SUCCESS)
        self.backend.suspend_replace_unhealthy(policy.name)
        get_recorder().record(
            "group_settled",
            group=policy.name,
            launched=launched,
            degraded=policy.name in self.degraded_groups,
        )
        log.info(
            "group %s settled: launched=%d degraded=%s",
            policy.name,
            launched,
            policy.name in self.degraded_groups,
        )

    # --- handlers ---------------------------------------------------------
    def _on_launch(self, policy: GroupPolicy) -> None:
        launched, desired = self._counts(policy.name)
        log.info("launch event: group=%s launched=%d desired=%d", policy.name, launched, desired)
        if launched == desired:
            self._send_success(policy, launched)

    def _on_launch_error(self, policy: GroupPolicy, event: LifecycleEvent) -> None:
        launched, desired = self._counts(policy.name)
        log.warning(
            "launch error in group %s (%s): launched=%d desired=%d min=%d",
            policy.name,
            event.detail.get("cause", "unknown"),
            launched,
            desired,
            policy.minimum,
        )
        if launched >= policy.minimum:
            # Degrade and continue (lambda_function.py:161-167; README.md:49):
            # accept the capacity that materialized and freeze it.
            if launched != desired:
                self.backend.set_desired_capacity(policy.name, launched)
                self.degraded_groups.add(policy.name)
            self._send_success(policy, launched)
        else:
            self.backend.signal_resource(policy.signal_resource, ResourceSignal.FAILURE)
            log.error(
                "group %s below minimum (%d < %d): signaling FAILURE",
                policy.name,
                launched,
                policy.minimum,
            )

    def _on_terminate(self, policy: GroupPolicy, event: LifecycleEvent) -> None:
        # The reference only logs terminations (lambda_function.py:173-199) and
        # documents that membership is NOT updated (StackSetup.md:107-108).  We
        # log, record, and leave recovery to checkpoint-resume — but make the
        # loss programmatically visible instead of burying it in CloudWatch.
        if event.instance_id:
            self.lost_instances.append(event.instance_id)
        get_recorder().record(
            "instance_lost",
            group=policy.name,
            instance_id=event.instance_id,
            reason=event.detail.get("reason"),
        )
        log.warning(
            "instance %s terminated in group %s; cluster contract is now stale — "
            "recreate the cluster (reusing storage) and resume from checkpoint",
            event.instance_id,
            policy.name,
        )
        if self.on_instance_loss is not None:
            self.on_instance_loss(policy, event)
        if self.on_slice_loss is not None:
            if self._debounce is None:
                self._debounce = TerminateDebouncer(
                    window_s=self.slice_loss_window_s,
                    clock=self.clock,
                    on_flush=self._fire_slice_loss,
                )
            self._debounce.observe(policy.name, event)

    def add_safe_point_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` at every safe point (see ``safe_point_hooks``)."""
        self.safe_point_hooks.append(hook)

    def flush_slice_losses(self, force: bool = False) -> list[str]:
        """Deliver coalesced slice-loss bursts whose debounce window has
        elapsed (the live-reshard coordinator calls this at each step
        boundary), then run the registered safe-point hooks.  Returns
        the groups flushed."""
        flushed: list[str] = []
        if self._debounce is not None:
            flushed = [group for group, _ in self._debounce.flush(force=force)]
        for hook in self.safe_point_hooks:
            hook()
        return flushed

    def _fire_slice_loss(self, group: str, burst: list[LifecycleEvent]) -> None:
        get_recorder().record(
            "slice_loss_coalesced",
            group=group,
            instances=sorted(e.instance_id or "?" for e in burst),
            events=len(burst),
        )
        log.warning(
            "slice loss coalesced: group %s lost %d instance(s) in one burst",
            group,
            len(burst),
        )
        if self.on_slice_loss is not None:
            self.on_slice_loss(group, burst)
