"""The measured window, driven from ``Trainer.fit``'s ``stop_fn``.

``fit`` reads the losses back, which waits for the device, at every
multiple of ``log_every`` steps and then asks ``stop_fn``; the window is a
run of those synchronised points.  Before it, the first ``warmup_steps``
steps are set-up.  On the card the first readback at or past
``warmup_steps`` empties the allocator's cache (the checks' reads leave
blocks there), and the window opens at the next, once the steps between
have reserved again what they use, with the allocator's peak reset; on the
CPU it opens at the first.  It closes at the first readback ``seconds``
after it opened; every step between counts.  Over several ranks every rank
releases, opens and closes at the same readback: the decision is the
ranks' maximum."""

from __future__ import annotations

import time
from typing import Callable

import torch


class Window:
    def __init__(self, state, seconds: float, warmup_steps: int, device=None,
                 agree: Callable[[bool], bool] | None = None, on_open=None, on_close=None):
        self.state, self.seconds, self.warmup = state, seconds, warmup_steps
        self.device, self.agree = device, agree or (lambda flag: flag)
        self.on_open, self.on_close = on_open, on_close
        self.opened = self.closed = None  # perf_counter stamps
        self.opened_wall = None
        self.first_step = self.last_step = None
        self.reserved_before_opening = None  # bytes reserved before the release

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, metrics) -> bool:
        step = self.state.step
        if self.opened is None:
            if step < self.warmup:
                return False
            self._sync()
            self.agree(False)  # every rank here before the window opens
            if self.device is not None and self.device.type == "cuda":
                if self.reserved_before_opening is None:
                    self.reserved_before_opening = torch.cuda.memory_reserved(self.device)
                    torch.cuda.empty_cache()
                    return False
                torch.cuda.reset_peak_memory_stats(self.device)
            if self.on_open is not None:
                self.on_open()
            self.opened, self.opened_wall = time.perf_counter(), time.time()
            self.first_step = step
            return False
        done = self.agree(time.perf_counter() - self.opened >= self.seconds)
        if done:
            self._sync()
            self.closed = time.perf_counter()
            self.last_step = step
            if self.on_close is not None:
                self.on_close()
        return done

    @property
    def steps(self) -> int:
        return self.last_step - self.first_step

    @property
    def elapsed(self) -> float:
        return self.closed - self.opened
