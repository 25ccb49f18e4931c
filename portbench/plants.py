"""Faults planted in the program, for the tests that show the comparison
catches them.  Each patches the program in the process that runs it; the
command line reaches none of them.

- ``unchanged``: every optimizer step returns the state as it was;
- ``half_batch``: each step trains on the first half of its rows, the mean
  over those;
- ``no_exchange``: the data ranks exchange nothing: no gradient all-reduce
  (each rank keeps its own mean) and BatchNorm's sums stay local;
- ``altered_loss``: the loss is scaled by 1.05 where it is produced.
"""

from __future__ import annotations

import contextlib

PLANTS = ("unchanged", "half_batch", "no_exchange", "altered_loss")


class _Done:
    def wait(self):
        return True


@contextlib.contextmanager
def planted(name: str | None):
    """The program with fault ``name`` planted inside the block (none for
    None), restored after it."""
    saved: list[tuple[object, str, object]] = []
    if name is not None:
        _apply(name, saved)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def _apply(name: str, saved: list) -> None:
    import torch

    from deeplearning_cfn_tpu_torch.models import llama, resnet
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.train import trainer

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        def no_step(self, closure=None):
            return None

        patch(torch.optim.AdamW, "step", no_step)
        patch(trainer.SGD, "step", no_step)
    elif name == "half_batch":
        local = trainer.Trainer._local_batch

        def half(self, t):
            return trainer.tree_map(lambda a: a[: a.shape[0] // 2], local(self, t))

        patch(trainer.Trainer, "_local_batch", half)
    elif name == "no_exchange":
        real = overlap.dist

        class Alone:
            def __getattr__(self, attr):
                return getattr(real, attr)

            @staticmethod
            def all_reduce(t, group=None, async_op=False, **kw):
                t.mul_(real.get_world_size(group))  # undo the 1/n: this rank's own mean
                return _Done() if async_op else None

        patch(overlap, "dist", Alone())
        patch(resnet, "global_sum", lambda t: t)
    elif name == "altered_loss":
        xent, lm = trainer.softmax_xent, llama.causal_lm_loss

        def scaled_xent(*a, **kw):
            return xent(*a, **kw) * 1.05

        def scaled_lm(*a, **kw):
            loss, metrics = lm(*a, **kw)
            return loss * 1.05, metrics

        patch(trainer, "softmax_xent", scaled_xent)
        patch(llama, "causal_lm_loss", scaled_lm)
    else:
        raise ValueError(f"unknown plant {name!r}; one of {PLANTS}")
