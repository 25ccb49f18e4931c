"""The program's causal attention, forward and backward, as a share of its
roofline, in percent.

``probe`` runs the port's public ``flash_attention(q, k, v, causal=True)``
and its backward several times after the window, at the cell's own batch a
rank, sequence, heads and head width, on bf16 inputs drawn from the seed,
under a device trace of its own (``portbench/trace.py``): the time is the
union of the device's activity in it.  ``read`` divides the least time the
card could take for that work (the larger of ``portbench/flops.py``'s FLOPs
over the bf16 peak and its bytes over the HBM bandwidth) by that time."""

from portbench import flops, peaks
from portbench.trace import DeviceTrace

CALLS = 5


def probe(run, handles):
    import torch

    if run.device.type != "cuda":
        return
    from deeplearning_cfn_tpu_torch.ops.flash_attention import flash_attention

    cfg, tr = run.config, run.traffic
    B, S = tr["global_batch"] // run.world, tr["seq_len"]
    H, Hkv, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    gen = torch.Generator(run.device).manual_seed(run.seed)

    def draw(h):
        return torch.randn((B, S, h, D), generator=gen, device=run.device,
                           dtype=torch.bfloat16).requires_grad_(True)

    q, k, v = draw(H), draw(Hkv), draw(Hkv)
    grad = torch.randn((B, S, H, D), generator=gen, device=run.device, dtype=torch.bfloat16)

    def once():
        flash_attention(q, k, v, causal=True).backward(grad)
        q.grad = k.grad = v.grad = None

    once()
    once()
    torch.cuda.synchronize(run.device)
    tracer = DeviceTrace()
    tracer.start()
    for _ in range(CALLS):
        once()
    torch.cuda.synchronize(run.device)
    tracer.stop()
    f, b = flops.causal_attention(B, S, H, Hkv, D)
    run.probes["attention"] = {"seconds": tracer.summarise()["busy_s"] / CALLS,
                               "flops": f, "bytes": b}


def read(run):
    p = run.probes.get("attention")
    if not p:
        return None
    bound = max(p["flops"] / peaks.BF16_FLOPS, p["bytes"] / peaks.HBM_BYTES_PER_S)
    return bound / p["seconds"] * 100
