"""``llama_train``'s model-parallel layouts over NCCL, one process a card.

Each layout runs ``examples.llama_train`` as one process a rank with the
cluster contract's environment (``DEEPLEARNING_WORKERS_COUNT``,
``DLCFN_PROCESS_ID``, ``DEEPLEARNING_COORDINATOR``): on the card the entry
point joins an NCCL group and puts process ``i`` on ``cuda:i``.  Its losses
are held against one process's run of the same flags without the layout, on
the same stream, to ``RTOL`` (the tiny preset is bf16; the CPU tests hold
the same flag cases to the same limit).  The layouts are the ones whose
point-to-point or collectives differ from the data-parallel path: GPipe
(``--pp``, its activations and gradients over ``parallel/p2p.py``, straight
through on NCCL), ring attention's exchange, MoE under tp and sp (and
experts over ep with their columns over tp), sp inside the stages, tp beyond
the kv heads; ``pp2_m435`` runs GPipe at m435's widths and seq 2048, so that
the flash kernel runs in the stages over NCCL.

The ``*_captured`` rows run ``Trainer.multi_step_fn(K)`` (captured as one
CUDA graph over the NCCL group; ``llama_train`` has no ``--steps_per_call``,
nor has JAX's) in a worker of this tool's own, beside the same steps run
eagerly in the same process: the dp step (DDP's sync), the bucketed sync
in f32 and int8, and GPipe with and without remat, on the tiny preset in
f32.  The dp step and the f32 buckets must be bitwise their eager steps,
losses and parameters; the others within ``RTOL``; on the card one more
replay's trace must show NCCL's kernels on every rank.

One JSON row a layout (its ranks' losses, the reference's, the largest
relative difference, seconds), then a summary row; exit 1 if a layout fails
or disagrees.  Needs as many cards as the widest layout's ranks (4):
``python -m deeplearning_cfn_tpu_torch.tools.nccl_layouts``.  With
``--device cpu`` the same runs go over gloo on the CPU (a rehearsal; the
captured rows then run their k steps eagerly).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

RTOL = 2e-2
BASE = ["--size", "tiny", "--seq_len", "256", "--global_batch_size", "4", "--steps", "3",
        "--log_every", "1"]
LAYOUTS = {  # name: (ranks, flags, the one-process run's flags)
    "pp2": (2, ["--pp", "2"], []),
    "pp2_remat": (2, ["--pp", "2", "--remat"], ["--remat"]),
    "sp2_ring": (2, ["--sp", "2", "--ring_attention"], []),
    "moe_tp2": (2, ["--experts", "4", "--tp", "2"], ["--experts", "4"]),
    "moe_sp2": (2, ["--experts", "4", "--sp", "2"], ["--experts", "4"]),
    "sp2_pp2": (4, ["--sp", "2", "--pp", "2"], []),
    "tp4_kv2": (4, ["--tp", "4"], []),
    "moe_ep2_tp2": (4, ["--experts", "4", "--ep", "2", "--tp", "2"], ["--experts", "4"]),
    "pp2_m435": (2, ["--size", "435m", "--seq_len", "2048", "--pp", "2"],
                 ["--size", "435m", "--seq_len", "2048"]),
}
# The captured rows: (ranks, mesh, trainer overrides, bitwise against eager).
K, CAPTURED_BATCHES = 2, 4
CAPTURED = {
    "dp2_captured": (2, dict(dp=2), dict(strategy="dp"), True),
    "overlap2_captured": (2, dict(dp=2), dict(strategy="dp", comms_overlap=True,
                                              overlap_bucket_bytes=32 * 1024), True),
    "overlap2_int8_captured": (2, dict(dp=2), dict(strategy="dp", comms_overlap=True,
                                                   overlap_bucket_bytes=32 * 1024,
                                                   overlap_compress=True), False),
    "pp2_captured": (2, dict(pp=2), dict(strategy="dp"), False),
    "pp2_remat_captured": (2, dict(pp=2), dict(strategy="dp", remat=True), False),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(argv: list[str]) -> None:
    if argv[:1] == ["--captured"]:
        _captured_worker(*argv[1:3])
        return
    from deeplearning_cfn_tpu_torch.examples import llama_train

    out = llama_train.main(argv)
    print("RESULT " + json.dumps({"losses": [h["loss"] for h in out["history"]],
                                  "mesh": out["mesh"], "device": out["device"],
                                  "kernel_launches": out["kernel_launches"]}), flush=True)


def _captured_worker(device: str, name: str) -> None:
    """One rank of a captured row: ``K``-step calls of ``multi_step_fn``
    over the row's mesh, and the same batches as eager ``train_step``s from
    the same weights."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_init_distributed(device)
    _, mesh_kw, overrides, _ = CAPTURED[name]
    pp = dict(pp_stages=2, pp_microbatches=2) if mesh_kw.get("pp", 1) > 1 else {}
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(seq_len=256, dtype=torch.float32), **pp)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device(device)
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1, **overrides), device=dev, mesh=build_mesh(MeshSpec(**mesh_kw)))
    batches = list(SyntheticTokenDataset(seq_len=256, vocab_size=cfg.vocab_size,
                                         batch_size=4).batches(CAPTURED_BATCHES))
    state, eager = trainer.init(seed=0), []
    for b in batches:
        state, m = trainer.train_step(state, *device_put_batch(b, dev))
        eager.append(m["loss"].item())
    eager_final = [p.detach().clone() for p in state.model.parameters()]
    state, captured = trainer.init(seed=0), []
    kfn = trainer.multi_step_fn(K)
    for c in range(0, len(batches), K):
        xs, ys = (torch.from_numpy(np.stack([getattr(b, f) for b in batches[c:c + K]]))
                  for f in ("x", "y"))
        state, losses = kfn(state, xs, ys)
        captured += losses.tolist()
    diffs = [(p.detach() - q).abs().max().item()
             for p, q in zip(state.model.parameters(), eager_final)]
    nccl = None
    if device == "cuda":  # the NCCL kernels of one more replay
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            kfn(state, xs, ys)
            torch.cuda.synchronize()
        nccl = {e.key[:80]: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.key.startswith("nccl")}
    print("RESULT " + json.dumps({
        "losses": captured, "eager_losses": eager, "captures": getattr(kfn, "captures", None),
        "params_bitwise": all(d == 0 for d in diffs), "max_param_diff": max(diffs),
        "replay_nccl_kernels": nccl, "device": str(dev), "mesh": mesh_kw}), flush=True)


def _run(n: int, argv: list[str], timeout: float) -> list[dict]:
    """``argv`` as ``n`` rank processes; each rank's result.  The first rank
    that fails ends the run (the others would wait in a collective until
    the timeout); their output goes to files, so that no pipe fills."""
    port = _free_port()
    procs, logs = [], []
    for i in range(n):
        env = dict(os.environ, DEEPLEARNING_WORKERS_COUNT=str(n), DLCFN_PROCESS_ID=str(i),
                   DEEPLEARNING_COORDINATOR=f"127.0.0.1:{port}")
        if n == 1:  # one process: no cluster
            for key in ("DEEPLEARNING_WORKERS_COUNT", "DLCFN_PROCESS_ID",
                        "DEEPLEARNING_COORDINATOR"):
                env.pop(key)
        logs.append((tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.tools.nccl_layouts", "--worker",
             "--", *argv], env=env, stdout=logs[-1][0], stderr=logs[-1][1], text=True))
    results: list = [None] * n
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while not errors and any(r is None for r in results):
            for i, p in enumerate(procs):
                if results[i] is not None or p.poll() is None:
                    continue
                for f in logs[i]:
                    f.seek(0)
                out, err = (f.read() for f in logs[i])
                rows = [line[7:] for line in out.splitlines() if line.startswith("RESULT ")]
                if p.returncode or not rows:
                    errors.append(f"rank {i} exit {p.returncode}: {err[-2000:]}")
                    break
                results[i] = json.loads(rows[-1])
            if not errors and time.monotonic() > deadline:
                errors.append(f"timed out after {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for files in logs:
            for f in files:
                f.close()
    if errors:
        raise RuntimeError("; ".join(errors))
    return results


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--layout", action="append", choices=sorted([*LAYOUTS, *CAPTURED]),
                   help="run only these (default: every layout)")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds a run")
    args = p.parse_args(argv)
    base = BASE + ["--device", args.device]
    refs: dict[tuple, list[float]] = {}
    ok = True
    names = args.layout or [*LAYOUTS, *CAPTURED]
    for name in names:
        t0 = time.perf_counter()
        backend = "nccl" if args.device == "cuda" else "gloo"
        if name in CAPTURED:
            row = _captured_row(name, args.device, args.timeout)
            row.update(backend=backend, seconds=time.perf_counter() - t0)
            ok &= row["passed"]
            print(json.dumps(row), flush=True)
            continue
        n, flags, ref_flags = LAYOUTS[name]
        row = {"layout": name, "ranks": n, "flags": flags, "backend": backend}
        try:
            if tuple(ref_flags) not in refs:
                refs[tuple(ref_flags)] = _run(1, base + ref_flags, args.timeout)[0]["losses"]
            ref = refs[tuple(ref_flags)]
            ranks = _run(n, base + flags, args.timeout)
            losses = ranks[0]["losses"]
            diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            agree = all(r["losses"] == losses for r in ranks)
            launches = [r["kernel_launches"] for r in ranks]
            # At m435's seq 2048 the stages run the flash kernel on the card.
            flash = "435m" not in flags or args.device != "cuda" or all(
                n.get("flash_attention_fwd", 0) > 0 for n in launches)
            row.update(losses=losses, ref_losses=ref, max_rel_loss_diff=diff,
                       ranks_agree=agree, mesh=ranks[0]["mesh"],
                       devices=[r["device"] for r in ranks], kernel_launches=launches,
                       passed=agree and flash and len(losses) == len(ref) and diff <= RTOL)
        except RuntimeError as e:
            row.update(passed=False, error=str(e))
        row["seconds"] = time.perf_counter() - t0
        ok &= row["passed"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"layouts": len(names), "passed": ok, "rtol": RTOL}))
    return 0 if ok else 1


def _captured_row(name: str, device: str, timeout: float) -> dict:
    n, mesh_kw, overrides, bitwise = CAPTURED[name]
    row = {"layout": name, "ranks": n, "mesh": mesh_kw, "trainer": overrides, "k": K}
    try:
        ranks = _run(n, ["--captured", device, name], timeout)
    except RuntimeError as e:
        return {**row, "passed": False, "error": str(e)}
    losses, eager = ranks[0]["losses"], ranks[0]["eager_losses"]
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    held = (losses == eager and all(r["params_bitwise"] for r in ranks)) if bitwise \
        else diff <= RTOL
    captures = [r["captures"] for r in ranks]
    agree = all(r["losses"] == losses for r in ranks)
    row.update(losses=losses, eager_losses=eager, max_rel_loss_diff=diff, bitwise_required=bitwise,
               params_bitwise=[r["params_bitwise"] for r in ranks],
               max_param_diff=[r["max_param_diff"] for r in ranks], captures=captures,
               devices=[r["device"] for r in ranks], ranks_agree=agree,
               replay_nccl_kernels=[r["replay_nccl_kernels"] for r in ranks],
               passed=held and agree and len(losses) == CAPTURED_BATCHES
               and (device != "cuda" or (captures == [1] * n
                                         and all(r["replay_nccl_kernels"] for r in ranks))))
    return row


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[3:] if sys.argv[2:3] == ["--"] else sys.argv[2:])
    else:
        sys.exit(main())
