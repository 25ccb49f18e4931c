"""The benchmark's own arithmetic against hand-worked values."""

import json

import pytest

from portbench import flops, intervals, spec, trace


def test_causal_attention_counts():
    # B=1, S=4, one head of width 2: 10 scored pairs; 6 products of 2·10·2 FLOPs.
    f, b = flops.causal_attention(1, 4, 1, 1, 2, bytes_per_element=2)
    assert f == 6 * 2 * 10 * 2
    # forward q,k,v,o + backward q,k,v,o,dO,dq,dk,dv: 12 tensors of 4·2 elements.
    assert b == 12 * 4 * 2 * 2
    f, _ = flops.causal_attention(1, 4, 1, 1, 2, backward=False)
    assert f == 2 * 2 * 10 * 2


def test_decoder_flops_of_mistral_stage():
    cfg = spec.load_config(spec.load_benchmark(), "mistral7b-8of32")
    d, m, V, L = 4096, 14336, 32768, 8
    per_layer = 2 * d + d * 4096 + 2 * d * 1024 + 4096 * d + 3 * d * m
    n = 2 * V * d + L * per_layer + d
    assert flops.decoder_param_count(cfg) == n
    assert n == 2_013_335_552
    assert flops.decoder_train_flops_per_token(cfg, 4096) == 6 * n + 6 * L * d * 4096


def test_resnet50_flops_match_the_published_count():
    cfg = spec.load_config(spec.load_benchmark(), "resnet50")
    per_image = flops.resnet_train_flops(cfg, 1, 224)
    # 4.1 G multiply-adds forward (He et al., Table 1: 3.8e9 FLOPs counted as
    # multiply-adds, the v1.5 stride adds ~0.3e9): ×2 FLOPs, ×3 for training.
    assert 3 * 2 * 4.0e9 < per_image < 3 * 2 * 4.2e9
    assert flops.resnet_train_flops(cfg, 256, 224) == 256 * per_image


def test_interval_union_and_subtraction():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert intervals.union(spans) == [(0, 3), (5, 6)]
    assert intervals.covered(spans) == 4
    assert intervals.subtract([(0, 10)], spans) == [(3, 5), (6, 10)]
    assert intervals.subtract([(1, 6)], [(0, 2), (4, 5)]) == [(2, 4), (5, 6)]
    assert intervals.gaps(spans, -1, 7) == [(-1, 0), (3, 5), (6, 7)]
    assert intervals.clip(spans, 1, 5.6) == [(1, 2), (1, 3), (5, 5.6), (5.5, 5.6)]


def _ev(name, cat, ts, dur, tid=1, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": pid}


def test_trace_summary_counts_overlap_once():
    events = [
        _ev(trace.MARK, "user_annotation", 0, 100),
        _ev("aten::mm", "cpu_op", 0, 40),
        _ev("cudaStreamSynchronize", "cuda_runtime", 40, 60),
        _ev("gemm", "kernel", 10, 30, tid=7, pid=0),
        _ev("ncclDevKernel_AllReduce", "kernel", 20, 40, tid=8, pid=0),  # 40..60 exposed
        _ev("Memcpy HtoD", "gpu_memcpy", 70, 10, tid=9, pid=0),
        _ev("late", "kernel", 95, 20, tid=7, pid=0),  # clipped at 100
    ]
    s = trace.summarise(json.loads(json.dumps(events)))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((50 + 10 + 5) * 1e-6)
    assert s["nccl_exposed_s"] == pytest.approx(20e-6)
    gaps = [(name, round(d * 1e6)) for name, d in s["idle_gaps"]]
    # 80..95 first (the longest), then 0..10 and 60..70 (either order).
    assert gaps[0] == ("cudaStreamSynchronize", 15)
    assert sorted(gaps[1:]) == [("aten::mm", 10), ("cudaStreamSynchronize", 10)]
    assert s["device_ops"][0][0] == "ncclDevKernel_AllReduce"
