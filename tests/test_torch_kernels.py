"""Build and argument rules of the port's CUDA kernels, checked on the CPU.

- ``library_path`` names a library by a hash of its source, of every header
  under ``csrc/`` (the kernels share ``hopper.cuh``) and of the flags, so an
  edited header rebuilds every library.  Checked on a copy of ``csrc/``; no
  ``nvcc`` is needed.
- The flash wrapper refuses what the wgmma/TMA kernel does not take (strides
  TMA cannot describe, an empty key sequence, a head dim other than 64 or
  128) before anything is built or launched, so the refusal shows on CPU
  tensors too, and no launch is counted.
- On a card (``cuda`` tests): the f32 fused dense's rule for splitting K
  across a cluster, and the variant its launch reports.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch.ops import _kernels  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture()
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, copy)
    monkeypatch.setattr(_kernels, "CSRC", copy)
    return copy


def _append(path, text):
    path.write_text(path.read_text() + text)


# name: (file edited, whether the libraries' names change)
EDITS = {
    "shared-header": ("hopper.cuh", True),
    "new-header": ("extra.cuh", True),
    "flash-source": ("flash_attn_fwd.cu", True),
    "unrelated-file": ("notes.txt", False),
}


@pytest.mark.parametrize("edit", list(EDITS))
def test_library_path_follows_sources_and_headers(csrc_copy, edit):
    fname, changes = EDITS[edit]
    before = {n: _kernels.library_path(n) for n in ("flash_attn_fwd", "fused_dense")}
    target = csrc_copy / fname
    if target.exists():
        _append(target, "\n// edited\n")
    else:
        target.write_text("// new\n")
    after = {n: _kernels.library_path(n) for n in before}
    if fname == "flash_attn_fwd.cu":
        assert after["flash_attn_fwd"] != before["flash_attn_fwd"]
        assert after["fused_dense"] == before["fused_dense"]
    else:
        assert (after != before) == changes
        assert (after["flash_attn_fwd"] != before["flash_attn_fwd"]) == changes
        assert (after["fused_dense"] != before["fused_dense"]) == changes


def test_library_path_is_stable_and_in_the_build_dir(csrc_copy):
    a = _kernels.library_path("fused_dense")
    assert a == _kernels.library_path("fused_dense")
    assert a.parent == _kernels.BUILD_DIR and a.name.startswith("libfused_dense-")


def test_every_kernel_source_includes_the_shared_header():
    for name in _kernels._SIGNATURES:
        assert '#include "hopper.cuh"' in (_kernels.CSRC / f"{name}.cu").read_text()


def test_tensor_map_cache_is_keyed_by_every_encoding_argument():
    """The tensor-map cache returns a map for (base, dims, strides, box): its
    key must hold the element type and the swizzle too, or a map of bf16
    tiles would be handed back for a byte map of the same address."""
    import re

    text = (_kernels.CSRC / "hopper.cuh").read_text()
    cached = text[text.index("inline bool cached_tensor_map("):]
    key = re.search(r"struct Key \{([^}]*)\}", cached).group(1)
    for field in ("base", "dtype", "swizzle", "dims", "strides", "box"):
        assert re.search(rf"\b{field}\b", key), field
    params = re.search(r"cached_tensor_map\(([^)]*)\)", cached).group(1)
    assert "CUtensorMapDataType dtype" in params and "CUtensorMapSwizzle swizzle" in params


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _bad_head_dim_stride():
    q = _bf16(1, 16, 2, 64, 2)[..., 0]  # head-dim stride 2
    k = v = _bf16(1, 16, 2, 64)
    return q, k, v


def _bad_row_stride():
    q = _bf16(1, 16, 2, 68)[..., :64]  # rows 136 bytes apart: not TMA's 16-byte rule
    k = v = _bf16(1, 16, 2, 64)
    return q, k, v


def _misaligned_base():
    q = _bf16(1, 16 * 2 * 64 + 4).reshape(-1)[4:].view(1, 16, 2, 64)  # base 8 bytes off
    k = v = _bf16(1, 16, 2, 64)
    return q, k, v


# name: (q, k, v) -> (exception, message)
REFUSED = {
    "head-dim-stride": (_bad_head_dim_stride, ValueError, "unit stride"),
    "row-stride": (_bad_row_stride, ValueError, "16-byte"),
    "misaligned-base": (_misaligned_base, ValueError, "16-byte"),
    "empty-keys": (lambda: (_bf16(1, 16, 2, 64), _bf16(1, 0, 2, 64), _bf16(1, 0, 2, 64)),
                   ValueError, "non-empty"),
    "empty-queries": (lambda: (_bf16(1, 0, 2, 64), _bf16(1, 16, 2, 64), _bf16(1, 16, 2, 64)),
                      ValueError, "non-empty"),
    "head-dim-32": (lambda: (_bf16(1, 16, 2, 32),) * 3, ValueError, "head dim 32"),
    "head-dim-256": (lambda: (_bf16(1, 16, 2, 256),) * 3, ValueError, "head dim 256"),
    "gqa-ratio": (lambda: (_bf16(1, 16, 4, 64), _bf16(1, 16, 3, 64), _bf16(1, 16, 3, 64)),
                  ValueError, "multiple of kv heads"),
    "dtype": (lambda: (torch.zeros(1, 16, 2, 64, dtype=torch.float16),) * 3, TypeError,
              "bf16 or f32"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(case):
    make, exc, match = REFUSED[case]
    q, k, v = make()
    before = dict(_kernels.launch_counts)
    with pytest.raises(exc, match=match):
        _kernels.flash_attn_fwd(q, k, v, causal=True, sm_scale=0.125)
    assert _kernels.launch_counts == before


def test_flash_wrapper_takes_strided_views_up_to_the_device_check():
    """q, k, v as views of one [B, S, 3, H, D] tensor have strides TMA can
    describe: the only refusal on the CPU is the device."""
    qkv = _bf16(2, 16, 3, 2, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_attn_fwd(q, k, v, causal=True, sm_scale=0.125)


def test_launch_counts_follow_the_variant_the_launcher_reports():
    """A launch counts once under the kernel's name and once under the variant
    the C launcher wrote back; a reset zeroes the names and drops the variants."""
    import ctypes

    _kernels.reset_launch_counts()
    try:
        for code in (3, 3, 2):
            _kernels._count_launch("fused_dense", ctypes.c_int(code))
        _kernels._count_launch("flash_attention_fwd", ctypes.c_int(1))
        assert _kernels.launch_counts == {
            "flash_attention_fwd": 1, "fused_dense": 3, "fused_dense_quantized": 0,
            "flash_attention_fwd/wgmma_tma": 1,
            "fused_dense/wgmma_tma_pingpong_128x128": 2, "fused_dense/wgmma_tma_128x192": 1,
        }
    finally:
        _kernels.reset_launch_counts()
    assert _kernels.launch_counts == dict.fromkeys(_kernels._KERNELS, 0)


# The enum of variant codes each kernel's launcher writes back.
_VARIANT_ENUMS = {"flash_attention_fwd": "Variant", "fused_dense": "Variant",
                  "fused_dense_quantized": "QuantVariant"}


@pytest.mark.parametrize("source,kernel", [("flash_attn_fwd", "flash_attention_fwd"),
                                           ("fused_dense", "fused_dense"),
                                           ("fused_dense", "fused_dense_quantized")])
def test_variant_names_cover_the_launchers_enum(source, kernel):
    """Every code of a launcher's variant enum has a name in the wrapper, and
    every launcher writes the variant back through its last argument."""
    import re

    text = (_kernels.CSRC / f"{source}.cu").read_text()
    enum = re.search(rf"enum {_VARIANT_ENUMS[kernel]} \{{([^}}]*)\}}", text).group(1)
    codes = {int(v) for v in re.findall(r"=\s*(\d+)", enum)}
    assert codes == set(_kernels._VARIANTS[kernel])
    for fn, argtypes in _kernels._SIGNATURES[source].items():
        assert argtypes[-1] is _kernels._PI
        assert re.search(rf'extern "C" int {fn}\([^)]*int\* variant\)', text)


# --- on the card -------------------------------------------------------------


# (M, K, N): the ResNet-50 head (6 tiles of 128 x 192: split), a shape whose
# tiles fill the card (no split), and one with too few K chunks to split (2).
F32_SPLIT_SHAPES = {"head": (128, 2048, 1000), "many-tiles": (2048, 256, 2048),
                    "short-k": (128, 64, 1000)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F32_SPLIT_SHAPES))
def test_f32_split_rule_and_variant_on_card(shape):
    """The f32 launcher splits K over a cluster only where 128 x 192 tiles
    leave half the SMs idle, by a power of two up to 16 that gives every CTA
    its own SM and two K chunks or more; the variant it reports follows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    m, k, n = F32_SPLIT_SHAPES[shape]
    splits = _kernels.fused_dense_f32_splits(m, n, k)
    tiles = -(-m // 128) * -(-n // 192)
    num_k = -(-k // 32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert splits in (1, 2, 4, 8, 16)
    if 2 * tiles > sms or num_k < 4:
        assert splits == 1
    else:
        assert splits > 1 and tiles * splits <= sms and num_k >= 2 * splits
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(k, n, device="cuda", generator=gen) / k**0.5
    b = torch.randn(n, device="cuda", generator=gen)
    _kernels.reset_launch_counts()
    _kernels.fused_dense(x, w, b, activation=None)
    torch.cuda.synchronize()
    variant = "wgmma_tma_bf16x6_splitk_128x192" if splits > 1 else "wgmma_tma_bf16x6_128x192"
    assert _kernels.launch_counts == {"flash_attention_fwd": 0, "fused_dense": 1,
                                      "fused_dense_quantized": 0, f"fused_dense/{variant}": 1}
