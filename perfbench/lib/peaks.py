"""The card's peaks, an attention call's least time, and kernel groups.

Copied from the smoke run's ``PEAK_FLOPS``, ``PEAK_BYTES``, ``bound`` and
``kernel_group``, which the smoke keeps for its own kernel table.
"""

from __future__ import annotations

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def attention_flops(b, h, sq, sk, d=64) -> float:
    """q k^T and p v: 4 b h sq sk d."""
    return 4.0 * b * h * sq * sk * d


def attention_bytes(b, h, sq, sk, d=64, itemsize=2) -> float:
    """q, k, v read and o written once."""
    return float(itemsize) * b * h * d * (2 * sq + 2 * sk)


def bound_s(b, h, sq, sk, d=64, dtype="bfloat16", itemsize=2) -> float:
    """Least seconds for one attention forward on the card: the larger of
    its operations at the peak rate and its bytes at the memory rate."""
    return max(attention_flops(b, h, sq, sk, d) / PEAK_FLOPS[dtype],
               attention_bytes(b, h, sq, sk, d, itemsize) / PEAK_BYTES)


def kernel_group(name: str) -> str:
    """The kernel group of a CUDA kernel's name in a profile. The Hopper
    attention kernels carry their tag as a template argument (k1_flash_fwd,
    k2_folded_fwd, k6_single_kv, k7_masked_flash, k9_short_fwd,
    k34_flash_bwd, k5_folded_bwd, k9_short_bwd)."""
    n = name.lower()
    if any(w in n for w in ("k7_masked_flash", "mask_bits", "masked_fwd_f32")):
        return "K7 masked_flash"
    if "folded_bwd" in n:
        return "K5 folded_bwd"
    if "short_fwd" in n:
        return "K9 short_fwd"
    if "short_bwd" in n:
        return "K9 short_bwd"
    if "single_kv" in n:
        return "K6 flash_single_kv"
    if "flash_fwd" in n:
        return "K1 flash_fwd"
    if "folded_fwd" in n:
        return "K2 folded_fwd"
    if "bwd" in n and ("dkv" in n or "dq" in n or "prep" in n):
        return "K3/K4 flash_bwd"
    if "raster_kernel" in n:
        return "K8 rasterize"
    if any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "conv" in n or "cudnn" in n or "winograd" in n or "implicit" in n:
        return "convolution"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    return "other"
