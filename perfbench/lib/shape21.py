"""Operations and bytes of a Hunyuan3D-2.1 shape request, counted from the
shapes, and the readings of the ``*.shape21`` per-layer metrics.

:func:`request_flops` runs the plain reference on the ``meta`` device (no
storage, no arithmetic) under PyTorch's ``FlopCounterMode``, which counts
2 m n k for every matrix product at the request's own shapes. Without data
there is no routing: the mixture of experts counts two routed FFNs
and the shared one a token, whatever the routing
(``perfbench/reference/hunyuan21.py``), so the count does not depend on
the router.

:func:`k1_d128_calls` lists the DiT's attention calls on K1 at head dim
128 (self-attention over the timestep token and the latents, and
cross-attention to the condition, every block of every step at the CFG
batch of 2). :func:`moe_work` is the expert FFNs' work a request: the
two routed and the shared FFN of every token, the experts' weights
read and the rows read and written once by the two grouped GEMMs of a
layer's step.
"""

from __future__ import annotations

from perfbench.lib.peaks import PEAK_BYTES, PEAK_FLOPS, bound_s
from perfbench.lib.readers import kernel_s

# the routed experts a token (the release's top-2 router)
TOP_K = 2
# the DiT's K1 kernels at head dim 128 (fwd_bf16<..., k1_flash_fwd_d128>)
K1_D128 = "k1_flash_fwd_d128"
# the grouped GEMM's CUTLASS kernels (torch._grouped_mm): their names hold
# the grouped problem shape
GROUPED = "GroupProblemShape"


def request_flops(cfg: dict) -> dict:
    """{"conditioner", "denoise", "vae_decode"}: FLOPs of one request (the
    DiT at batch 2, the classifier-free-guidance pair, at every step)."""
    import torch

    from perfbench.lib.flops import _count
    from perfbench.reference.hunyuan21 import model_makers
    makers = model_makers(cfg)
    s, g = cfg["image_size"], cfg["image_size"] // 14

    def cond():
        makers["conditioner"]()(torch.empty(1, s, s, 3))

    def denoise():
        makers["dit"]()(torch.empty(2, cfg["num_latents"], cfg["latent_dim"]),
                        torch.empty(2), torch.empty(2, 1 + g * g, cfg["cond_dim"]))

    def vae():
        makers["vae"]().decode(torch.empty(1, cfg["num_latents"], cfg["latent_dim"]))
    return {"conditioner": _count(cond), "denoise": _count(denoise) * cfg["steps"],
            "vae_decode": _count(vae)}


def k1_d128_calls(cfg: dict) -> list[tuple]:
    """(count, b, h, sq, sk, head_dim) of each K1 call site at head dim 128
    in a request."""
    g = cfg["image_size"] // 14
    tokens, cond = 1 + cfg["num_latents"], 1 + g * g
    n, h = cfg["dit_depth"] * cfg["steps"], cfg["dit_heads"]
    d = cfg["dit_hidden"] // h
    return [(n, 2, h, tokens, tokens, d), (n, 2, h, tokens, cond, d)]


def moe_work(cfg: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the expert FFNs' grouped GEMMs in a request: every
    token's two routed FFNs and the shared one; the weights of all
    the experts and the shared one, and each GEMM's rows, read and written
    once, in bf16."""
    t = 2 * (1 + cfg["num_latents"])              # tokens at the CFG batch
    rows = t * (TOP_K + 1)
    d, f = cfg["dit_hidden"], 4 * cfg["dit_hidden"]
    n = cfg["dit_moe_layers"] * cfg["steps"]
    flops = n * rows * 2 * (2.0 * d * f)
    weights = (cfg["dit_experts"] + 1) * 2 * d * f * 2
    act = rows * 2 * (d + f) * 2                   # x -> h, h -> y
    return flops, float(n * (weights + act))


def attn_roofline(ctx) -> float | None:
    """The least time of a request's K1 calls at head dim 128 over their
    kernels' device time a traced request, in %."""
    spent = kernel_s(ctx, K1_D128)
    if spent is None:
        return None
    least = sum(c * bound_s(b, h, sq, sk, d)
                for c, b, h, sq, sk, d in k1_d128_calls(ctx["state"].cell.config))
    return 100.0 * least / spent


def moe_roofline(ctx) -> float | None:
    """The expert FFNs' least time (:func:`moe_work` at the card's peaks)
    over the grouped GEMMs' device time a traced request, in %."""
    spent = kernel_s(ctx, GROUPED)
    if spent is None:
        return None
    flops, nbytes = moe_work(ctx["state"].cell.config)
    return 100.0 * max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES) / spent


def moe_s(ctx) -> float | None:
    """Device seconds a step of the ``shape.dit.moe`` spans, mean over the
    window's requests."""
    from perfbench.lib.spans import per_request
    total = per_request(ctx, "shape.denoise", ("shape.dit.moe",))
    return None if total is None else total / ctx["state"].cell.config["steps"]
