"""Hunyuan3D-2.1's shape model on the port, against the plain reference of
``perfbench/reference/hunyuan21.py`` (plain PyTorch, float32, a loop over
the experts), on seeded random weights at small widths on the CPU: the DiT,
the mixture of experts (its grouped path against the per-expert loop, an
expert that no token picks, a tie in the router), the U-ViT skip wiring,
``ShapeGenPipeline(model="2.1")``'s ``encode_cond`` and ``denoise``, the
benchmark's new cell through the harness, the work counted for its
metrics, and the CLIs' choice of the model. On the card (``-m cuda``): K1
at head dim 128 against its plain version and SDPA, the grouped GEMM's
refusal of dtypes other than bf16, and one 2.1 DiT step at the release's
widths that never synchronises with the host.

This file imports no JAX: the harness refuses to run in a process that has
loaded it, so the harness runs in a child process of its own. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_shape21.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from motion324_tpu_torch.hy3dgen.dit21 import Hunyuan3DDiT21
from motion324_tpu_torch.hy3dgen.moe import MoE, route
from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu_torch.hy3dgen.shape_pipeline import SHAPE21, ShapeGenPipeline
from motion324_tpu_torch.ops.grouped_gemm import grouped_mm, grouped_mm_reference
from motion324_tpu_torch.utils import profiling
from perfbench.lib import shape21, weights
from perfbench.reference import hunyuan21
from perfbench.reference.pipelines import load

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(image_size=28, cond_dim=48, cond_depth=1, cond_heads=3,
            cond_native_grid=2, cond_mlp_type="mlp", dit_hidden=48,
            dit_heads=3, dit_depth=5, dit_moe_layers=2, dit_experts=4,
            latent_dim=8, num_latents=16, vae_width=48,
            vae_heads=3, vae_layers=1, steps=3, guidance=5.0,
            dtype="float32")


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def drawn(seed: int = 3, cfg=TINY) -> dict:
    makers = hunyuan21.model_makers(cfg)
    return {n: weights.draw(makers[n], seed + k, "cpu", torch.float32)
            for k, n in enumerate(("conditioner", "dit", "vae"))}


def port_dit(sd, cfg=TINY) -> Hunyuan3DDiT21:
    dit = Hunyuan3DDiT21(
        in_channels=cfg["latent_dim"], context_dim=cfg["cond_dim"],
        hidden_size=cfg["dit_hidden"], num_heads=cfg["dit_heads"],
        depth=cfg["dit_depth"], num_moe_layers=cfg["dit_moe_layers"],
        num_experts=cfg["dit_experts"])
    dit.load_state_dict(sd)
    return dit.eval()


def test_dit_matches_the_reference():
    """The whole DiT (time token, skips, attention, MLPs and experts, final
    layer) in f32 against the reference on the same weights."""
    sd = drawn()["dit"]
    ref = load(hunyuan21.model_makers(TINY)["dit"], sd, "cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 8, generator=gen)
    t = torch.tensor([0.3, 0.3])
    cond = torch.randn(2, 5, 48, generator=gen)
    with torch.no_grad():
        got, want = port_dit(sd)(x, t, cond), ref(x, t, cond)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) < 1e-5


def _moe_pair(seed: int, dim=32, hidden=64, experts=4):
    port = MoE(dim, hidden, experts)
    sd = weights.draw(lambda: hunyuan21.MoE(dim, hidden, experts), seed,
                      "cpu", torch.float32)
    port.load_state_dict(sd)
    ref = load(lambda: hunyuan21.MoE(dim, hidden, experts), sd, "cpu")
    return port, ref


def test_moe_matches_the_per_expert_loop():
    port, ref = _moe_pair(5)
    x = torch.randn(3, 7, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert rel(port(x), ref(x)) < 1e-6


def test_moe_with_an_idle_expert_and_a_tie():
    """Experts 0 > 2 = 3 > 1 for every token: the tie goes to expert 2, so
    experts 1 and 3 get no row, and the grouped path still matches the
    per-expert loop."""
    port, ref = _moe_pair(6)
    u = torch.nn.functional.normalize(torch.randn(32), dim=0)
    gate = torch.stack([2 * u, -u, u, u])
    with torch.no_grad():
        port.gate.weight.copy_(gate)
        ref.gate.weight.copy_(gate)
    x = torch.randn(20, 32, generator=torch.Generator().manual_seed(2))
    x = x - (x @ u)[:, None] * u + 3.0 * u          # x . u = 3 for every token
    experts, w = route(torch.nn.functional.linear(x, gate), 2)
    assert experts.tolist() == [[0, 2]] * 20
    assert torch.equal(w[:, 0] > w[:, 1], torch.ones(20, dtype=torch.bool))
    with torch.no_grad():
        assert rel(port(x), ref(x)) < 1e-6


def test_grouped_gemm_takes_the_expert_banks_as_they_lie():
    """The grouped GEMM on (G, K, M) transposed views of (G, M, K) banks,
    with an empty group: PyTorch's grouped kernel (the CUDA path's call,
    here on the CPU) and the plain version give the per-group products."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(10, 16, generator=gen).bfloat16()
    w = torch.randn(3, 24, 16, generator=gen).bfloat16().transpose(1, 2)
    ends = torch.tensor([4, 4, 10], dtype=torch.int32)
    want = torch.cat([x[:4].float() @ w[0].float(), x[4:].float() @ w[2].float()])
    plain = grouped_mm(x, w, ends)               # CPU: the plain version
    assert rel(plain, want) < 1e-2
    assert torch.equal(plain, grouped_mm_reference(x, w, ends))
    if hasattr(torch, "_grouped_mm"):
        assert rel(torch._grouped_mm(x, w, offs=ends), want) < 1e-2


def test_skips_are_a_last_in_first_out_stack():
    """Block 10 of 21 takes no skip; blocks 11..20 take blocks 9..0's
    outputs, in that order; the MoE sits in blocks 15..20."""
    dit = Hunyuan3DDiT21(in_channels=4, context_dim=8, hidden_size=16,
                         num_heads=2, depth=21, num_moe_layers=6, num_experts=2)
    for p in dit.parameters():
        torch.nn.init.normal_(p, std=0.2)
    outs, skips = {}, {}
    for i, blk in enumerate(dit.blocks):
        def hook(mod, args, out, i=i):
            outs[i], skips[i] = out, args[2]
        blk.register_forward_hook(hook)
    with torch.no_grad():
        dit(torch.randn(1, 3, 4), torch.tensor([0.5]), torch.randn(1, 2, 8))
    assert all(skips[i] is None for i in range(11))
    for i in range(11, 21):
        assert skips[i] is outs[20 - i]
    assert [i for i, b in enumerate(dit.blocks) if hasattr(b, "moe")] == \
        list(range(15, 21))
    assert [i for i, b in enumerate(dit.blocks) if b.skip_linear is not None] == \
        list(range(11, 21))


def test_pipeline_encode_cond_and_denoise_match_the_reference():
    sds = drawn(7)
    c = TINY
    pipe = ShapeGenPipeline(
        sds, model="2.1", num_latents=c["num_latents"], latent_dim=c["latent_dim"],
        cond_dim=c["cond_dim"], cond_depth=c["cond_depth"], cond_heads=c["cond_heads"],
        cond_native_grid=c["cond_native_grid"], dit_hidden=c["dit_hidden"],
        dit_heads=c["dit_heads"], dit_depth=c["dit_depth"],
        dit_moe_layers=c["dit_moe_layers"], dit_experts=c["dit_experts"],
        vae_width=c["vae_width"], vae_heads=c["vae_heads"],
        vae_layers=c["vae_layers"], image_size=c["image_size"],
        dtype=torch.float32, device="cpu")
    ref = hunyuan21.Shape21Reference(c, sds, "cpu")
    gen = torch.Generator().manual_seed(8)
    image = torch.rand(28, 28, 3, generator=gen).numpy()
    noise = torch.randn(1, 16, 8, generator=gen)
    want = ref.stages(image, noise)
    cond = pipe.encode_cond(pipe.prepare_image(image))
    assert cond.shape == (1, 5, 48)              # [CLS | 2 x 2 patches]
    assert rel(cond, want["cond"]) < 1e-5
    latents = pipe.denoise(noise, torch.cat([cond, torch.zeros_like(cond)]),
                           flow_match_sigmas(c["steps"]), c["guidance"])
    assert rel(latents, want["latents"]) < 1e-5
    assert rel(pipe.vae_decode(latents), want["processed"]) < 1e-5


def test_pipeline_refuses_what_2_1_does_not_take():
    with pytest.raises(ValueError, match="model must be"):
        ShapeGenPipeline(model="3.0", device="cpu")
    with pytest.raises(ValueError, match="single-view"):
        ShapeGenPipeline(model="2.1", conditioner_type="mv", device="cpu")
    assert SHAPE21["dit_hidden"] // SHAPE21["dit_heads"] == 128


def test_device_counters_add_without_reading(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.reset()
    profiling.count("rows", torch.tensor([1, 2]))
    profiling.count("rows", torch.tensor([3, 0]))
    assert profiling.counters() == {"rows": [4, 2]}
    profiling.reset()
    assert profiling.counters() == {}


def test_the_counted_work_of_a_release_request():
    """A CFG step of the release is 36.4 TFLOP (the expert FFNs, two routed
    and the shared one a token, 9.9 of it); K1's head-dim-128 calls and the
    grouped GEMMs' bytes follow from the shapes."""
    cfg = json.loads((ROOT / "perfbench/configs/hunyuan3d21-shape.json").read_text())
    work = shape21.request_flops(cfg)
    step = work["denoise"] / cfg["steps"]
    assert 36.0e12 < step < 36.8e12
    moe_flops, moe_bytes = shape21.moe_work(cfg)
    assert 9.8e12 < moe_flops / cfg["steps"] < 10.0e12
    # every expert's weights once a layer a step: 9 x 2 x 2048 x 8192 bf16
    assert moe_bytes > 6 * 50 * 9 * 2 * 2048 * 8192 * 2
    assert shape21.k1_d128_calls(cfg) == [(1050, 2, 16, 4097, 4097, 128),
                                          (1050, 2, 16, 4097, 1370, 128)]
    assert work["conditioner"] + work["vae_decode"] < 0.01 * work["denoise"]


CHILD = """
import json, sys
from perfbench.lib import bench
cells = json.loads(sys.argv[1])
out = {name: bench.run_cell(name, 2 ** 31 + 41, 0.0, True, 0.0, device="cpu",
                            **kw) for name, kw in cells.items()}
print(json.dumps(out))
"""


def test_the_new_cell_runs_through_the_harness():
    """``shape21-latents50`` at tiny widths on the CPU, traced: ``correct``,
    the MoE span read per step, the end-to-end metric its entry names, and
    the compared numbers its limits name."""
    from perfbench.lib import bench
    assert bench.end_to_end_of("shape21-latents50") == "shape_latents_s"
    assert set(bench.metrics_for("shape21-latents50")) == {
        "moe_s.shape21", "moe_roofline.shape21", "attn_roofline.shape21",
        "mfu.shape21"}
    cells = {"shape21-latents50": dict(config_override=TINY)}
    env = {**os.environ, "MOTION324_DEBUG": "1", "PYTHONPATH": str(ROOT)}
    env.pop("MOTION324_TRACE_DIR", None)
    done = subprocess.run([sys.executable, "-c", CHILD, json.dumps(cells)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    shape = json.loads(done.stdout.strip().splitlines()[-1])["shape21-latents50"]
    assert shape["correct"]
    # the MoE's span, a step: the CPU run has no device trace to read
    assert set(shape["metrics"]) == {"moe_s.shape21", "mfu.shape21"}
    assert shape["metrics"]["moe_s.shape21"]["value"] > 0
    assert set(shape["compared"]) == {"cond_rel_gap", "latents_rel_gap",
                                      "processed_rel_gap"}
    assert "not compared step1_rel_gap" in done.stderr


# ---------------------------------------------------------------- card ---- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk", [(2, 4097, 4097), (2, 4097, 1370),
                                     (1, 1000, 1296), (2, 64, 4096)],
                         ids=["dit_self", "dit_cross", "ragged", "split"])
def test_cuda_k1_head_dim_128(cuda, b, sq, sk):
    """K1 at head dim 128 on the dispatcher's (B, S, H, 128) views, against
    its plain version within 2^-6 of max|plain| (the other K1 rows' bound)
    and SDPA within 2^-5; one launch of the d128 kernel."""
    import torch.nn.functional as F

    from motion324_tpu_torch.ops.attention import multi_head_attention
    from motion324_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q, k, v = (torch.randn(b, n, 16, 128, generator=gen, device=cuda)
               .bfloat16() for n in (sq, sk, sk))
    before = flash_attention.launches
    out = multi_head_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)))
    top = want.float().abs().max().item()
    err = (out.transpose(1, 2).float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * top
    lib = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    assert (out.transpose(1, 2).float() - lib.float()).abs().max().item() \
        <= 2.0 ** -5 * top


@pytest.mark.cuda
def test_cuda_k1_head_dim_128_refuses_what_it_lacks(cuda):
    from motion324_tpu_torch.ops.flash_attention import flash_attention
    q = torch.randn(1, 2, 300, 128, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)                 # f32
    qb = q.bfloat16().requires_grad_()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(qb, qb, qb)              # the LSE and backward


@pytest.mark.cuda
def test_cuda_grouped_gemm_refuses_other_dtypes(cuda):
    """On the card the grouped GEMM takes bf16 alone: an f32 or mixed call
    raises rather than fall back to the plain version, which would read the
    group ends on the host inside a DiT step."""
    x = torch.randn(10, 16, device=cuda)
    w = torch.randn(3, 16, 24, device=cuda)
    ends = torch.tensor([4, 4, 10], dtype=torch.int32, device=cuda)
    before = grouped_mm.launches
    with pytest.raises(TypeError, match="bfloat16"):
        grouped_mm(x, w, ends)                   # f32
    with pytest.raises(TypeError, match="bfloat16"):
        grouped_mm(x.bfloat16(), w, ends)        # mixed
    assert grouped_mm.launches == before


@pytest.mark.cuda
def test_cuda_dit21_step_never_waits_for_the_host(cuda):
    """One CFG step of the 2.1 DiT at the release's widths (bf16, random
    weights) runs under ``set_sync_debug_mode("error")``: nothing in it
    synchronises; its attention runs on K1 (42 launches) and its experts on
    the grouped GEMM (2 a MoE block)."""
    from motion324_tpu_torch.ops.flash_attention import flash_attention
    dims = {k: v for k, v in SHAPE21.items()}
    pipe = ShapeGenPipeline.init_random(
        torch.Generator(cuda).manual_seed(0), device=cuda, **dims)
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(1, 4096, 64, generator=gen, device=cuda)
    cond = torch.randn(1, 1370, 1024, generator=gen, device=cuda).bfloat16()
    pair = torch.cat([cond, torch.zeros_like(cond)])
    sig = flow_match_sigmas(2)
    pipe.denoise(x, pair, sig, 5.0)              # warm-up: builds the kernels
    torch.cuda.synchronize()
    k1, gm = flash_attention.launches, grouped_mm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe.denoise(x, pair, sig[1:], 5.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out).all()
    assert flash_attention.launches - k1 == 42
    assert grouped_mm.launches - gm == 12


def test_the_clis_name_the_2_1_model(monkeypatch, tmp_path):
    """``generate_assets --model 2.1`` builds its random-weight pipeline at
    the 2.1 release's widths (refusing ``--mv``), and ``golden_eval
    --shape-model 2.1`` the 2.1 DiT at the smoke's tiny widths."""
    import argparse

    from motion324_tpu_torch import generate_assets, golden_eval
    from motion324_tpu_torch.hy3dgen import shape_pipeline
    seen = {}

    def fake(cls, generator=None, **kw):
        seen.update(kw)
        raise RuntimeError("stop")
    monkeypatch.setattr(shape_pipeline.ShapeGenPipeline, "init_random",
                        classmethod(fake))
    monkeypatch.setattr(generate_assets, "scan_jobs",
                        lambda root, skip: [(("img.npy",), 1)])
    with pytest.raises(RuntimeError, match="stop"):
        generate_assets.main(["--input-root", str(tmp_path), "--model", "2.1",
                              "--device", "cpu"])
    assert seen["model"] == "2.1" and seen["dit_hidden"] == 2048
    with pytest.raises(SystemExit):
        generate_assets.main(["--input-root", str(tmp_path), "--model", "2.1",
                              "--mv", "--device", "cpu"])
    monkeypatch.undo()
    args = argparse.Namespace(hy3d_ckpt=None, device="cpu", seed=0,
                              shape_model="2.1")
    pipe = golden_eval._shape(args, smoke=True)
    assert isinstance(pipe.dit, Hunyuan3DDiT21) and pipe.dit.depth == 5
