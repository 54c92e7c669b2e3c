"""Image -> mesh shape generation: DINOv2 condition, flow-matching DiT,
ShapeVAE, volume decode and marching cubes.

The stages, each a method with the JAX package's inputs and outputs:

1. :meth:`ShapeGenPipeline.encode_cond`: a frozen DINOv2 ViT over the
   518^2 image (the multiview variant over up to 4 views); the
   unconditional embedding is zeros;
2. :meth:`~ShapeGenPipeline.denoise`: the 50-step classifier-free-guidance
   Euler loop of flow matching (guidance 5.0), a Python loop over the steps
   with the conditional and unconditional inputs in one batch of 2;
3. :meth:`~ShapeGenPipeline.vae_decode`: the ShapeVAE lifts the latents;
4. the volume decode (:mod:`motion324_tpu_torch.hy3dgen.volume`) scores an
   (R+1)^3 grid in chunks of 8 192 points through
   :meth:`~ShapeGenPipeline.vae_query`, coarse then fine near the surface;
5. marching cubes (:mod:`motion324_tpu_torch.native`) on the host, at the
   grid's box.

``model`` picks the DiT: ``"2.0"``, Hunyuan3D-2's Flux-style DiT
(:class:`~motion324_tpu_torch.hy3dgen.dit.Hunyuan3DDiT`) over the
conditioner's patch tokens; ``"2.1"``, Hunyuan3D-2.1's DiT with U-ViT skips
and a mixture of experts
(:class:`~motion324_tpu_torch.hy3dgen.dit21.Hunyuan3DDiT21`) over the
conditioner's ``[CLS | patch]`` tokens. :data:`SHAPE21` holds the 2.1
release's widths (DINOv2-large, 4 096 latents); its released weights are
not loaded yet (random weights only).

Everything up to the grid runs on the pipeline's device (CUDA unless the
caller passes ``device="cpu"``) in ``dtype``; attention takes K1 (the
conditioner and the DiT; the 2.1 DiT's heads of 128 its own instantiation),
K2 (the VAE's self-attention) and K6 (the volume query). The latent noise
comes from a ``torch.Generator`` seeded with ``seed``, so its numbers differ
from the JAX package's ``PRNGKey`` noise; the stages take the same inputs as
the JAX package's and give the same outputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.conditioner import DinoConditionerMV
from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT
from motion324_tpu_torch.hy3dgen.dit21 import Hunyuan3DDiT21
from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu_torch.hy3dgen.vae import ShapeVAE
from motion324_tpu_torch.hy3dgen.volume import (decode_volume,
                                                decode_volume_flashvdm,
                                                decode_volume_hierarchical)
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.models.dinov2 import DinoViT
from motion324_tpu_torch.models.motion_model import init_weights
from motion324_tpu_torch.utils.profiling import span

__all__ = ["ShapeGenPipeline", "SHAPE21", "SHAPE_MODELS"]

SHAPE_MODELS = ("2.0", "2.1")

# Hunyuan3D-2.1's release (hunyuan3d-dit-v2-1): DINOv2-large at 518^2, the
# 21-block DiT at 2 048 (16 heads of 128, the last 6 blocks 8 experts,
# top-2, and a shared expert), the ShapeVAE decoder over 4 096 latents
SHAPE21 = dict(model="2.1", image_size=518, cond_dim=1024, cond_depth=24,
               cond_heads=16, cond_mlp_type="mlp", cond_native_grid=37,
               dit_hidden=2048, dit_heads=16, dit_depth=21, dit_moe_layers=6,
               dit_experts=8, num_latents=4096, latent_dim=64,
               vae_width=1024, vae_heads=16, vae_layers=16)


class ShapeGenPipeline:
    """The three models on one device; ``pipe(image)`` -> :class:`TriMesh`.

    ``state_dicts``: ``{'dit', 'vae', 'conditioner'}`` in the port's names
    (see :mod:`motion324_tpu_torch.utils.convert`); without them the weights
    are random, drawn from ``generator`` (default: seed 0 on the device) on
    the device. ``model`` ``"2.0"`` or ``"2.1"`` picks the DiT (the module
    docstring; ``dit_single`` is the 2.0 DiT's, ``dit_moe_layers`` and
    ``dit_experts`` the 2.1 DiT's). After each call
    ``last_run`` holds the seconds of each stage and the number of
    volume-query chunks.
    """

    def __init__(self, state_dicts: dict | None = None, *,
                 num_latents: int = 512, latent_dim: int = 64,
                 cond_dim: int = 1536, cond_depth: int = 24,
                 cond_heads: int = 24, dit_hidden: int = 1024,
                 dit_heads: int = 16, dit_depth: int = 16,
                 dit_single: int = 32, vae_width: int = 1024,
                 vae_heads: int = 16, vae_layers: int = 16,
                 image_size: int = 518, dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str | None = None,
                 conditioner_type: str = "single", view_num: int = 4,
                 cond_mlp_type: str = "mlp", cond_native_grid: int = 37,
                 model: str = "2.0", dit_moe_layers: int = 6,
                 dit_experts: int = 8,
                 device=None, generator: torch.Generator | None = None):
        if conditioner_type not in ("single", "mv"):
            raise ValueError(f"conditioner_type must be 'single' or 'mv', "
                             f"got {conditioner_type!r}")
        if model not in SHAPE_MODELS:
            raise ValueError(f"model must be one of {SHAPE_MODELS}, got "
                             f"{model!r}")
        if model == "2.1" and conditioner_type == "mv":
            raise ValueError("the 2.1 model takes the single-view "
                             "conditioner")
        self.model = model
        self.device = resolve_device(device)
        self.dtype = dtype
        self.conditioner_type = conditioner_type
        self.num_latents, self.latent_dim = num_latents, latent_dim
        self.image_size = image_size
        # built without storage, then given it on the device in `dtype`: at
        # release width (2.4 B parameters) nothing is drawn on the host
        with torch.device("meta"):
            if model == "2.1":
                self.dit = Hunyuan3DDiT21(
                    in_channels=latent_dim, context_dim=cond_dim,
                    hidden_size=dit_hidden, num_heads=dit_heads,
                    depth=dit_depth, num_moe_layers=dit_moe_layers,
                    num_experts=dit_experts, attn_backend=attn_backend)
            else:
                self.dit = Hunyuan3DDiT(in_channels=latent_dim,
                                        context_in_dim=cond_dim,
                                        hidden_size=dit_hidden,
                                        num_heads=dit_heads, depth=dit_depth,
                                        depth_single_blocks=dit_single,
                                        attn_backend=attn_backend)
            self.vae = ShapeVAE(num_latents=num_latents, embed_dim=latent_dim,
                                width=vae_width, heads=vae_heads,
                                num_decoder_layers=vae_layers,
                                attn_backend=attn_backend)
            if conditioner_type == "mv":
                self.conditioner = DinoConditionerMV(
                    embed_dim=cond_dim, depth=cond_depth, num_heads=cond_heads,
                    native_grid=cond_native_grid, mlp_type=cond_mlp_type,
                    view_num=view_num, attn_backend=attn_backend)
            else:
                # the 2.1 DiT reads the CLS token too
                self.conditioner = DinoViT(
                    embed_dim=cond_dim, depth=cond_depth, num_heads=cond_heads,
                    native_grid=cond_native_grid, mlp_type=cond_mlp_type,
                    keep_cls=model == "2.1", attn_backend=attn_backend)
        for name in ("dit", "vae", "conditioner"):
            mod = getattr(self, name).to_empty(device=self.device).to(dtype)
            if state_dicts is None:
                if generator is None:
                    generator = torch.Generator(self.device).manual_seed(0)
                init_weights(mod, generator)
            else:
                mod.load_state_dict(state_dicts[name])
            mod.eval().requires_grad_(False)
        self.last_run: dict = {}

    # ------------------------------------------------------------------ #
    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, **kwargs):
        """Random-weight pipeline (smoke and benchmark mode)."""
        return cls(None, generator=generator, **kwargs)

    @classmethod
    def from_hunyuan_ckpt(cls, ckpt_path: str, **kwargs):
        """The pipeline from a released Hunyuan3D-2 single-file checkpoint
        (a torch pickle of ``{'model', 'vae', 'conditioner'}``). The dims are
        read from the state dicts; explicit kwargs override them."""
        from motion324_tpu_torch.utils.convert import hunyuan_ckpt_state_dicts
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sds, dims = hunyuan_ckpt_state_dicts(
            ckpt, mv=kwargs.get("conditioner_type") == "mv")
        # the checkpoint's ShapeVAE also holds its encoder: keep the keys of
        # the decoder this port runs (missing ones still fail the load)
        with torch.device("meta"):
            wanted = ShapeVAE(num_latents=kwargs.get("num_latents", 512),
                              embed_dim=dims["latent_dim"],
                              width=dims["vae_width"],
                              heads=kwargs.get("vae_heads", 16),
                              num_decoder_layers=dims["vae_layers"]
                              ).state_dict().keys()
        sds["vae"] = {k: v for k, v in sds["vae"].items() if k in wanted}
        return cls(sds, **{**dims, **kwargs})

    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare_image(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3|4) in [0, 1] -> (1, S, S, 3) on the device, in dtype."""
        x = torch.as_tensor(np.ascontiguousarray(image[..., :3], np.float32),
                            device=self.device)[None]
        s = self.image_size
        if x.shape[1:3] != (s, s):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s),
                              mode="bilinear", antialias=True,
                              align_corners=False).permute(0, 2, 3, 1)
        return x.to(self.dtype)

    @torch.inference_mode()
    def encode_cond(self, images, view_idxs=None) -> torch.Tensor:
        """Condition tokens ``(B, Lc, C)``: ``images`` (B, S, S, 3), or
        (B, V, S, S, 3) with ``view_idxs`` (B, V) for the multiview
        conditioner, in [0, 1]."""
        with span("shape.encode_cond"):
            images = torch.as_tensor(images, device=self.device).to(self.dtype)
            if self.conditioner_type == "mv":
                return self.conditioner(images, torch.as_tensor(
                    view_idxs, device=self.device))
            return self.conditioner(images)

    @torch.inference_mode()
    def denoise(self, latents, cond_pair, sigmas, guidance_scale: float):
        """The CFG flow-matching Euler loop: ``latents`` (1, L, C) f32,
        ``cond_pair`` (2, Lc, C) = [cond, uncond], ``sigmas`` the ladder of
        :func:`flow_match_sigmas`. Returns the f32 latents."""
        with span("shape.denoise"):
            x = torch.as_tensor(latents, dtype=torch.float32,
                                device=self.device)
            cond_pair = torch.as_tensor(cond_pair, device=self.device)
            sig = np.asarray(sigmas, np.float32)
            for i in range(len(sig) - 1):
                with span("shape.denoise.step"):
                    t = torch.full((2,), float(sig[i]), device=self.device)
                    v_cond, v_uncond = self.dit(torch.cat([x, x]), t,
                                                cond_pair).chunk(2)
                    v = v_uncond + guidance_scale * (v_cond - v_uncond)
                    x = x + float(sig[i + 1] - sig[i]) * v
            return x

    @torch.inference_mode()
    def vae_decode(self, latents) -> torch.Tensor:
        """(B, num_latents, latent_dim) -> the processed latent set."""
        with span("shape.vae_decode"):
            return self.vae.decode(torch.as_tensor(latents,
                                                   device=self.device))

    @torch.inference_mode()
    def vae_query(self, points, processed) -> torch.Tensor:
        """(B, N, 3) points -> (B, N) f32 occupancy logits."""
        return self.vae.query(torch.as_tensor(points, device=self.device),
                              processed)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def __call__(self, image, *, num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, octree_resolution: int = 384,
                 mc_level: float = 0.0, num_chunks: int = 8192,
                 hierarchical: bool = True, box_v: float = 1.01,
                 enable_flashvdm: bool = False, flashvdm_topk: int = 64,
                 recenter: bool = True, border_ratio: float = 0.15,
                 seed: int = 0) -> TriMesh:
        """image (H, W, 3|4) in [0, 1] -> the extracted TriMesh.

        With the multiview conditioner pass a dict of view tag
        (front/left/back/right) -> image. ``recenter`` runs the alpha-aware
        border-ratio recentering (needs cv2); pass False for an image that
        is already prepared.
        """
        from motion324_tpu_torch import native
        stages = {k: span(f"shape.call.{k}", timed=True) for k in (
            "conditioner", "denoise", "vae_decode", "volume_decode",
            "marching_cubes")}
        with stages["conditioner"]:
            if self.conditioner_type == "mv":
                if not isinstance(image, dict):
                    raise ValueError("the mv pipeline takes a dict of view "
                                     "tag -> image (front/left/back/right)")
                from motion324_tpu_torch.hy3dgen.preprocess_image import (
                    prepare_condition_images_mv)
                images, _, idxs = prepare_condition_images_mv(
                    image, self.image_size, border_ratio)
                cond = self.encode_cond(images[None], idxs[None])
            else:
                if recenter:
                    from motion324_tpu_torch.hy3dgen.preprocess_image import (
                        prepare_condition_image)
                    image, _ = prepare_condition_image(image, self.image_size,
                                                       border_ratio)
                cond = self.encode_cond(self.prepare_image(image))
            cond_pair = torch.cat([cond, torch.zeros_like(cond)])
            self._sync()

        with stages["denoise"]:
            gen = torch.Generator(self.device).manual_seed(seed)
            latents = torch.randn(1, self.num_latents, self.latent_dim,
                                  generator=gen, device=self.device)
            latents = self.denoise(latents, cond_pair,
                                   flow_match_sigmas(num_inference_steps),
                                   float(guidance_scale))
            self._sync()

        with stages["vae_decode"]:
            processed = self.vae_decode(latents)
            self._sync()

        with stages["volume_decode"]:
            kw = dict(resolution=octree_resolution, box_v=box_v,
                      chunk=num_chunks)
            if enable_flashvdm:
                grid, chunks = decode_volume_flashvdm(self.vae, processed,
                                                      topk=flashvdm_topk, **kw)
            else:
                decode = (decode_volume_hierarchical if hierarchical
                          else decode_volume)
                grid, chunks = decode(self.vae.query, processed, **kw)

        with stages["marching_cubes"]:
            verts, faces = native.marching_cubes(
                grid, iso=mc_level,
                bounds=((-box_v, -box_v, -box_v), (box_v, box_v, box_v)))
        self.last_run = {"seconds": {k: s.seconds for k, s in stages.items()},
                         "query_chunks": chunks}
        return TriMesh(vertices=verts, faces=faces.astype(np.int64))
