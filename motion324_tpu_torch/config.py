"""Model configuration: the single-device fields of the motion model.

Defaults are the release model of ``configs/dyscene.yaml`` (``model:`` and
``training.frames``). :func:`load_model_config` reads such a YAML file; it
imports ``yaml`` only when called, so the rest of the package runs where
PyYAML is absent.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "load_model_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyper-parameters of :class:`MotionLatentModel`."""

    feat_dim: int = 768
    tokens: int = 64
    pcd_layers: int = 4
    n_alternating_layers: int = 16   # 8 global + 8 local
    head_dim: int = 64
    use_qk_norm: bool = True
    drop_rate: float = 0.1           # pos-embed dropout (training only)
    image_size: int = 224
    patch_size: int = 14
    frames: int = 12                 # trained window; pos-embed native T
    decode_frames_chunk: int = 1     # frames folded into one decoder batch
    point_hidden: int = 48           # point Fourier basis width
    dino_depth: int = 12
    dino_heads: int = 12
    dtype: torch.dtype = torch.float32
    attn_backend: str | None = None  # None (route by device) or "plain"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def frame_tokens(self) -> int:
        """Tokens per frame: ``[4 special | tokens mesh | grid^2 image]``."""
        return 4 + self.tokens + self.grid * self.grid


def load_model_config(path: str) -> ModelConfig:
    """Read ``model:`` (with its dtype) and ``training.frames`` from a YAML
    config file."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    m = cfg.get("model", {})
    t = cfg.get("training", {})
    dt = m.get("dtype", "float32")
    if dt not in _DTYPES:
        raise ValueError(f"{path}: model.dtype {dt!r} is not one of "
                         f"{sorted(_DTYPES)}")
    return ModelConfig(
        feat_dim=m["feat_dim"], tokens=m["tokens"], pcd_layers=m["pcd_layers"],
        n_alternating_layers=m["n_alternating_layers"],
        head_dim=m["head_dim"], use_qk_norm=m["use_qk_norm"],
        drop_rate=m.get("drop_rate", 0.1),
        image_size=m.get("image_size", 224),
        patch_size=m.get("patch_size", 14),
        dino_depth=int(m.get("dino_depth", 12)),
        dino_heads=int(m.get("dino_heads", 12)),
        frames=int(t.get("frames", 12)),
        decode_frames_chunk=int(t.get("decode_frames_chunk", 1)),
        dtype=_DTYPES[dt])
