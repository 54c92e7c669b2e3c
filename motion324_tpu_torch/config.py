"""Configuration: the motion model's single-device fields and the training
recipe.

Defaults are the release model and recipe of ``configs/dyscene.yaml``.
:func:`load_model_config` and :func:`load_train_config` read such a YAML
file with ``key.path=value`` overrides (values parsed as YAML scalars) and
``${a.b}`` references, as the JAX package's config loader does. They import
``yaml`` only when called, so the rest of the package runs where PyYAML is
absent.
"""

from __future__ import annotations

import dataclasses
import re

import torch

__all__ = ["ModelConfig", "TrainConfig", "load_model_config",
           "load_train_config", "read_config"]

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


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _get_path(cfg: dict, path: str):
    node = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _parse_value(text: str):
    """A YAML scalar; ``4e-4`` (not a YAML 1.1 float) as a float."""
    import yaml
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


def read_config(path: str, overrides=()) -> dict:
    """The YAML file at ``path`` as nested dicts, with ``key.path=value``
    overrides applied and ``${a.b}`` references resolved."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not of the form key=value")
        node = cfg
        *parents, leaf = key.strip().split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = _parse_value(raw.strip())

    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, str) and "${" in node:
            whole = _INTERP.fullmatch(node)
            if whole:
                found = _get_path(cfg, whole.group(1))
                return node if found is None else found
            return _INTERP.sub(lambda m: str(_get_path(cfg, m.group(1)) or m.group(0)),
                               node)
        return node

    for _ in range(4):  # chained references
        cfg = resolve(cfg)
    return cfg


def load_model_config(path: str, overrides=()) -> ModelConfig:
    """Read ``model:`` (with its dtype) and ``training.frames`` from a YAML
    config file."""
    cfg = read_config(path, overrides)
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The ``training:`` (and ``mesh:``) keys that the port's training path
    reads; defaults as in the JAX package where the YAML file may omit a
    key."""

    batch_size_per_device: int = 2
    frames: int = 12
    num_shape_samples: int = 4096
    num_pcd_samples: int = 4096
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.05
    warmup: int = 1000
    train_steps: int = 30000
    stop_steps: int | None = None    # None: train_steps
    grad_accum_steps: int = 1
    grad_accum_dtype: str = "float32"
    bf16_grad_allreduce: bool = False
    grad_clip_norm: float = 1.0
    allowed_gradnorm_factor: float = 5.0
    coord_mse_loss_weight: float = 1.0
    remat: bool = False
    remat_policy: str | None = None  # a TPU memory schedule; accepted, not applied
    seed: int = 0
    checkpoint_every: int = 10000
    print_every: int = 20
    log_every: int = 1
    checkpoint_dir: str = "./experiments/checkpoints/test"
    dataset_path: str = ""
    train_lst: str | None = None
    dataset_begin: int = 0
    dataset_end: int = -1
    replica: int = 1
    num_workers: int = 8
    prefetch_factor: int = 2
    parallel_mode: str = "shard_map"
    mesh_dp: int = -1
    mesh_mp: int = 1

    @property
    def last_step(self) -> int:
        return self.train_steps if self.stop_steps is None else self.stop_steps


def load_train_config(path: str, overrides=()) -> TrainConfig:
    """Read the training recipe from a YAML config file."""
    cfg = read_config(path, overrides)
    t = dict(cfg.get("training", {}))
    mesh = cfg.get("mesh", {})
    names = {f.name: f for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in t.items() if k in names}
    kw["mesh_dp"] = int(mesh.get("dp", -1))
    kw["mesh_mp"] = int(mesh.get("mp", 1))
    for k, v in kw.items():   # YAML may give 1 for 1.0 or "4e-4" for 4e-4
        default = names[k].default
        if v is not None and isinstance(default, (int, float)) \
                and not isinstance(default, bool):
            kw[k] = type(default)(v)
    return TrainConfig(**kw)
