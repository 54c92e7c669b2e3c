"""Units of the port's parallel layer, in one process: the tensor-parallel
rules and state-dict sharding against the JAX package's ``_spec_for``, the
mesh's errors, the per-process seed, start-up without a launcher, the
pipeline stages' split and gather of a state dict, and pipeline
parallelism's errors against the JAX package's messages."""

import socket

import jax
import numpy as np
import pytest
import torch

from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.parallel.tp import tp_param_specs
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.inference.pipeline import MotionPipeline
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.models.transformer import SelfAttention
from motion324_tpu_torch.parallel import distributed
from motion324_tpu_torch.parallel.mesh import (Group, Mesh, local_batch_size,
                                               make_mesh)
from motion324_tpu_torch.parallel.tp import (gather_state_dict,
                                             shard_state_dict, tp_rule)
from motion324_tpu_torch.training.train_step import check_parallel
from motion324_tpu_torch.utils.convert import params_from_jax
from test_torch_parallel_train import TP_SMALL
from test_torch_train_step import YAML, _batch

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "MOTION324_PROCESS_ID",
                "MOTION324_NUM_PROCESSES", "MOTION324_COORDINATOR",
                "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                "JAX_COORDINATOR_ADDRESS")


@pytest.fixture(scope="module")
def whole():
    return MotionLatentModel(ModelConfig(**TP_SMALL), seed=0).state_dict()


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)


def test_rules_match_the_jax_spec_on_every_leaf():
    """Each weight's split (through the name map: flax kernels are
    ``(in, out)``, torch weights ``(out, in)``) is the one JAX's
    ``_spec_for`` gives its kernel: ``mp`` on the output axis for column
    layers, on the input axis for row layers, nothing elsewhere."""
    model = JaxModel(JaxConfig(**TP_SMALL))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), _batch(0))
    code = {None: 0, "col": 1, "row": 2}

    def mark(spec, leaf):
        axes = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
        if len(leaf.shape) >= 2 and axes[-1] == "mp":
            c = code["col"]
        elif len(leaf.shape) >= 2 and axes[-2] == "mp":
            c = code["row"]
        else:
            c = code[None]
        return np.full(leaf.shape, c, np.float32)
    want = params_from_jax(jax.tree.map(mark, tp_param_specs(params), params,
                                        is_leaf=lambda x: isinstance(
                                            x, jax.sharding.PartitionSpec)))
    assert len(want) > 30
    for key, m in want.items():
        if m.dim() < 2:        # flax keeps biases and norms whole
            continue
        rule = {"qkv": "col"}.get(tp_rule(key), tp_rule(key))
        assert code[rule] == m.flatten()[0], key


def test_fused_qkv_is_split_by_head_inside_q_k_and_v(whole):
    dim, hd = TP_SMALL["feat_dim"], TP_SMALL["head_dim"]
    heads = dim // hd
    for key in [k for k in whole if tp_rule(k) == "qkv"]:
        q, k, v = whole[key].split(whole[key].shape[0] // 3)
        per = q.shape[0] // heads                  # rows per head
        for r in range(2):
            mine = shard_state_dict({key: whole[key]}, r, 2)[key]
            heads_r = slice(r * heads // 2 * per, (r + 1) * heads // 2 * per)
            want = torch.cat([q[heads_r], k[heads_r], v[heads_r]])
            assert torch.equal(mine, want), (key, r)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_shard_gather_round_trip(whole, mp):
    shards = [shard_state_dict(whole, r, mp) for r in range(mp)]
    back = gather_state_dict(shards)
    assert set(back) == set(whole)
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    # each shard has the shapes of a model built for that rank
    for r, shard in enumerate(shards):
        model = MotionLatentModel(ModelConfig(**TP_SMALL), seed=None,
                                  tp=Group(None, r, mp))
        model.load_state_dict(shard)


def test_seeded_tp_model_is_the_shard_of_the_seeded_whole(whole):
    got = MotionLatentModel(ModelConfig(**TP_SMALL), seed=0,
                            tp=Group(None, 1, 2)).state_dict()
    want = shard_state_dict(whole, 1, 2)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_heads_must_divide_by_mp():
    with pytest.raises(ValueError, match="3 heads not divisible by mp=2"):
        SelfAttention(36, 12, tp=Group(None, 0, 2))
    with pytest.raises(ValueError, match="not divisible by mp=2"):
        shard_state_dict({"a.to_q.weight": torch.zeros(3, 4)}, 0, 2)


def test_make_mesh_errors_and_the_one_process_mesh(no_launcher):
    with pytest.raises(ValueError, match=r"1 devices not divisible by mp=2"):
        make_mesh(mp=2)
    with pytest.raises(ValueError, match=r"dp\*mp = 2\*1 != 1 devices"):
        make_mesh(dp=2, mp=1)
    mesh = make_mesh()
    assert mesh == Mesh(Group(), Group()) and mesh.shape == {"dp": 1, "mp": 1}
    assert local_batch_size(4, mesh) == 4
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        local_batch_size(3, Mesh(Group(None, 0, 2), Group()))


def test_process_seed(no_launcher):
    assert distributed.process_seed(5) == 5
    assert distributed.process_seed(5, 3) == 8


def test_init_distributed_without_a_launcher_makes_no_group(no_launcher):
    assert distributed.init_distributed(device="cpu") == (0, 1)
    assert not distributed.is_initialized()


def test_init_distributed_from_the_launcher_env(no_launcher, monkeypatch):
    """The MOTION324_* names (the JAX module's) start a one-process gloo
    group on the CPU; torchrun's names are read first."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MOTION324_PROCESS_ID", "0")
    monkeypatch.setenv("MOTION324_NUM_PROCESSES", "1")
    monkeypatch.setenv("MOTION324_COORDINATOR", f"localhost:{port}")
    try:
        assert distributed.init_distributed(device="cpu") == (0, 1)
        assert distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.init_distributed(device="cpu") == (0, 1)
        mesh = make_mesh()
        assert mesh.shape == {"dp": 1, "mp": 1}
        assert mesh.dp.group is torch.distributed.group.WORLD
    finally:
        distributed.destroy()
    assert not distributed.is_initialized()


@pytest.mark.parametrize("over,error,match", [
    (["training.parallel_mode=gspmd", "mesh.mp=2"], None, None),
    (["training.parallel_mode=gspmd", "mesh.dp=2", "mesh.mp=2"], ValueError,
     "world size of 4"),
    (["mesh.mp=2"], ValueError, "'shard_map' is data parallel only"),
    (["training.parallel_mode=pp", "mesh.mp=2", "training.grad_accum_steps=1"],
     None, None),
    (["training.parallel_mode=fsdp"], ValueError, "not one of")])
def test_check_parallel_at_a_world_of_two(over, error, match):
    cfg = load_train_config(YAML, over)
    if error is None:
        check_parallel(cfg, world=2)
    else:
        with pytest.raises(error, match=match):
            check_parallel(cfg, world=2)


def test_pipeline_modes(no_launcher):
    cfg = ModelConfig(**dict(TP_SMALL, frames=3))
    with pytest.raises(ValueError, match="parallel must be"):
        MotionPipeline(cfg, device="cpu", parallel="dp")
    with pytest.raises(ValueError, match=r"window \(3\) divisible by the mp "
                                         r"axis \(2\)"):
        MotionPipeline(cfg, window=3, device="cpu", parallel="sp",
                       mesh=Mesh(Group(), Group(None, 0, 2)))
    # one process: "tp", "sp" and "pp" run the whole model (mp=1)
    r = np.random.RandomState(0)
    inputs = {k: r.rand(1, 8, 3).astype(np.float32) for k in (
        "ref_shape_pcd", "ref_shape_normals", "ref_shape_rgbs", "ref_pcd",
        "ref_normal", "ref_rgb")}
    video = r.rand(4, 28, 28, 3).astype(np.float32)
    want = MotionPipeline(cfg, window=3, device="cpu").predict(inputs, video)
    for par in ("tp", "sp", "pp"):
        got = MotionPipeline(cfg, window=3, device="cpu",
                             parallel=par).predict(inputs, video)
        np.testing.assert_array_equal(got, want)


PP_SMALL = dict(TP_SMALL, n_alternating_layers=8)   # 4 pairs


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _jax_accum_error():
    from motion324_tpu.config import load_config
    from motion324_tpu.parallel.mesh import make_mesh as jax_mesh
    from motion324_tpu.training import optimizer as jax_opt
    from motion324_tpu.training.train_step import build_train_step
    cfg = load_config(YAML, ["training.grad_accum_steps=2"])
    tx, _ = jax_opt.create_optimizer(cfg)
    build_train_step(JaxModel(JaxConfig(**TP_SMALL)), tx, cfg,
                     jax_mesh(dp=1, mp=1, devices=jax.devices()[:1]),
                     mode="pp")


def _jax_model_error(pp_size: int, micro: int, b: int):
    model = JaxModel(JaxConfig(**PP_SMALL, pp_axis="mp", pp_size=pp_size,
                               pp_microbatches=micro))
    jax.eval_shape(model.init, jax.random.PRNGKey(0), _batch(0, b=b))


def _port_model_error(pp_size: int, micro: int, b: int):
    model = MotionLatentModel(ModelConfig(**PP_SMALL), seed=0,
                              pp=Group(None, 0, pp_size), pp_microbatches=micro)
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in _batch(0, b=b).items()})


@pytest.mark.parametrize("case", ["grad_accum_steps", "pairs_per_stage",
                                  "batch_per_microbatch"])
def test_pp_errors_match_the_jax_messages(case):
    """Pipeline parallelism's three errors, each with the JAX package's
    message: accumulation through ``grad_accum_steps`` (``_build_pp_step``),
    pairs that do not divide into ``pp_size`` stages (``setup``) and a batch
    that does not divide into ``pp_microbatches`` (``encode_video``)."""
    if case == "grad_accum_steps":
        want = _jax_error(_jax_accum_error)
        cfg = load_train_config(YAML, ["training.parallel_mode=pp",
                                       "training.grad_accum_steps=2"])
        got = _jax_error(lambda: check_parallel(cfg, world=1))
    else:
        args = (3, 1, 2) if case == "pairs_per_stage" else (2, 2, 3)
        want = _jax_error(lambda: _jax_model_error(*args))
        got = _jax_error(lambda: _port_model_error(*args))
    assert got == want


def test_pp_stages_split_and_gather_back(whole):
    """A whole state dict splits by key into the stages' pairs, renumbered
    from 0, and the whole model's names come back in its order."""
    from motion324_tpu_torch.parallel.pp import (is_stack_path,
                                                 split_state_dict, whole_name,
                                                 whole_names)
    sd = MotionLatentModel(ModelConfig(**PP_SMALL), seed=0).state_dict()
    parts = [split_state_dict(sd, r, 2, 4) for r in range(2)]
    for r, part in enumerate(parts):
        assert sorted(part) == sorted(MotionLatentModel(
            ModelConfig(**PP_SMALL), seed=None, pp=Group(None, r, 2)
        ).state_dict())
        for k, v in part.items():
            assert torch.equal(v, sd[whole_name(k, r, 2)]), k
    names = list(parts[0])
    assert whole_names(names, 2, 2) == list(sd)
    assert sum(is_stack_path(k) for k in sd) == 2 * sum(
        is_stack_path(k) for k in names)
    seeded = MotionLatentModel(ModelConfig(**PP_SMALL), seed=0,
                               pp=Group(None, 1, 2)).state_dict()
    assert all(torch.equal(seeded[k], parts[1][k]) for k in seeded)
