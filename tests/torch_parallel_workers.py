"""The port's side of the two-process tests (tests/test_torch_parallel_*.py).

Each test module starts two processes with :func:`start` (torch
multiprocessing, start method ``spawn``); they join one gloo group through
a ``FileStore`` under the test's temporary directory, read their job (a
``torch.save`` file of cases), run every case on the CPU and write their
results to ``rank{r}.pt``. The parent compares them with the JAX package's
sharded programs. This module imports neither JAX nor the JAX package, and
each result records that the process never loaded them.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def start(job: dict, tmp: str) -> list:
    """Start the two worker processes on ``job``; returns them (join with
    :func:`results`)."""
    os.makedirs(tmp, exist_ok=True)
    torch.save(job, os.path.join(tmp, "job.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, tmp), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def results(procs: list, tmp: str, timeout: float = 120.0) -> list[dict]:
    """Wait for the workers; their results in rank order."""
    for p in procs:
        p.join(timeout)
    out = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            raise RuntimeError(f"worker {r} did not finish in {timeout} s")
        path = os.path.join(tmp, f"rank{r}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"worker {r} exited {p.exitcode} without results")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise RuntimeError(f"worker {r} failed:\n{res['error']}")
        out.append(res)
    return out


def _main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    res: dict = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
            rank=rank, world_size=WORLD)
        job = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
        for name, case in job["cases"].items():
            res[name] = CASES[case["kind"]](rank, case)
        res["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0]
                                   in ("jax", "flax", "jaxlib", "motion324_tpu"))
        dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _train_state(case: dict, mesh):
    from motion324_tpu_torch.models.motion_model import MotionLatentModel
    from motion324_tpu_torch.parallel.pp import model_part
    from motion324_tpu_torch.training.train_step import create_train_state
    split = mesh.mp if mesh.mp.size > 1 else None
    if case["cfg"].parallel_mode == "pp":
        model = MotionLatentModel(case["model_cfg"], seed=None, pp=split,
                                  pp_microbatches=case["cfg"].pp_microbatches)
    else:
        model = MotionLatentModel(case["model_cfg"], seed=None, tp=split)
    model.load_state_dict(model_part(model, case["params"]))
    return create_train_state(model, case["cfg"], mesh)


def _whole(state) -> dict:
    """The whole model's state dict from this rank's (a collective)."""
    from motion324_tpu_torch.parallel.pp import model_whole
    return model_whole(state.model, state.model.state_dict())


def _local(micros: list, mesh) -> list[dict]:
    """This rank's share of each global micro-batch (by its dp index)."""
    out = []
    for mb in micros:
        n = len(next(iter(mb.values()))) // mesh.dp.size
        out.append(_torch({k: v[mesh.dp.rank * n:(mesh.dp.rank + 1) * n]
                           for k, v in mb.items()}))
    return out


def _replicated_bits_equal(state, mesh) -> bool:
    """Whether every replicated parameter holds the same bits on every
    rank of ``mp``."""
    from motion324_tpu_torch.parallel.pp import splits_over_mp
    same = True
    for k, v in state.model.state_dict().items():
        if splits_over_mp(state.model, k):
            continue
        parts = [torch.empty_like(v) for _ in range(mesh.mp.size)]
        dist.all_gather(parts, v.contiguous(), group=mesh.mp.group)
        same &= all(torch.equal(parts[0], p) for p in parts[1:])
    return bool(same)


def train_case(rank: int, case: dict) -> dict:
    """One step of ``train_step`` on a ``case["mesh"]`` = (dp, mp) mesh."""
    from motion324_tpu_torch.parallel.mesh import make_mesh
    from motion324_tpu_torch.training.checkpoints import save_checkpoint
    from motion324_tpu_torch.training.train_step import train_step
    mesh = make_mesh(*case["mesh"])
    state = _train_state(case, mesh)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    micros = _local(case["micros"], mesh)
    if case.get("nan_rank") == rank:
        micros[0]["rgb_video"][:] = float("nan")
    metrics = train_step(state, micros, case["cfg"])
    after = state.model.state_dict()
    out = {"metrics": metrics, "step": state.step,
           "update_step": state.update_step,
           "unchanged": all(torch.equal(before[k], v) for k, v in after.items()),
           "replicated_equal": _replicated_bits_equal(state, mesh),
           "params": _whole(state)}
    if case.get("save"):
        out["saved"] = save_checkpoint(case["save"], state)
    return out


def checkpoint_case(rank: int, case: dict) -> dict:
    """Resume the one-process checkpoint ``case["resume"]`` at mp=2, write
    it back at once (``again``), take one step and write that (``after``)."""
    from motion324_tpu_torch.parallel.mesh import make_mesh
    from motion324_tpu_torch.training.checkpoints import (auto_resume,
                                                          save_checkpoint)
    from motion324_tpu_torch.training.train_step import train_step
    mesh = make_mesh(*case["mesh"])
    state = _train_state(case, mesh)
    state, found = auto_resume(case["resume"], state)
    again = save_checkpoint(case["again"], state)
    metrics = train_step(state, _local(case["micros"], mesh), case["cfg"])
    after = save_checkpoint(case["after"], state)
    return {"resumed": found, "again": again, "after": after,
            "metrics": metrics, "params": _whole(state)}


def trainer_case(rank: int, case: dict) -> dict:
    """``Trainer.train`` for ``case["steps"]`` steps on a ``case["mesh"]``
    mesh, this rank's iterator over ``case["batches"][rank]``; with the
    position-dropout mask of each forward (the zeros of the video tokens
    entering the first layer norm)."""
    from motion324_tpu_torch.parallel.mesh import make_mesh
    from motion324_tpu_torch.training.trainer import Trainer
    mesh = make_mesh(*case["mesh"])
    trainer = Trainer(case["cfg"], case["model_cfg"], case["batches"][rank],
                      device="cpu", mesh=mesh)
    model, grid = trainer.state.model, case["model_cfg"].grid ** 2
    masks: list = []
    model.transformer_input_layernorm.register_forward_pre_hook(
        lambda mod, args: masks.append(args[0][:, :, -grid:] == 0))
    state = trainer.train(case["steps"])
    return {"masks": masks, "step": state.step,
            "replicated_equal": _replicated_bits_equal(state, mesh),
            "params": _whole(state)}


# --------------------------------------------------------------------- #
# inference
# --------------------------------------------------------------------- #
def predict_case(rank: int, case: dict) -> dict:
    """``MotionPipeline(parallel=...).predict`` of each of ``case["runs"]``
    (``(video, segment)``), and ``run`` to a per-rank directory when
    ``case["glb"]`` names one."""
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    from motion324_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=1, mp=WORLD)
    pipe = MotionPipeline(case["model_cfg"], state_dict=case["params"],
                          window=case["window"], decode_chunk=8, device="cpu",
                          parallel=case["parallel"], mesh=mesh)
    out = {"trajs": [pipe.predict(case["inputs"], video, segment)
                     for video, segment in case["runs"]]}
    if case.get("glb"):
        d = os.path.join(case["glb"], f"rank{rank}")
        pipe.run(case["mesh_path"], case["video_path"], d,
                 num_shape_samples=64)
        out["wrote"] = sorted(os.listdir(d))
    return out


def window_guard_case(rank: int, case: dict) -> dict:
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    try:
        MotionPipeline(case["model_cfg"], window=case["window"], device="cpu",
                       parallel="sp")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


CASES = {"train": train_case, "checkpoint": checkpoint_case,
         "trainer": trainer_case,
         "predict": predict_case, "window_guard": window_guard_case}
