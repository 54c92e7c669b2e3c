"""Training CLI, on one device or under torchrun on N:

    python -m motion324_tpu_torch.train --config configs/dyscene.yaml \
        [key.path=value ...] [--device cpu]
    torchrun --nproc-per-node N -m motion324_tpu_torch.train \
        [mesh.dp=D mesh.mp=M training.parallel_mode=gspmd ...]

Counterpart of the repository's ``train.py``: reads the model and the
training recipe from the YAML file (with overrides), draws batches from the
Dyscene16k dataset at ``training.dataset_path`` and trains until
``stop_steps``, resuming from the latest checkpoint in
``training.checkpoint_dir``. Runs on CUDA unless ``--device cpu`` is given
(several CPU processes join over gloo).

Under torchrun the ranks form a ``(mesh.dp, mesh.mp)`` mesh: the global
batch is ``batch_size_per_device x dp x grad_accum_steps``; each rank draws
its ``batch_size_per_device x grad_accum_steps`` share with the seed
``training.seed + its dp index``, and the ranks of one tensor-parallel
replica train on the share of its ``mp`` rank 0 (the Trainer broadcasts
it). ``training.parallel_mode=shard_map``
(the default) is data parallel; ``gspmd`` splits the model's heads over
``mp`` (tensor parallel) and the batch over ``dp``; ``pp`` splits the
alternating stack's pairs into ``mp`` pipeline stages (GPipe over
``training.pp_microbatches``, ``grad_accum_steps=1``) and the batch over
``dp``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/dyscene.yaml")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args(argv)

    from motion324_tpu_torch.config import load_model_config, load_train_config
    from motion324_tpu_torch.data.dyscene import DysceneDataset, PrefetchLoader
    from motion324_tpu_torch.parallel.distributed import (destroy,
                                                          init_distributed,
                                                          local_device,
                                                          process_seed)
    from motion324_tpu_torch.parallel.mesh import make_mesh
    from motion324_tpu_torch.training.train_step import check_parallel
    from motion324_tpu_torch.training.trainer import Trainer
    from motion324_tpu_torch.utils.logging import log

    tcfg = load_train_config(args.config, args.overrides)
    mcfg = load_model_config(args.config, args.overrides)
    device = local_device(args.device)
    rank, world = init_distributed(device=device)
    try:
        check_parallel(tcfg, world)
        mesh = make_mesh(tcfg.mesh_dp, tcfg.mesh_mp)
        local = tcfg.batch_size_per_device * tcfg.grad_accum_steps
        seed = process_seed(tcfg.seed, mesh.dp.rank)
        log(f"rank {rank}/{world} on {device}, mesh {mesh.shape}, "
            f"{tcfg.parallel_mode}; global batch {local * mesh.dp.size} = "
            f"{tcfg.grad_accum_steps} x {tcfg.batch_size_per_device} x "
            f"dp {mesh.dp.size}; data seed {seed}; steps {tcfg.last_step}")
        loader = PrefetchLoader(DysceneDataset(tcfg, seed=seed),
                                batch_size=local, num_workers=tcfg.num_workers,
                                prefetch=tcfg.prefetch_factor, seed=seed)
        Trainer(tcfg, mcfg, loader, device=device, mesh=mesh).train()
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
