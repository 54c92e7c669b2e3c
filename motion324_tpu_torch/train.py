"""Training CLI on one device:

    python -m motion324_tpu_torch.train --config configs/dyscene.yaml \
        [key.path=value ...] [--device cpu]

Counterpart of the repository's ``train.py``: reads the model and the
training recipe from the YAML file (with overrides), draws batches of
``grad_accum_steps * batch_size_per_device`` samples from the Dyscene16k
dataset at ``training.dataset_path`` and trains until ``stop_steps``,
resuming from the latest checkpoint in ``training.checkpoint_dir``. Runs on
CUDA unless ``--device cpu`` is given.
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

    from motion324_tpu_torch import resolve_device
    from motion324_tpu_torch.config import load_model_config, load_train_config
    from motion324_tpu_torch.data.dyscene import DysceneDataset, PrefetchLoader
    from motion324_tpu_torch.training.train_step import check_single_device
    from motion324_tpu_torch.training.trainer import Trainer
    from motion324_tpu_torch.utils.logging import log

    tcfg = load_train_config(args.config, args.overrides)
    mcfg = load_model_config(args.config, args.overrides)
    device = resolve_device(args.device)
    check_single_device(tcfg)
    batch = tcfg.batch_size_per_device * tcfg.grad_accum_steps
    log(f"device {device}, batch {batch} = {tcfg.grad_accum_steps} x "
        f"{tcfg.batch_size_per_device}, steps {tcfg.last_step}")
    loader = PrefetchLoader(DysceneDataset(tcfg, seed=tcfg.seed), batch_size=batch,
                            num_workers=tcfg.num_workers,
                            prefetch=tcfg.prefetch_factor, seed=tcfg.seed)
    Trainer(tcfg, mcfg, loader, device=device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
