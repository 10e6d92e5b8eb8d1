"""Training entry point:

    python -m encodec_tpu_torch.train --config C.yaml [--log_dir D]
        [--resume_from RUN_DIR] [--max_epochs N] [--device cuda|cpu]

Port of `encodec_tpu/train/__main__.py` (`build_dataloaders`, `main`),
over the port's `data/` loader. Loads and snapshots the config (YAML, or
JSON by the `.json` suffix, which needs no PyYAML), builds the breathing
datasets and the model, and runs the epoch loop with checkpoint and resume
on one device (default the GPU).
"""

from __future__ import annotations

import argparse
import os
import typing as tp
from datetime import datetime


def build_dataloaders(config):
    """(train loader, val loader, {dataset id: name}) of `config.dataset`."""
    import numpy as np

    from ..data import BreathingDataset, DataLoader, MergedDataset

    root = config.dataset.root
    if root is None:
        raise SystemExit("dataset.root must point at the npz data directory")
    channels = {}
    if getattr(config.dataset, "thorax", 0) > 0:
        channels["thorax"] = config.dataset.thorax
    if getattr(config.dataset, "abdominal", 0) > 0:
        channels["abdominal"] = config.dataset.abdominal

    weights = config.dataset.datasets.__dict__ \
        if hasattr(config.dataset.datasets, "__dict__") else config.dataset.datasets
    train_sets, val_sets, weight_list = [], [], []
    rng = np.random.RandomState(config.common.seed)
    for name, w in weights.items():
        if w <= 0:
            continue
        kw = dict(root=root, dataset=name, cv=config.dataset.cv,
                  channels=channels, max_length=config.dataset.max_length,
                  rng=rng)
        train_sets.append(BreathingDataset(mode="train", **kw))
        val_sets.append(BreathingDataset(mode="val", **kw))
        weight_list.append(w)
    train_ds = MergedDataset(train_sets, weight_list, 1.0,
                             debug=config.dataset.debug, rng=rng)
    val_ds = MergedDataset(val_sets, weight_list, 0.2,
                           debug=config.dataset.debug, rng=rng)
    bs = config.dataset.batch_size
    workers = int(getattr(config.dataset, "num_workers", 0) or 0)
    # eval sees every item (drop_last=False), as torch's DataLoader does by
    # default, except where the JAX trainer shards the batch over a mesh
    # (`distributed.data_parallel`), which the port keeps for equal batches
    dist = getattr(config, "distributed", None)
    uses_mesh = bool(getattr(dist, "data_parallel", False)
                     or getattr(dist, "seq_parallel", 0))
    return (DataLoader(train_ds, bs, shuffle=True, seed=config.common.seed,
                       num_workers=workers),
            DataLoader(val_ds, bs, shuffle=False, seed=config.common.seed,
                       num_workers=workers, drop_last=uses_mesh),
            train_ds.mapping)


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    """Run the experiment; returns the `Trainer` (after `fit`)."""
    parser = argparse.ArgumentParser("encodec_tpu_torch.train")
    parser.add_argument("--config", type=str, required=True,
                        help="YAML (or .json) experiment config")
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--resume_from", type=str, default=None,
                        help="run directory with its config and model.ckpt")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .config import load_config
    from .trainer import Trainer

    if args.resume_from and os.path.exists(args.resume_from):
        log_dir = args.resume_from
        snap = os.path.join(log_dir, "config.yaml")
        if not os.path.exists(snap):
            snap = os.path.join(log_dir, "config.json")
        config = load_config(snap)
        resume = True
    else:
        stamp = datetime.now().strftime("%Y%m%d/%H%M%S")
        log_dir = args.log_dir or os.path.join("runs", stamp)
        config = load_config(args.config, log_dir)
        resume = False

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(log_dir=log_dir)
    except Exception:
        pass

    train_loader, val_loader, mapping = build_dataloaders(config)
    trainer = Trainer(config, train_loader, val_loader, log_dir,
                      label_mapping=mapping, writer=writer,
                      device=args.device)
    if resume:
        trainer.resume()
    trainer.fit(max_epochs=args.max_epochs)
    return trainer


if __name__ == "__main__":
    main()
