"""Training entry point:

    python -m encodec_tpu_torch.train --config C.yaml [--log_dir D]
        [--resume_from RUN_DIR] [--max_epochs N] [--device cuda|cpu]
    torchrun --nproc_per_node=N -m encodec_tpu_torch.train --config C.yaml

Port of `encodec_tpu/train/__main__.py` (`build_dataloaders`, `main`),
over the port's `data/` loader. Loads and snapshots the config (YAML, or
JSON by the `.json` suffix, which needs no PyYAML), builds the breathing
datasets and the model, and runs the epoch loop with checkpoint and resume
(default device the GPU).

`distributed.data_parallel: true` under torchrun with `WORLD_SIZE > 1`
trains data-parallel, one process per GPU (`cuda:LOCAL_RANK`, NCCL; gloo
with `--device cpu`): the config's `batch_size` is the global batch, each
rank loads its rows, and rank 0 writes the run directory. A single
process, or a world of one, runs the plain path (JAX's `elif n > 1`). A
failed process-group handshake raises. `distributed.seq_parallel: N > 1`
adds time sharding: the world must be a multiple of N, the mesh is
`make_mesh_2d(world // N, N)` (JAX's `__main__.py:108-111`), and the
loaders take the `data` axis's rank and size, so the N seq peers of a
data rank load the same rows.
"""

from __future__ import annotations

import argparse
import os
import typing as tp
from datetime import datetime


def build_dataloaders(config, rank: int = 0, world: int = 1):
    """(train loader, val loader, {dataset id: name}) of `config.dataset`;
    with `world > 1`, loaders of this rank's rows of each global batch."""
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
                       num_workers=workers, rank=rank, world=world),
            DataLoader(val_ds, bs, shuffle=False, seed=config.common.seed,
                       num_workers=workers, drop_last=uses_mesh, rank=rank,
                       world=world),
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
        config = load_config(args.config)
        resume = False

    mesh, rank = None, 0
    data_rank, data_world = 0, 1     # the loaders' share of each batch
    device = args.device
    dist_cfg = getattr(config, "distributed", None)
    seq = int(getattr(dist_cfg, "seq_parallel", 1) or 1)
    if getattr(dist_cfg, "data_parallel", False):
        import torch

        from ..parallel import (comm, initialize_multihost, local_device,
                                make_mesh, make_mesh_2d)
        cpu = torch.device(args.device).type == "cpu"
        live = initialize_multihost(backend="gloo" if cpu else "nccl")
        world = comm.world() if live else 1
        if world % seq:
            raise ValueError(f"distributed.seq_parallel: {seq} does not "
                             f"divide the world of {world} processes")
        if world > 1:
            import torch.distributed as dist

            rank = comm.rank()
            if not cpu:
                device = local_device()
            mesh = (make_mesh_2d(world // seq, seq) if seq > 1
                    else make_mesh(world))
            data_rank = mesh.get_local_rank("data")
            data_world = mesh.size(0)
            # every rank writes to rank 0's run directory
            box = [log_dir]
            dist.broadcast_object_list(box, src=0)
            log_dir = box[0]
    if not resume and rank == 0:
        load_config(args.config, log_dir)   # the snapshot, for resume

    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    train_loader, val_loader, mapping = (
        build_dataloaders(config, data_rank, data_world) if data_world > 1
        else build_dataloaders(config))
    trainer = Trainer(config, train_loader, val_loader, log_dir,
                      label_mapping=mapping, writer=writer, device=device,
                      mesh=mesh)
    if resume:
        trainer.resume()
    trainer.fit(max_epochs=args.max_epochs)
    return trainer


if __name__ == "__main__":
    main()
