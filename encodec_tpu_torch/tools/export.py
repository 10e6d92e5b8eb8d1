"""Export a training run to a reference-format `.th` checkpoint.

Port of `encodec_tpu/tools/export.py`: point it at a run directory (the
trainer's `log_dir`, holding the snapshotted config and `model.ckpt`) and
it writes a zoo-style `.th` (the sha256 prefix of the file in its name)
that reloads bit for bit through `models.zoo.load_pretrained`, here and in
the JAX package, and loads into the reference's own torch modules.

    python -m encodec_tpu_torch.tools.export RUN_DIR [--out DIR] \
        [--name NAME] [--device cuda|cpu]

The run's config is `config.json` or `config.yaml`, whichever the run
directory holds (`train.load_config` snapshots a JSON config, or any config
where PyYAML is missing, as JSON; it reads a `config.yaml` without PyYAML
too, through its YAML subset reader). The checkpoint is the port's own
(`param_layout: torch`) or a JAX-written one, carried across by
`models.zoo.train_state_from_jax`.
"""

from __future__ import annotations

import argparse
import os
import typing as tp

import torch


def run_config_path(run_dir: str) -> str:
    """The run directory's config snapshot: `config.json`, else
    `config.yaml`."""
    for name in ("config.json", "config.yaml"):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{run_dir} holds neither config.json nor "
                            "config.yaml")


def export_run(run_dir: str, out_dir: tp.Optional[str] = None,
               name: tp.Optional[str] = None,
               device: tp.Union[str, torch.device] = "cuda") -> str:
    """Load `run_dir`'s config and newest loadable checkpoint generation on
    `device` and write the reference-format `.th`. Returns its path."""
    from ..device import resolve_device
    from ..models.zoo import save_reference_checkpoint
    from ..train.checkpoint import load_checkpoint_with_fallback
    from ..train.config import load_config
    from ..train.trainer import PARAM_LAYOUT, model_from_config, \
        state_to_device

    device = resolve_device(device)
    model = model_from_config(load_config(run_config_path(run_dir)),
                              device=device)
    raw, epoch, extra = load_checkpoint_with_fallback(
        os.path.join(run_dir, "model.ckpt"))
    if extra.get("param_layout") != PARAM_LAYOUT:
        from ..models.zoo import train_state_from_jax
        raw = train_state_from_jax(raw, model.cfg)
    state = state_to_device(raw, model.device)
    model.params, model.qstate = state.params, state.qstate
    path = save_reference_checkpoint(model, out_dir or run_dir,
                                     name=name or model.name)
    print(f"exported epoch-{epoch} weights -> {path}")
    return path


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        "encodec_tpu_torch.tools.export",
        description="Export a training run as a reference-format .th")
    parser.add_argument("run_dir", help="the trainer's log_dir, with its "
                                        "config and model.ckpt")
    parser.add_argument("--out", default=None,
                        help="output directory (default: run_dir)")
    parser.add_argument("--name", default=None,
                        help="checkpoint base name (default: model name)")
    parser.add_argument("--device", default="cuda",
                        help="where the weights are loaded (cuda or cpu)")
    args = parser.parse_args(argv)
    return export_run(args.run_dir, args.out, args.name, args.device)


if __name__ == "__main__":
    main()
