"""Experiment runner: config → model → epoch loop, and configs → models.

Port of `encodec_tpu/train/trainer.py` (`model_from_config`, `Trainer`:
`weights_for_epoch`, `train_one_epoch`, `evaluate`, `code_stats`, `save`,
`resume`, `fit`; `disc_from_config`). Behavioral reference:
encodec/train.py:551-653 (main) and 39-353 (train_one_step / test):
per-epoch generator steps, from `train_discriminator_start_epoch` a coin
flip per batch (probability `train_discriminator_prob`) between a GAN
generator step and a plain generator step followed by a discriminator
step, the commit loss gated by `commit_start_epoch`,
LinearWarmupCosineAnnealing per epoch, periodic eval and checkpoint,
TensorBoard scalars when a writer is given, per-codebook code entropies;
the gradient balancer when `balancer.weights` is set and
`loss.use_balancer` is true.

The trainer runs on `device` (default "cuda"; it raises without a GPU;
"cpu" runs every plain twin). Configs it cannot run yet are refused when
the trainer is built, not epochs later: a compute dtype other than
float32 (ROADMAP item 11d) and `distributed.seq_parallel` above 1 (the
data×seq step, item 11f).

`checkpoint.async_save: true` writes through `AsyncCheckpointer` (JAX's
`trainer.py:328-354`): `resume` and the end of `fit` wait for the write.

Data parallelism (`mesh=`, a `DeviceMesh` with a `data` axis, one process
per device; `python -m encodec_tpu_torch.train` builds it under torchrun):
the loaders yield each rank's rows of the global batch, the steps are the
data-parallel steps (`make_train_steps(mesh=)`), the train metrics are
global, eval's per-item losses and code entropies are over the gathered
rows, and rank 0 alone writes the config, TensorBoard, figures and
checkpoints (a barrier follows each wait for a write); every rank loads on
resume. A preemption request on any rank stops every rank at the same
step boundary.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import logging
import os
import random
import time
import typing as tp

import numpy as np
import torch

from ..device import resolve_device
from ..losses.balancer import Balancer
from ..models.model import EncodecModel, build_model
from ..models.msstftd import MSSTFTConfig
from ..quant import RVQState, num_quantizers_for_bandwidth
from ..parallel import comm
from .checkpoint import (AsyncCheckpointer, load_checkpoint_with_fallback,
                         previous_path, save_checkpoint)
from .config import ConfigNamespace, config_to_dict, parse_segment
from .metrics import Metrics
from .optim import AdamState
from .schedulers import linear_warmup_cosine
from .steps import (LossWeights, TrainState, create_train_state,
                    make_train_steps, refuse_bf16, refuse_seq_parallel)

# `extra` of the checkpoints this trainer writes: the parameters are in the
# port's (torch) layout, unlike a JAX-written file's
PARAM_LAYOUT = "torch"


def model_from_config(config: ConfigNamespace,
                      device: tp.Union[str, torch.device] = "cuda"
                      ) -> EncodecModel:
    """Build the generator of an experiment config (its `model:` section),
    with the fork's fixed choices: no norm on the decoder's last conv and
    one shared codebook. `model.remat: true` recomputes each SEANet stage
    in the backward (less activation memory, the same arithmetic)."""
    m = config.model
    model = build_model(
        list(m.target_bandwidths), sample_rate=m.sample_rate,
        channels=m.channels, causal=m.causal, model_norm=m.norm,
        audio_normalize=m.audio_normalize, segment=parse_segment(m.segment),
        name=m.name, ratios=list(m.ratios), bins=m.bins,
        dimension=getattr(m, "dimension", 128),
        n_filters=getattr(m, "filters", 32),
        decoder_final_norm="none",
        shared_codebook=True,
        device=device,
    )
    if getattr(m, "remat", False):
        seanet = dataclasses.replace(model.cfg.seanet, remat=True)
        model.cfg = dataclasses.replace(model.cfg, seanet=seanet)
    return model


def disc_from_config(config: ConfigNamespace
                     ) -> tp.Optional[MSSTFTConfig]:
    """The MS-STFT discriminator of a config's `model:` section, or None
    without `train_discriminator`."""
    m = config.model
    if not getattr(m, "train_discriminator", False):
        return None
    return MSSTFTConfig(
        filters=m.filters, in_channels=m.channels, out_channels=m.channels,
        n_ffts=tuple(m.disc_n_ffts), hop_lengths=tuple(m.disc_hop_lengths),
        win_lengths=tuple(m.disc_win_lengths),
        conv_impl=str(getattr(m, "disc_conv_impl", "xla")),
        time_chunk=getattr(m, "disc_time_chunk", None))


def _tensors(tree, device: torch.device):
    """numpy leaves → tensors on `device` (the same bits)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v, device) for v in tree)
    return tree


def state_to_device(raw, device: torch.device) -> TrainState:
    """A `TrainState` tree (tensors, or numpy leaves as `load_checkpoint`
    returns a port-written file) → the port's `TrainState` on `device`;
    the generator state stays a CPU byte tensor."""
    params, qstate, opt_state, rng = raw[0], raw[1], raw[2], raw[6]
    q = RVQState(*(_tensors(t, device) for t in tuple(qstate)[:3]),
                 inited=bool(np.asarray(tuple(qstate)[3])))
    disc_opt = raw[4]
    return TrainState(
        params=_tensors(params, device), qstate=q,
        opt_state=AdamState(*_tensors(tuple(opt_state), device)),
        disc_params=_tensors(raw[3], device),
        disc_opt_state=(None if disc_opt is None else
                        AdamState(*_tensors(tuple(disc_opt), device))),
        balancer_state=_tensors(raw[5], device),
        rng=torch.as_tensor(np.asarray(rng, np.uint8)).cpu())


class Trainer:
    def __init__(self, config: ConfigNamespace, train_loader, val_loader,
                 log_dir: str, label_mapping: tp.Optional[dict] = None,
                 writer=None, device: tp.Union[str, torch.device] = "cuda",
                 mesh=None):
        """`train_loader` and `val_loader` yield `(batch, ds_ids)` with
        `batch["x"]` a `[B, T, C]` float32 array (the port's `DataLoader`;
        under `mesh`, this rank's rows)."""
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.log_dir = log_dir
        self.label_mapping = label_mapping or {}
        dtype_name = getattr(config.common, "compute_dtype", None)
        if dtype_name and str(dtype_name) not in ("float32", "f32"):
            refuse_bf16(f"common.compute_dtype: {dtype_name}")
        seq = int(getattr(getattr(config, "distributed", None),
                          "seq_parallel", 0) or 0)
        if seq > 1:
            refuse_seq_parallel(f"distributed.seq_parallel: {seq}")
        self.mesh = mesh
        self.group = None if mesh is None else mesh.get_group("data")
        self.rank = 0 if mesh is None else comm.rank(self.group)
        self.async_save = bool(getattr(getattr(config, "checkpoint", None),
                                       "async_save", False))
        self._async_ckpt: tp.Optional[AsyncCheckpointer] = None
        self.device = resolve_device(device)
        os.makedirs(log_dir, exist_ok=True)

        self.model = model_from_config(config, self.device)
        self.disc_cfg = disc_from_config(config)
        # the gradient balancer (the reference config-stubs it but never
        # wires it, params/config.yaml:79-84)
        self.balancer = None
        bal_cfg = getattr(config, "balancer", None)
        if bal_cfg is not None and getattr(bal_cfg, "weights", None):
            weights = bal_cfg.weights
            weights = getattr(weights, "__dict__", weights)
            self.balancer = Balancer(weights={k: float(v)
                                              for k, v in weights.items()})
        self.clip = 0.1 if config.common.gradient_clipping else None
        self.state = create_train_state(self.model, self.disc_cfg,
                                        seed=config.common.seed,
                                        clip=self.clip,
                                        balancer=self.balancer)
        loss_cfg = config.loss
        freq_kwargs = dict(alpha=loss_cfg.alpha, bandwidth=loss_cfg.bandwidth,
                           sampling_rate=10, n_fft=loss_cfg.n_fft)
        if getattr(loss_cfg, "win_length", None):
            freq_kwargs["win_length"] = loss_cfg.win_length
        if getattr(loss_cfg, "hop_length", None):
            freq_kwargs["hop_length"] = loss_cfg.hop_length

        self.freq_kwargs = freq_kwargs
        disc_remat = bool(getattr(config.common, "disc_remat", False))
        if disc_remat and self.disc_cfg is not None \
                and self.disc_cfg.time_chunk:
            logging.warning(
                "common.disc_remat is ignored: model.disc_time_chunk=%d "
                "supersedes it (the chunk loop already rematerializes)",
                self.disc_cfg.time_chunk)

        def make_steps(n_q=None):
            return make_train_steps(
                self.model.cfg, self.disc_cfg, freq_loss_kwargs=freq_kwargs,
                balancer=self.balancer, clip=self.clip, n_q=n_q,
                disc_remat=disc_remat, mesh=mesh)

        (self.gen_step, self.disc_step, self.eval_step,
         self.balanced_gen_step) = make_steps()
        # `model.sample_bandwidths: true`: one n_q per step, drawn from the
        # target bandwidths (stages >= n_q keep their state that step)
        self.sample_bandwidths = bool(
            getattr(config.model, "sample_bandwidths", False))
        self._bandwidth_nqs = sorted({
            num_quantizers_for_bandwidth(
                self.model.cfg.rvq, self.model.frame_rate, bw)
            for bw in self.model.cfg.target_bandwidths})
        self._steps_by_nq: tp.Dict[int, tuple] = {}

        def steps_for(n_q):
            """(gen_step, disc_step, balanced_gen_step) at `n_q`."""
            if n_q is None or n_q == self.model.cfg.rvq.n_q:
                return self.gen_step, self.disc_step, self.balanced_gen_step
            if n_q not in self._steps_by_nq:
                gen, disc, _, balanced = make_steps(n_q)
                self._steps_by_nq[n_q] = (gen, disc, balanced)
            return self._steps_by_nq[n_q]

        self._steps_for = steps_for
        self.use_balancer = bool(self.balancer) and \
            bool(getattr(loss_cfg, "use_balancer", False))
        self.metrics = Metrics()
        self.writer = writer if self.rank == 0 else None
        self.start_epoch = 1
        self.epoch_seconds: tp.Dict[int, float] = {}  # training loop only
        self._said_no_matplotlib = False
        random.seed(config.common.seed)
        self._snapshot_config()

    def _snapshot_config(self) -> None:
        """The experiment config in the run directory, for a self-contained
        resume (ref train.py:379-384): config.yaml, or config.json where
        PyYAML is missing. Rank 0 alone writes it."""
        if self.rank != 0 or any(os.path.exists(os.path.join(self.log_dir, n))
               for n in ("config.yaml", "config.json")):
            return
        cfg = config_to_dict(self.config)
        try:
            import yaml
        except ImportError:
            with open(os.path.join(self.log_dir, "config.json"), "w") as fh:
                json.dump(cfg, fh)
            return
        with open(os.path.join(self.log_dir, "config.yaml"), "w") as fh:
            yaml.dump(cfg, fh)

    def _sync_model(self) -> None:
        """`model.params` (and its weight-norm fold) and `model.qstate`
        follow the train state, so `trainer.model` encodes and decodes
        with the trained weights."""
        self.model.params = self.state.params
        self.model.qstate = self.state.qstate

    # -- schedule ---------------------------------------------------------
    def weights_for_epoch(self, epoch: int) -> LossWeights:
        c = self.config
        lr = linear_warmup_cosine(epoch - 1, float(c.optimization.lr),
                                  c.lr_scheduler.warmup_epoch,
                                  c.common.max_epoch)
        disc_start = getattr(c.model, "train_discriminator_start_epoch", 0)
        disc_lr = linear_warmup_cosine(
            max(0, epoch - 1 - disc_start), float(c.optimization.disc_lr),
            c.lr_scheduler.warmup_epoch, c.common.max_epoch - disc_start)
        commit_on = epoch >= getattr(c.loss, "commit_start_epoch", 0)
        return LossWeights.make(
            l1=c.loss.weight_l1, l2=c.loss.weight_l2, freq=c.loss.weight_freq,
            commit=c.loss.weight_commit if commit_on else 0.0,
            codebook=1.0 if commit_on else 0.0,
            gen=c.loss.weight_g, feat=c.loss.weight_feat,
            lr=lr, disc_lr=disc_lr)

    def _batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch["x"], np.float32)).to(
            self.device)

    def _gan_active(self, epoch: int) -> bool:
        c = self.config.model
        return bool(getattr(c, "train_discriminator", False)) and \
            epoch >= c.train_discriminator_start_epoch

    # -- loops ------------------------------------------------------------
    def train_one_epoch(self, epoch: int, guard=None) -> dict:
        weights = self.weights_for_epoch(epoch)
        gan = self._gan_active(epoch)
        prob = float(getattr(self.config.model, "train_discriminator_prob",
                             0.5))
        log_this = epoch % self.config.common.log_interval == 0
        for batch, _ds_ids in self.train_loader:
            stop = guard is not None and guard.requested
            if self.mesh is not None:
                stop = comm.any_rank(stop, self.group)
            if stop:
                break  # stop at a step boundary; fit checkpoints
            x = self._batch(batch)
            # the draws in JAX's order: the coin, then the bandwidth
            train_disc = gan and random.random() < prob
            gen_step, disc_step, balanced_step = self._steps_for(
                random.choice(self._bandwidth_nqs)
                if self.sample_bandwidths else None)
            if self.use_balancer and not (gan and not train_disc):
                self.state, m = balanced_step(self.state, x, weights)
            else:
                self.state, m = gen_step(self.state, x, weights,
                                         use_gan=gan and not train_disc)
            if train_disc:
                self.state, dm = disc_step(self.state, x, weights)
                if log_this:
                    self.metrics.fill_metrics(
                        {"Loss Discriminator": dm["loss_disc"],
                         "Logits Real": dm["logits_real"],
                         "Logits Fake": dm["logits_fake"]})
            if log_this:
                self.metrics.fill_metrics({
                    "Loss": m["loss"], "Loss L1": m["loss_l1"],
                    "Loss L2": m["loss_l2"],
                    "Loss Frequency": m["loss_freq"],
                    "Loss commit_loss": m["loss_commit"],
                    "Frequency Accuracy": m["freq_acc"],
                    "Max Gradient": m["grad_norm"],
                })
        self._sync_model()
        out = {}
        if log_this:
            out = self.metrics.compute_and_log_metrics()
            out["Learning Rate"] = float(weights.lr)
            self._log(out, "train", epoch)
            self.metrics.clear_metrics()
        return out

    def evaluate(self, epoch: int, save_figure: bool = True) -> dict:
        """Validation losses (also per dataset and item) and code entropies.

        With `save_figure` (mono models), the first batch's first item and
        its reconstruction are drawn to `<log_dir>/<epoch>.png`
        (`tools.visualize.reconstruction_figure`, ref train.py:290-313).
        Without matplotlib the figure is skipped, said once per trainer.
        Unlike JAX's trainer, a figure that fails raises: only a missing
        matplotlib is passed over. Under a mesh the per-item losses and the
        codes are gathered from every rank, and rank 0 draws."""
        weights = self.weights_for_epoch(epoch)
        all_codes = []
        n_batches = 0
        for batch, ds_ids in self.val_loader:
            n_batches += 1
            x = self._batch(batch)
            m, codes, x_hat = self.eval_step(self.state, x, weights)
            if n_batches == 1 and save_figure and self.rank == 0 \
                    and self.model.cfg.channels == 1:
                self._figure(epoch, x, x_hat)
            l_t, l_t_2 = m["l_t"], m["l_t_2"]
            if self.mesh is not None:
                codes = comm.all_gather(codes, self.group)
                l_t = comm.all_gather(l_t, self.group)
                l_t_2 = comm.all_gather(l_t_2, self.group)
                ds_ids = comm.all_gather(torch.as_tensor(
                    np.asarray(ds_ids, np.int64)), self.group).numpy()
            all_codes.append(codes.cpu().numpy())
            self.metrics.fill_metrics({
                "Loss": m["loss"], "Loss L1": m["loss_l1"],
                "Loss L2": m["loss_l2"], "Loss Frequency": m["loss_freq"],
                "Frequency Accuracy": m["freq_acc"],
            })
            # per-dataset per-item losses (ref train.py:258-261)
            l_t, l_t_2 = l_t.cpu().numpy(), l_t_2.cpu().numpy()
            for j, d_id in enumerate(np.asarray(ds_ids)):
                name = self.label_mapping.get(int(d_id), str(int(d_id)))
                self.metrics.fill_metrics({f"Loss L1 {name}": l_t[j],
                                           f"Loss L2 {name}": l_t_2[j]})
        if n_batches == 0:
            logging.warning(
                "evaluate(epoch=%d): validation loader yielded no batches "
                "(dataset smaller than batch_size with drop_last?): no val "
                "metrics this epoch", epoch)
        out = self.metrics.compute_and_log_metrics()
        self.metrics.clear_metrics()
        if all_codes:
            out.update(self.code_stats(np.concatenate(all_codes, axis=0)))
        self._log({k: v for k, v in out.items()
                   if isinstance(v, (int, float))}, "val", epoch)
        return out

    def _figure(self, epoch: int, x: torch.Tensor,
                x_hat: torch.Tensor) -> None:
        if importlib.util.find_spec("matplotlib") is None:
            if not self._said_no_matplotlib:
                logging.warning("matplotlib is not installed: evaluate() "
                                "draws no reconstruction figures")
                self._said_no_matplotlib = True
            return
        from ..tools.visualize import reconstruction_figure
        fl = self.config.loss
        reconstruction_figure(
            x[0, :, 0].cpu().numpy(), x_hat[0, :, 0].cpu().numpy(),
            sampling_rate=10, n_fft=fl.n_fft,
            win_length=getattr(fl, "win_length", None),
            hop_length=getattr(fl, "hop_length", None),
            path=os.path.join(self.log_dir, f"{epoch}.png"))

    def code_stats(self, codes: np.ndarray) -> dict:
        """Per-codebook empirical entropy (ref train.py:325-343); codes
        `[N, K, T]`."""
        bins = self.model.cfg.rvq.bins
        entropies = []
        for k in range(codes.shape[1]):
            counts = np.bincount(codes[:, k].reshape(-1), minlength=bins)
            p = counts / max(1, counts.sum())
            nz = p[p > 0]
            entropies.append(float(-(nz * np.log2(nz)).sum()))
        return {"code_entropy": entropies,
                "code_entropy_mean": float(np.mean(entropies))}

    # -- logging / checkpointing ------------------------------------------
    def _log(self, metrics: dict, phase: str, epoch: int) -> None:
        if self.writer is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(f"{phase}/{k}", v, epoch)
            self.writer.flush()

    def save(self, epoch: int) -> None:
        """Checkpoint the full train state to `<log_dir>/model.ckpt`; the
        config rides along, and `param_layout` marks the port's layout.
        With `checkpoint.async_save: true` the write overlaps training
        (`AsyncCheckpointer`). Under a mesh rank 0 alone writes."""
        if self.rank != 0:
            return
        path = os.path.join(self.log_dir, "model.ckpt")
        extra = {"config": config_to_dict(self.config),
                 "param_layout": PARAM_LAYOUT}
        if self.async_save:
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save(self.state, epoch, path, extra=extra)
        else:
            save_checkpoint(self.state, epoch, path, extra=extra)

    def wait_for_checkpoint(self) -> None:
        """Block until an asynchronous write in flight is done (raising its
        error); under a mesh, then a barrier, so every rank sees the
        file."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        if self.mesh is not None:
            comm.barrier(self.group)

    def resume(self, path: tp.Optional[str] = None) -> None:
        """Continue from `path` (default `<log_dir>/model.ckpt`, falling back
        to `.prev` when the newest generation is truncated or missing): a
        file this trainer wrote, bit for bit, or a JAX-written one through
        `models.zoo.train_state_from_jax`. Without either, nothing
        changes. Waits for a write in flight first; every rank loads."""
        self.wait_for_checkpoint()
        path = path or os.path.join(self.log_dir, "model.ckpt")
        if not (os.path.exists(path) or os.path.exists(previous_path(path))):
            return
        raw, epoch, extra = load_checkpoint_with_fallback(path)
        if extra.get("param_layout") != PARAM_LAYOUT:
            from ..models.zoo import train_state_from_jax
            raw = train_state_from_jax(raw, self.model.cfg)
        self.state = state_to_device(raw, self.device)
        self.start_epoch = epoch + 1
        self._sync_model()

    def fit(self, max_epochs: tp.Optional[int] = None,
            on_epoch: tp.Optional[tp.Callable[[int, dict], None]] = None,
            preemption=None):
        """Epoch loop with periodic eval and checkpoint, and graceful
        preemption: pass a `train.preemption.PreemptionGuard` (or rely on
        the default, installed for SIGTERM) and a preempted run checkpoints
        at the next step boundary before returning."""
        from .preemption import PreemptionGuard
        max_epochs = max_epochs or self.config.common.max_epoch
        save_every = self.config.checkpoint.save_every
        guard = preemption if preemption is not None else PreemptionGuard()
        with guard:
            for epoch in range(self.start_epoch, max_epochs + 1):
                t0 = time.time()
                metrics = self.train_one_epoch(epoch, guard=guard)
                self.epoch_seconds[epoch] = time.time() - t0
                stop = guard.requested
                if self.mesh is not None:
                    stop = comm.any_rank(stop, self.group)
                if stop:
                    # the epoch was cut short: label the checkpoint so a
                    # resume re-runs it from its start
                    self.save(epoch - 1)
                    logging.warning(
                        "preemption requested: checkpointed mid-run at "
                        "epoch %d; resume re-runs this epoch", epoch)
                    break
                # `% == 1` is the reference's cadence (ref train.py:639),
                # with its quirk that save_every=1 never fires fixed, and
                # the last epoch always checkpoints
                if (epoch % save_every == 1 or save_every == 1
                        or epoch == max_epochs):
                    self.evaluate(epoch)
                    self.save(epoch)
                if on_epoch:
                    on_epoch(epoch, metrics)
        self.wait_for_checkpoint()
        return self.state
