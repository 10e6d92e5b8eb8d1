"""Training steps: the generator step and the eval step.

Port of `encodec_tpu/train/steps.py` (`LossWeights`, `TrainState`,
`create_train_state`, `make_train_steps`' `gen_step` and `eval_step`).
Behavioral reference: encodec/train.py:39-188 — generator loss = w_l1·L1
+ w_freq·spectral + w_l2·L2 + (w_commit + w_codebook)·commit, Adam(β=0.8,
0.9) with global-norm clip 0.1 (`train/optim.py`).

On the card every kernel of the path runs inside the step: K3's saving
forward and its backward kernel for the four LSTM layers, K1 for every
RVQ search (and every k-means iteration of the first batch), K2 in the
eval step. `plain=True` runs every plain twin instead (the reference the
kernels are held to on the card).

Not ported (ROADMAP 11a, the GAN slice): the discriminator and its step,
the GAN loss terms, the gradient balancer and `compute_dtype=bfloat16`;
asking for them raises `NotImplementedError`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..losses.gan import total_loss
from ..losses.spectrogram import reconstruction_loss
from ..models.model import EncodecConfig, forward_train
from ..quant import RVQState
from .optim import AdamState, adam_update, init_adam, tree_leaves, tree_map

GAN_SLICE = ("the GAN phase (MS-STFT discriminator, disc_step, the gradient "
             "balancer, bfloat16 compute) is not ported yet: ROADMAP item 11a")


def refuse_gan(what: str) -> tp.NoReturn:
    raise NotImplementedError(f"{what}: {GAN_SLICE}")


def _f32(v) -> float:
    return float(np.float32(v))


class LossWeights(tp.NamedTuple):
    """Per-step loss weights and learning rates, rounded to float32 as the
    JAX package holds them."""
    l1: float
    l2: float
    freq: float
    commit: float
    codebook: float
    gen: float
    feat: float
    lr: float
    disc_lr: float

    @classmethod
    def make(cls, *, l1=1.0, l2=0.0, freq=1.0, commit=0.0, codebook=0.0,
             gen=3.0, feat=3.0, lr=1e-4, disc_lr=3e-4):
        return cls(*(_f32(v) for v in
                     (l1, l2, freq, commit, codebook, gen, feat, lr, disc_lr)))


class TrainState(tp.NamedTuple):
    """JAX's `TrainState` fields: `params` (unfolded weight norm),
    `qstate`, `opt_state` (`AdamState`), the discriminator's and the
    balancer's (None until the GAN slice), and `rng`, the state of the CPU
    `torch.Generator` the step draws from (uint8)."""
    params: tp.Any
    qstate: RVQState
    opt_state: AdamState
    disc_params: tp.Any
    disc_opt_state: tp.Any
    balancer_state: tp.Any
    rng: torch.Tensor


def create_train_state(model, disc_cfg=None, seed: int = 0,
                       clip: tp.Optional[float] = 0.1,
                       balancer=None) -> TrainState:
    """A fresh `TrainState` for an `EncodecModel`: its parameters (copied)
    and quantizer state, zero Adam moments, and a generator seeded with
    `seed`. (`clip` shapes nothing here; it is taken for JAX's signature.)"""
    if disc_cfg is not None:
        refuse_gan("a discriminator config")
    if balancer is not None:
        refuse_gan("the gradient balancer")
    params = tree_map(lambda t: t.detach().clone(), model.params)
    return TrainState(params=params, qstate=model.qstate,
                      opt_state=init_adam(params), disc_params=None,
                      disc_opt_state=None, balancer_state=None,
                      rng=torch.Generator().manual_seed(seed).get_state())


def make_train_steps(model_cfg: EncodecConfig, disc_cfg=None, *,
                     n_q: tp.Optional[int] = None,
                     freq_loss_kwargs: tp.Optional[dict] = None,
                     balancer=None, clip: tp.Optional[float] = 0.1,
                     compute_dtype=None, plain: bool = False):
    """Build `(gen_step, eval_step)`.

    gen_step(state, batch [B, T, C], weights, keep_grads=False) →
        (new_state, metrics); with `keep_grads`, `metrics` also holds
        "grads" (the gradient tree, before clipping), "codes" [B, K, T']
        and "margins" [K, B·T'] (each stage's top-2 search margins).
    eval_step(state, batch, weights) → (metrics, codes [B, K, T'], x_hat)

    `batch` is a float32 tensor on the parameters' device. The step is
    functional: `state` is not modified."""
    if disc_cfg is not None:
        refuse_gan("a discriminator config")
    if balancer is not None:
        refuse_gan("the gradient balancer")
    if compute_dtype is not None and compute_dtype not in (torch.float32,
                                                          "float32", "f32"):
        refuse_gan(f"compute_dtype={compute_dtype}")
    n_q = n_q or model_cfg.rvq.n_q
    fl_kwargs = dict(alpha=0.01, bandwidth=None, sampling_rate=10, n_fft=512)
    fl_kwargs.update(freq_loss_kwargs or {})

    def freq_loss(x, x_hat):
        return reconstruction_loss(x[..., 0], x_hat[..., 0], **fl_kwargs)

    def gen_step(state: TrainState, batch: torch.Tensor,
                 weights: LossWeights, keep_grads: bool = False):
        generator = torch.Generator()
        generator.set_state(state.rng)
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        margins: tp.Optional[list] = [] if keep_grads else None
        with torch.enable_grad():
            x_hat, codes, commit, new_qstate = forward_train(
                params, state.qstate, batch, model_cfg, n_q, generator,
                training=True, plain=plain, margins=margins)
            commit_mean = commit.mean()
            freq = freq_loss(batch, x_hat)
            losses_g = total_loss(None, None, None, batch, x_hat)
            loss = (losses_g["l_1"] * weights.l1
                    + freq["total_loss"] * weights.freq
                    + losses_g["l_2"] * weights.l2
                    + commit_mean * weights.commit
                    + commit_mean * weights.codebook)
            leaves = tree_leaves(params)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, flat)}
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        new_params, new_opt, grad_norm = adam_update(
            grads, state.opt_state, state.params, weights.lr, clip)
        metrics = {
            "loss": loss.detach(),
            "loss_l1": losses_g["l_1"].detach(),
            "loss_l2": losses_g["l_2"].detach(),
            "loss_freq": freq["total_loss"].detach(),
            "loss_freq_l1": freq["l1_loss"].detach(),
            "loss_freq_l2": freq["l2_loss"].detach(),
            "freq_acc": freq["acc"],
            "loss_commit": commit_mean.detach(),
            "grad_norm": grad_norm,
        }
        if keep_grads:
            metrics.update(grads=grads, codes=codes,
                           margins=torch.stack(margins))
        return state._replace(params=new_params, qstate=new_qstate,
                              opt_state=new_opt,
                              rng=generator.get_state()), metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor,
                  weights: LossWeights):
        x_hat, codes, commit, _ = forward_train(
            state.params, state.qstate, batch, model_cfg, n_q, training=False,
            plain=plain)
        freq = freq_loss(batch, x_hat)
        losses_g = total_loss(None, None, None, batch, x_hat)
        loss = (losses_g["l_1"] * weights.l1
                + freq["total_loss"] * weights.freq
                + losses_g["l_2"] * weights.l2
                + commit.mean() * weights.commit)
        metrics = {
            "loss": loss, "loss_l1": losses_g["l_1"],
            "loss_l2": losses_g["l_2"], "loss_freq": freq["total_loss"],
            "freq_acc": freq["acc"], "loss_commit": commit.mean(),
            "l_t": losses_g["l_t"], "l_t_2": losses_g["l_t_2"],
        }
        return metrics, codes, x_hat

    return gen_step, eval_step
