"""Training the entropy-coding LM on RVQ code sequences.

Port of `encodec_tpu/train/lm_train.py`. The reference ships only
pretrained LMs (model.py:265-284); this trains the multi-codebook
transformer prior on codes (e.g. dumped by `tools.inference.
process_dataset`) so the range coder approaches the codes' empirical
entropy: the teacher-forced next-code cross-entropy over all codebooks,
its gradient by autograd through `models.lm.lm_forward_batch`, then
optax's `chain(clip_by_global_norm(clip), adam(lr))` as `train.optim`
writes it out, with optax.adam's defaults (b1=0.9, b2=0.999, eps=1e-8).

    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cuda")
    opt, opt_state = create_lm_train_state(params, lr=3e-4)
    step = make_lm_train_step(cfg, opt)
    params, opt_state, metrics = step(params, opt_state, codes)  # [B, K, T]

A trained prior codes lmv=3 files through `ilm.IntLMModel.from_lm(
LMModel(cfg, params))`.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..models.lm import LMConfig, lm_forward_batch
from ..utils.profiling import span
from .optim import AdamState, adam_update, init_adam, tree_map
from .steps import _grads, _with_grad


# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class LMOptimizer(tp.NamedTuple):
    """The hyper-parameters of `create_lm_train_state`'s optimizer."""
    lr: float
    clip: tp.Optional[float]


def shift_codes(codes: torch.Tensor) -> torch.Tensor:
    """codes `[B, K, T]` → LM inputs `[B, K, T]`: 1 + the previous code, 0
    at t=0 (the convention of model.py:64-71 / compress.py:69-78)."""
    return torch.cat([torch.zeros_like(codes[:, :, :1]), 1 + codes[:, :, :-1]],
                     dim=2)


def lm_loss(params: dict, codes: torch.Tensor, cfg: LMConfig
            ) -> tp.Tuple[torch.Tensor, dict]:
    """The mean next-code cross-entropy (nats) over `[B, K, T]` codes, and
    `{"nll", "bits_per_code"}`."""
    codes = codes.long()
    logits = lm_forward_batch(params, shift_codes(codes), cfg,
                              return_logits=True)           # [B, card, K, T]
    loss = F.cross_entropy(logits, codes)
    return loss, {"nll": loss, "bits_per_code": loss / math.log(2.0)}


def create_lm_train_state(params: dict, lr: float = 3e-4,
                          clip: tp.Optional[float] = 1.0
                          ) -> tp.Tuple[LMOptimizer, AdamState]:
    """(opt, opt_state) of LM training: Adam after a global-norm clip."""
    return LMOptimizer(lr=lr, clip=clip), init_adam(params)


def make_lm_train_step(cfg: LMConfig, opt: LMOptimizer):
    """`step(params, opt_state, codes) -> (params, opt_state, metrics)`:
    one update on a `[B, K, T]` batch of codes. The inputs are not changed;
    the metrics are detached scalars (`nll`, `bits_per_code`, and
    `grad_norm`, the raw gradient's global norm). The forward, the
    backward and the Adam update are the spans `lm_train.forward`,
    `.backward` and `.adam` (`utils.profiling`)."""

    def step(params: dict, opt_state: AdamState, codes: torch.Tensor):
        params = _with_grad(params)
        with torch.enable_grad():
            with span("lm_train.forward"):
                loss, metrics = lm_loss(params, codes, cfg)
            with span("lm_train.backward"):
                grads = _grads(loss, params)
        with torch.no_grad(), span("lm_train.adam"):
            new_params, opt_state, norm = adam_update(
                grads, opt_state, tree_map(torch.Tensor.detach, params),
                opt.lr, clip=opt.clip, b1=B1, b2=B2, eps=EPS)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = norm.detach()
        return new_params, opt_state, metrics

    return step

