"""Gradient-balancing loss combiner.

Port of `encodec_tpu/losses/balancer.py`. Behavioral reference:
encodec/balancer.py:31-118 (which the reference defines but never wires
into train.py; here `loss.use_balancer` turns it on). For each loss
`l_i(x̂)` its gradient `g_i = ∂l_i/∂x̂` is taken on a detached copy of x̂
(`torch.autograd.grad`); the per-item gradient norms are EMA-averaged in an
explicit state, each gradient is rescaled so loss i contributes
`weight_i / Σweights · total_norm`, and the caller pulls the combined
cotangent back through the generator with one backward
(`train.steps`' balanced step).

Under a data-parallel step (`dp`, `ops.batch_reduce`) x̂ is this rank's
rows and the losses are global-batch means, so each `g_i` is this rank's
slice of the global gradient; the norms are global-batch quantities too
(the mean of per-item norms over the global batch, or the square root of
the summed squares), so every rank scales alike and the cotangent is its
slice of the single-process one.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..ops.batch_reduce import LOCAL, BatchReduce


def averager(beta: float = 1.0):
    """Exponential-moving-average callback over metric dicts
    (ref balancer.py:10-28): call it with new metrics, get the running
    de-biased averages back. beta=1 is plain averaging."""
    total: tp.Dict[str, float] = {}
    fix: tp.Dict[str, float] = {}

    def _update(metrics: tp.Dict[str, tp.Any],
                weight: float = 1.0) -> tp.Dict[str, float]:
        for key, value in metrics.items():
            total[key] = total.get(key, 0.0) * beta + weight * float(value)
            fix[key] = fix.get(key, 0.0) * beta + weight
        return {key: tot / fix[key] for key, tot in total.items()}
    return _update


@dataclasses.dataclass(frozen=True)
class Balancer:
    weights: tp.Dict[str, float]
    rescale_grads: bool = True
    total_norm: float = 1.0
    ema_decay: float = 0.999
    per_batch_item: bool = True
    epsilon: float = 1e-12


def init_balancer_state(balancer: Balancer,
                        device: torch.device = torch.device("cpu")) -> dict:
    keys = sorted(balancer.weights)
    return {"total": {k: torch.zeros((), device=device) for k in keys},
            "fix": {k: torch.zeros((), device=device) for k in keys}}


def _ema_update(state: dict, norms: tp.Dict[str, torch.Tensor],
                decay: float, weight: float = 1.0):
    new_total = {k: state["total"][k] * decay + weight * norms[k]
                 for k in norms}
    new_fix = {k: state["fix"][k] * decay + weight for k in norms}
    avg = {k: new_total[k] / new_fix[k] for k in norms}
    return avg, {"total": new_total, "fix": new_fix}


def balance(balancer: Balancer,
            loss_fns: tp.Dict[str, tp.Callable[[torch.Tensor], torch.Tensor]],
            x_hat: torch.Tensor, state: dict, dp: BatchReduce = LOCAL):
    """The balanced cotangent for `x_hat`: returns `(cotangent, losses,
    new_state, metrics)`, the losses and the cotangent detached. The
    arithmetic is the reference `Balancer.backward`'s; `dp` reduces the
    norms over the batch."""
    norms: tp.Dict[str, torch.Tensor] = {}
    grads: tp.Dict[str, torch.Tensor] = {}
    losses: tp.Dict[str, torch.Tensor] = {}
    for name, fn in loss_fns.items():
        y = x_hat.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fn(y)
            grad, = torch.autograd.grad(loss, y)
        losses[name] = loss.detach()
        if balancer.per_batch_item:
            dims = tuple(range(1, grad.dim()))
            norms[name] = dp.mean(grad.square().sum(dim=dims).sqrt().mean())
        else:
            norms[name] = dp.sum(grad.square().sum()).sqrt()
        grads[name] = grad

    avg_norms, new_state = _ema_update(state, norms, balancer.ema_decay)
    total = sum(avg_norms.values())
    metrics = {f"ratio_{k}": v / total for k, v in avg_norms.items()}

    total_weights = sum(balancer.weights[k] for k in avg_norms)
    out_grad = torch.zeros_like(x_hat)
    for name, avg_norm in avg_norms.items():
        if balancer.rescale_grads:
            ratio = balancer.weights[name] / total_weights
            scale = ratio * balancer.total_norm / (balancer.epsilon + avg_norm)
            out_grad = out_grad + grads[name] * scale
        else:
            out_grad = out_grad + balancer.weights[name] * grads[name]
    return out_grad.detach(), losses, new_state, metrics
