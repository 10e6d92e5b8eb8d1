"""The generator's optimizer: optax's Adam with global-norm clipping,
written out with tensor ops.

Counterpart of `encodec_tpu/train/steps.py:75-83`:
`optax.inject_hyperparams(chain(clip_by_global_norm(0.1), adam(lr, b1=0.8,
b2=0.9)))`. The arithmetic is optax's, not `torch.optim`'s:
- the clip is `where(norm < max, g, g / norm * max)` with the global norm
  `sqrt(Σ_leaves Σ g²)` (`torch.nn.utils.clip_grad_norm_` divides by
  `norm + 1e-6` instead);
- the moments update as `(1 - b)·g^order + b·m` (optax's
  `update_moment`), the bias corrections divide by `1 - b^count` in
  float32, and the step is `-lr · mu_hat / (sqrt(nu_hat + eps_root) + eps)`
  (`torch.optim.Adam` forms its denominator from the uncorrected second
  moment).

The state is `AdamState(count, mu, nu)`, `mu` and `nu` trees shaped like
the parameters, so moments carried across from a JAX `TrainState`
(`models.zoo.train_state_from_jax`) continue the same run. Updates are
functional: new tensors, the inputs untouched.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

B1, B2, EPS, EPS_ROOT = 0.8, 0.9, 1e-8, 0.0


class AdamState(tp.NamedTuple):
    count: torch.Tensor   # [] int32: updates taken
    mu: tp.Any            # first moments, shaped like the parameters
    nu: tp.Any            # second moments


def tree_map(fn, tree, *rest):
    """`fn` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> tp.List[torch.Tensor]:
    """The tensor leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_adam(params) -> AdamState:
    first = tree_leaves(params)[0]
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(count=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                     mu=zeros, nu=tree_map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    """`sqrt(Σ_leaves Σ x²)`, the leaves summed in JAX's order."""
    total = None
    for x in tree_leaves(tree):
        s = x.square().sum()
        total = s if total is None else total + s
    return total.sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """optax's clip: each leaf unchanged when the global norm is below
    `max_norm`, else `leaf / norm * max_norm`. Returns (clipped, norm)."""
    norm = global_norm(grads)
    trigger = norm < max_norm
    return tree_map(lambda g: torch.where(trigger, g, g / norm * max_norm),
                    grads), norm


def adam_update(grads, state: AdamState, params, lr: float,
                clip: tp.Optional[float] = 0.1, b1: float = B1,
                b2: float = B2, eps: float = EPS, eps_root: float = EPS_ROOT):
    """One step: (new_params, new_state, global norm of the raw grads).

    `lr` is rounded to float32 first, as `inject_hyperparams` holds it."""
    norm = global_norm(grads)
    if clip:
        grads, _ = clip_by_global_norm(grads, clip)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * g.square() + b2 * v, grads,
                  state.nu)
    count = state.count + 1
    # 1 - b^count in float32, as optax's bias correction
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=c.device) ** c
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=c.device) ** c
    step = -float(np.float32(lr))
    new_params = tree_map(
        lambda p, m, v: p + step * ((m / bc1)
                                    / ((v / bc2 + eps_root).sqrt() + eps)),
        params, mu, nu)
    return new_params, AdamState(count=count, mu=mu, nu=nu), norm
