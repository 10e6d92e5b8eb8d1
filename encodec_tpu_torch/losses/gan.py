"""Generator / discriminator losses (ref encodec/my_code/losses.py).

Port of `encodec_tpu/losses/gan.py`. LSGAN-style objectives as the fork
uses them:
  generator:     l_g    = mean_k mean((1 - D_k(x̂))²)
  feature match: l_feat = mean_{k,l} ‖D_k^l(x) - D_k^l(x̂)‖₁ / mean|D_k^l(x)|
  discriminator: l_d    = mean_k [mean(D_k(x̂)²) + mean((1 - D_k(x))²)]
plus plain time-domain L1/L2 terms (per batch item and scalar). The
discriminator is `models/msstftd.py`.

Every batch mean goes through `dp` (`ops.batch_reduce`): under a
data-parallel training step it is the global batch's; the per-item terms
stay the rank's own.
"""

from __future__ import annotations

import typing as tp

import torch

from ..ops.batch_reduce import LOCAL, BatchReduce


def total_loss(fmap_real, logits_fake, fmap_fake, input_wav: torch.Tensor,
               output_wav: torch.Tensor, dp: BatchReduce = LOCAL
               ) -> tp.Dict[str, torch.Tensor]:
    """Generator-side losses. Waveforms are `[B, T, C]` (any matching
    layout: the reductions are global or per item)."""
    reduce_dims = tuple(range(1, input_wav.dim()))
    diff = input_wav - output_wav
    l_t = diff.abs().mean(dim=reduce_dims)         # [B]
    l_t_2 = diff.square().mean(dim=reduce_dims)    # [B]
    l1 = dp.mean(diff.abs().mean())
    l2 = dp.mean(diff.square().mean())
    if fmap_real is not None:
        l_g = input_wav.new_zeros(())
        l_feat = input_wav.new_zeros(())
        for k in range(len(fmap_real)):
            l_g = l_g + dp.mean((1.0 - logits_fake[k]).square().mean())
            for j in range(len(fmap_real[k])):
                real = fmap_real[k][j].detach().float()
                fake = fmap_fake[k][j].float()
                l_feat = l_feat + (dp.mean((real - fake).abs().mean())
                                   / dp.mean(real.abs().mean()))
        l_feat = l_feat / (len(fmap_real) * len(fmap_real[0]))
        l_g = l_g / len(fmap_real)
    else:
        l_g = input_wav.new_zeros(())
        l_feat = input_wav.new_zeros(())
    return {"l_t": l_t, "l_t_2": l_t_2, "l_1": l1, "l_2": l2,
            "l_g": l_g, "l_feat": l_feat}


def disc_loss(logits_real, logits_fake, dp: BatchReduce = LOCAL
              ) -> torch.Tensor:
    """DAC-style LSGAN discriminator loss (ref losses.py:155-162)."""
    loss_d = 0.0
    for lr, lf in zip(logits_real, logits_fake):
        loss_d = loss_d + dp.mean(lf.square().mean()) \
            + dp.mean((1.0 - lr).square().mean())
    return loss_d / len(logits_real)
