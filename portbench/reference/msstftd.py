"""The plain multi-scale STFT discriminator (EnCodec §3.3) and its GAN
terms, float32 PyTorch, whole signal at a time.

One sub-discriminator per STFT resolution (`n_fft`, `hop`, `win` from the
experiment YAML's `disc_*` lists): the STFT of each channel (a periodic
Hann window of `win` points centered in `n_fft`, no centering of the
signal, divided by the window's L2 norm), its real parts then its
imaginary parts as 2C channels of a `[B, 2C, frames, bins]` image, and a
stack of 2-D convs: (2C → F, 3×9), then (F → F, 3×9, stride 2 in
frequency, time dilations 1, 2, 4), (F → F, 3×3), each with a
LeakyReLU(0.2) whose output is a feature map, and the logits' conv (F → 1,
3×3). Zero padding keeps the frames: (k − 1)·d / 2 in each axis. Every
conv but the first has weight norm.

It reads the benchmark's tree: `{"discs": [{"convs": [...]}]}`, each conv
`{"w"}` or `{"v", "g"}` with `"b"`. The GAN losses (EnCodec's, as the fork
weights them): the generator's l_g = mean over subs of mean (1 − D(x̂))²
and l_feat = mean over subs and maps of mean |D(x) − D(x̂)| / mean |D(x)|;
the discriminator's mean over subs of mean D(x̂)² + mean (1 − D(x))².
`block` rows at a time, so that the activations of one block are held:
every term is a sum over rows (l_feat's denominators come first, from the
real signal alone).
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .seanet import conv_weight


def plan(model: dict) -> tp.List[tuple]:
    """(stride, dilation, padding) of each conv of a sub-discriminator."""
    ks, sq = (3, 9), (3, 3)
    out = [((1, 1), (1, 1), (1, 4))]
    for d in (1, 2, 4):
        out.append(((1, 2), (d, 1), ((ks[0] - 1) * d // 2, 4)))
    out.append(((1, 1), (1, 1), (1, 1)))
    out.append(((1, 1), (1, 1), (1, 1)))
    return out


def spec(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """`[B, C, T]` → `[B, 2C, frames, bins]`."""
    B, C, T = x.shape
    window = torch.hann_window(win, periodic=True, dtype=x.dtype,
                               device=x.device)
    s = torch.stft(x.reshape(B * C, T), n_fft, hop, win, window=window,
                   center=False, return_complex=True)
    s = s / window.square().sum().sqrt()
    s = s.reshape(B, C, s.shape[-2], s.shape[-1])
    return torch.cat([s.real, s.imag], dim=1).transpose(2, 3)


def sub_forward(p: dict, z: torch.Tensor, model: dict):
    """(logits, feature maps) of one sub-discriminator on its image."""
    fmaps = []
    steps = plan(model)
    for conv, (stride, dil, pad) in zip(p["convs"][:-1], steps[:-1]):
        z = F.leaky_relu(F.conv2d(z, conv_weight(conv), conv["b"], stride,
                                  pad, dil), 0.2)
        fmaps.append(z)
    stride, dil, pad = steps[-1]
    conv = p["convs"][-1]
    return F.conv2d(z, conv_weight(conv), conv["b"], stride, pad,
                    dil), fmaps


def _images(x: torch.Tensor, model: dict) -> tp.List[torch.Tensor]:
    return [spec(x, n, h, w) for n, h, w in zip(
        model["disc_n_ffts"], model["disc_hop_lengths"],
        model["disc_win_lengths"])]


def gen_terms_grad(disc: dict, x: torch.Tensor, x_hat: torch.Tensor,
                   model: dict, w_g: float, w_feat: float, block: int
                   ) -> tp.Tuple[float, float, torch.Tensor]:
    """(l_g, l_feat, d(w_g·l_g + w_feat·l_feat)/d x̂) for audio `[B, C, T]`
    (`x_hat` detached here; its gradient is returned)."""
    subs = disc["discs"]
    B = x.shape[0]
    n_feat = len(subs) * (len(plan(model)) - 1)
    with torch.no_grad():
        real_abs = [torch.zeros(len(plan(model)) - 1, device=x.device)
                    for _ in subs]
        for r in range(0, B, block):
            for i, (sub, z) in enumerate(zip(subs, _images(x[r:r + block],
                                                           model))):
                _, fm = sub_forward(sub, z, model)
                real_abs[i] += torch.stack([f.abs().sum() for f in fm])
    grad = torch.zeros_like(x_hat)
    l_g = l_feat = 0.0
    for r in range(0, B, block):
        xb = x_hat[r:r + block].detach().requires_grad_(True)
        with torch.no_grad():
            real = [sub_forward(sub, z, model)[1] for sub, z in
                    zip(subs, _images(x[r:r + block], model))]
        with torch.enable_grad():
            lg = lf = 0.0
            for i, (sub, z) in enumerate(zip(subs, _images(xb, model))):
                logits, fm = sub_forward(sub, z, model)
                n_logit = logits[0].numel() * B
                lg = lg + (1.0 - logits).square().sum() / n_logit
                for j, (fr, ff) in enumerate(zip(real[i], fm)):
                    lf = lf + (fr - ff).abs().sum() / real_abs[i][j]
            lg, lf = lg / len(subs), lf / n_feat
            (g,) = torch.autograd.grad(w_g * lg + w_feat * lf, xb)
        grad[r:r + block] = g
        l_g += lg.item()
        l_feat += lf.item()
    return l_g, l_feat, grad


def disc_loss_grad(disc_leaves: dict, tree: dict, x: torch.Tensor,
                   x_hat: torch.Tensor, model: dict, block: int,
                   rebuild) -> tp.Tuple[float, dict]:
    """The discriminator's loss and its gradient by leaf path, block by
    block (`rebuild(tree, leaves)` puts the leaves in the tree)."""
    names = list(disc_leaves)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in disc_leaves.items()}
    disc = rebuild(tree, leaves)
    subs = disc["discs"]
    B = x.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = 0.0
    for r in range(0, B, block):
        with torch.enable_grad():
            loss = 0.0
            for sub, zr, zf in zip(subs, _images(x[r:r + block], model),
                                   _images(x_hat[r:r + block], model)):
                lr_, _ = sub_forward(sub, zr, model)
                lf_, _ = sub_forward(sub, zf, model)
                n_logit = lr_[0].numel() * B
                loss = loss + (lf_.square().sum()
                               + (1.0 - lr_).square().sum()) / n_logit
            loss = loss / len(subs)
            got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                      allow_unused=True)
        for k, g in zip(names, got):
            if g is not None:
                grads[k] += g
        total += loss.item()
    return total, grads
