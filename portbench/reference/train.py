"""The plain training step of the breathing tokenizer (the fork's
`train.py` generator step), float32 PyTorch, from the configuration alone.

Generator loss (the fork's weights, `loss:` in the experiment YAML):
    w_l1·mean|x − x̂| + w_freq·spectral + w_l2·mean(x − x̂)²
    + (w_commit + w_codebook)·mean_k commit_k
with w_commit and w_codebook 0 before `commit_start_epoch` and 1 (the
codebook weight) from it. The spectral loss is the breathing spectrogram
loss: log10 power of an STFT (Hann window of 30 s, hop 5 s, `n_fft`
points, the signal reflect-padded by (n_fft − hop)/2 each side, divided by
the window's sum), mean |S − Ŝ| + alpha·mean (S − Ŝ)², uniformly weighted
(`bandwidth: null`). The optimizer is optax's chain of a clip of the
global norm at 0.1 and Adam(b1 0.8, b2 0.9, eps 1e-8) with the epoch's
learning rate from a linear warm-up and a cosine decay; bias corrections
in float32.

The GAN phase (EnCodec §3.3, `reference/msstftd.py`): the generator step
adds w_g·l_g + w_feat·l_feat; the discriminator step runs the generator
forward with its draws but keeps neither its graph nor its book update,
and takes the discriminator's own clipped Adam step at `disc_lr`.

`Step` holds the state the reference carries from step to step: the
parameter leaves by path (the generator's and the discriminator's), the
book, each optimizer's moments and count, and the CPU generator of the
quantizer's draws.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from . import msstftd, rvq, seanet

B1, B2, EPS = 0.8, 0.9, 1e-8
# the discriminator's terms one row at a time, so that one row's
# activations are held and a GAN batch fits beside what the run holds
DISC_ROWS = 1


def f32(v: float) -> float:
    """`v` rounded to float32, as the trainer holds its hyperparameters."""
    return torch.tensor(float(v), dtype=torch.float32).item()


def lr_at(e: int, base: float, warmup: int, max_epoch: int) -> float:
    """The learning rate at 0-based epoch index `e`."""
    if e < warmup:
        scale = (e + 1) / warmup
    else:
        scale = 0.5 * (1 + math.cos(math.pi * (e - warmup)
                                    / (max_epoch - warmup)))
    return base * scale


def weights_at(cfg: dict, epoch: int) -> dict:
    """The loss weights and learning rates of an epoch."""
    loss, opt = cfg["loss"], cfg["optimization"]
    warm, max_epoch = cfg["lr_scheduler"]["warmup_epoch"], \
        cfg["common"]["max_epoch"]
    on = epoch >= loss.get("commit_start_epoch", 0)
    start = cfg["model"].get("train_discriminator_start_epoch", 0)
    return {k: f32(v) for k, v in dict(
        l1=loss["weight_l1"], l2=loss["weight_l2"], freq=loss["weight_freq"],
        commit=loss["weight_commit"] if on else 0.0,
        codebook=1.0 if on else 0.0,
        gen=loss["weight_g"], feat=loss["weight_feat"],
        lr=lr_at(epoch - 1, float(opt["lr"]), warm, max_epoch),
        disc_lr=lr_at(max(0, epoch - 1 - start), float(opt["disc_lr"]),
                      warm, max_epoch - start)).items()}


def spectrogram(s: torch.Tensor, n_fft: int, hop: int, win: int
                ) -> torch.Tensor:
    """log10 power spectrogram of `[B, T]`."""
    p = (n_fft - hop) // 2
    s = F.pad(s[:, None], (p, p), mode="reflect")[:, 0]
    window = torch.hann_window(win, periodic=True, dtype=s.dtype,
                               device=s.device)
    spec = torch.stft(s, n_fft, hop, win, window=window, center=False,
                      return_complex=True) / window.sum()
    power = spec.real.square() + spec.imag.square()
    return torch.log10(power.clamp(min=1e-5))


def spectral_loss(x: torch.Tensor, x_hat: torch.Tensor, cfg: dict
                  ) -> torch.Tensor:
    loss, sr = cfg["loss"], cfg["model"]["sample_rate"]
    n_fft = loss["n_fft"]
    hop = loss.get("hop_length") or 5 * sr
    win = loss.get("win_length") or 30 * sr
    a = spectrogram(x, n_fft, hop, win)
    b = spectrogram(x_hat, n_fft, hop, win)
    return (a - b).abs().mean() + loss["alpha"] * (a - b).square().mean()


def paths(tree, prefix: str = "") -> tp.Dict[str, torch.Tensor]:
    """The tensor leaves of a tree by dotted path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(paths(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def rebuild(tree, leaves: tp.Dict[str, torch.Tensor], prefix: str = ""):
    """`tree`'s structure with the leaves of `leaves`."""
    if isinstance(tree, dict):
        return {k: rebuild(v, leaves, f"{prefix}{k}.") for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, leaves, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]


class Step:
    """The reference's training state and its generator step."""

    def __init__(self, params: dict, cfg: dict, arch: dict,
                 generator: torch.Generator, remat: bool = True,
                 disc: tp.Optional[dict] = None,
                 books: tp.Optional[rvq.Books] = None,
                 frozen: bool = False):
        if books is None:
            raise ValueError("the reference starts from a drawn book")
        self.tree = params
        self.leaves = {k: v.detach().clone()
                       for k, v in paths(params).items()}
        self.opt = Adam(self.leaves)
        self.disc_tree = disc
        self.disc_leaves = ({k: v.detach().clone()
                             for k, v in paths(disc).items()}
                            if disc is not None else {})
        self.disc_opt = Adam(self.disc_leaves)
        self.books = books
        self.cfg, self.arch, self.generator = cfg, arch, generator
        self.remat = remat
        # a step that returns its state unchanged (a fault the check must
        # catch): no update of the weights or of the book
        self.frozen = frozen
        # the widest gap of the codes forced on each generator forward so
        # far, and the codes of the last ([B, K, T'], on the CPU)
        self.code_gaps: tp.List[float] = []
        self.codes: tp.Optional[torch.Tensor] = None

    def forward(self, leaves, x: torch.Tensor,
                forced: tp.Optional[torch.Tensor] = None):
        """x̂ `[B, T, C]`, commit losses and the new book from `x`, with the
        codes `forced` ([B, K, T']) where given."""
        p = rebuild(self.tree, leaves)
        z = seanet.encoder(p["encoder"], x.transpose(1, 2), self.arch,
                           self.remat)
        wrong = forced is not None and tuple(forced.shape) != (
            z.shape[0], self.arch["n_q"], z.shape[1])
        if forced is not None and not wrong:
            forced = forced.transpose(0, 1).reshape(forced.shape[1], -1)
        q, codes, commits, books, gap = rvq.train_forward(
            self.books, z, self.arch, self.generator,
            forced=None if wrong else forced)
        # codes of another shape than the batch's are no answer: a full gap
        self.code_gaps.append(1.0 if wrong else gap)
        self.codes = codes.reshape(codes.shape[0], x.shape[0], -1
                                   ).transpose(0, 1).cpu()
        y = seanet.decoder(p["decoder"], q, self.arch, self.remat)
        return y[..., :x.shape[1]].transpose(1, 2), commits, books

    def gen_step(self, x: torch.Tensor, w: dict, gan: bool = False,
                 forced: tp.Optional[torch.Tensor] = None
                 ) -> tp.Tuple[float, dict]:
        """One generator step on `x` [B, T, C] (with the GAN terms when
        `gan`, the codes `forced` where given): returns the loss and the
        clipped gradient by path (as Adam takes it)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.leaves.items()}
        with torch.enable_grad():
            x_hat, commits, books = self.forward(leaves, x, forced)
            cm = commits.mean()
            loss = (w["l1"] * (x - x_hat).abs().mean()
                    + w["freq"] * spectral_loss(x[..., 0], x_hat[..., 0],
                                                self.cfg)
                    + w["l2"] * (x - x_hat).square().mean()
                    + (w["commit"] + w["codebook"]) * cm)
            outputs, cotangents = [loss], [torch.ones_like(loss)]
            value = loss.item()
            if gan:
                disc = rebuild(self.disc_tree, self.disc_leaves)
                l_g, l_feat, d_xhat = msstftd.gen_terms_grad(
                    disc, x.transpose(1, 2), x_hat.detach().transpose(1, 2),
                    self.cfg["model"], w["gen"], w["feat"], DISC_ROWS)
                outputs.append(x_hat)
                cotangents.append(d_xhat.transpose(1, 2))
                value += w["gen"] * l_g + w["feat"] * l_feat
            names = list(leaves)
            grads = torch.autograd.grad(outputs, [leaves[k] for k in names],
                                        cotangents, allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if not self.frozen:
            self.books = rvq.Books(*(t.detach() for t in books))
        clipped = self.opt.step(self.leaves, grads,
                                0.0 if self.frozen else w["lr"])
        return value, clipped

    def disc_step(self, x: torch.Tensor, w: dict) -> tp.Tuple[float, dict]:
        """One discriminator step on `x`: returns its loss and its clipped
        gradient by path. The generator's forward draws as the trainer's
        does and its book update is dropped."""
        with torch.no_grad():
            x_hat, _, _ = self.forward(self.leaves, x)
        loss, grads = msstftd.disc_loss_grad(
            self.disc_leaves, self.disc_tree, x.transpose(1, 2),
            x_hat.transpose(1, 2), self.cfg["model"], DISC_ROWS, rebuild)
        clipped = self.disc_opt.step(self.disc_leaves, grads,
                                     0.0 if self.frozen else w["disc_lr"])
        return loss, clipped


class Adam:
    """optax's clip of the global norm at 0.1 and Adam, on leaves by
    path."""

    def __init__(self, leaves: dict):
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    def step(self, leaves: dict, grads: dict, lr: float) -> dict:
        """Update `leaves` in place (new tensors); return the clipped
        gradient."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.where(norm < 0.1, torch.ones_like(norm), 0.1 / norm)
        clipped = {k: g * scale for k, g in grads.items()}
        self.count += 1
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** self.count
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** self.count
        bc1, bc2 = bc1.item(), bc2.item()
        for k, g in clipped.items():
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g.square() + B2 * self.nu[k]
            leaves[k] = leaves[k] - f32(lr) * (
                (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + EPS))
        return clipped
