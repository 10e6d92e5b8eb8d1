"""Multi-Scale STFT discriminator (the GAN critic of codec training).

Port of `encodec_tpu/models/msstftd.py`. Behavioral reference:
encodec/msstftd.py (DiscriminatorSTFT 28-96, MultiScaleSTFTDiscriminator
99-129): one sub-discriminator per STFT resolution turns the complex STFT
into 2C real channels (the real parts, then the imaginary parts) and runs a
Conv2d stack, dilated in time, with LeakyReLU(0.2), returning its logits
and five feature maps for the feature-matching loss.

Layout: NCHW `[B, 2C, time frames, freq bins]` (JAX: NHWC `[B, t, w, 2C]`),
so logits are `[B, out_ch, t, w]`; means over a map do not depend on the
layout. The convolutions are cuDNN's (`ops.conv2d`).

`msstftd_gan_sums_chunked` evaluates the GAN loss terms over time chunks
(a Python loop; each chunk's body under `torch.utils.checkpoint`, JAX's
`jax.checkpoint` inside its `lax.scan`), with exact halo handling, so the
activations held for the backward are one chunk's, whatever the signal's
length: the memory mechanism of `params/gan.yaml` (`disc_time_chunk`).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv2d import conv2d, conv2d_params_from_torch, init_conv2d
from ..ops.stft import spectrogram


def _get_2d_padding(kernel_size, dilation=(1, 1)):
    return (((kernel_size[0] - 1) * dilation[0]) // 2,
            ((kernel_size[1] - 1) * dilation[1]) // 2)


@dataclasses.dataclass(frozen=True)
class MSSTFTConfig:
    filters: int = 32
    in_channels: int = 1
    out_channels: int = 1
    n_ffts: tp.Tuple[int, ...] = (1024, 2048, 512)
    hop_lengths: tp.Tuple[int, ...] = (256, 512, 128)
    win_lengths: tp.Tuple[int, ...] = (1024, 2048, 512)
    max_filters: int = 1024
    filters_scale: int = 1
    kernel_size: tp.Tuple[int, int] = (3, 9)
    dilations: tp.Tuple[int, ...] = (1, 2, 4)
    stride: tp.Tuple[int, int] = (1, 2)
    normalized: bool = True
    norm: str = "weight_norm"
    leaky_slope: float = 0.2
    # "xla" or "taps": JAX's choice of weight-gradient lowering on the TPU;
    # accepted, and the same cuDNN conv here (ops/conv2d.py)
    conv_impl: str = "xla"
    # run the conv stack over time chunks of this many STFT frames (exact
    # values, O(chunk) activation memory); None = the whole-signal forward
    time_chunk: tp.Optional[int] = None

    @property
    def num_discriminators(self) -> int:
        return len(self.n_ffts)


def _sub_channel_plan(cfg: MSSTFTConfig):
    """(in, out, stride, dilation, padding, kernel, norm) per conv of one
    sub-discriminator; the first conv has no norm (as the reference builds
    it), the last is conv_post."""
    ks = cfg.kernel_size
    plan = [(2 * cfg.in_channels, cfg.filters, (1, 1), (1, 1),
             _get_2d_padding(ks), ks, "none")]
    in_chs = min(cfg.filters_scale * cfg.filters, cfg.max_filters)
    for i, dilation in enumerate(cfg.dilations):
        out_chs = min((cfg.filters_scale ** (i + 1)) * cfg.filters,
                      cfg.max_filters)
        plan.append((in_chs, out_chs, cfg.stride, (dilation, 1),
                     _get_2d_padding(ks, (dilation, 1)), ks, cfg.norm))
        in_chs = out_chs
    out_chs = min((cfg.filters_scale ** (len(cfg.dilations) + 1))
                  * cfg.filters, cfg.max_filters)
    sq = (ks[0], ks[0])
    plan.append((in_chs, out_chs, (1, 1), (1, 1), _get_2d_padding(sq), sq,
                 cfg.norm))
    plan.append((out_chs, cfg.out_channels, (1, 1), (1, 1),
                 _get_2d_padding(sq), sq, cfg.norm))
    return plan


def init_msstftd(generator: torch.Generator, cfg: MSSTFTConfig,
                 device: torch.device = torch.device("cpu")) -> dict:
    return {"discs": [
        {"convs": [init_conv2d(generator, cin, cout, k, norm=norm,
                               device=device)
                   for (cin, cout, _s, _d, _p, k, norm)
                   in _sub_channel_plan(cfg)]}
        for _ in range(cfg.num_discriminators)]}


def _spec(x: torch.Tensor, cfg: MSSTFTConfig, i: int) -> torch.Tensor:
    """Audio `[B, T, C]` → `[B, 2C, frames, bins]`: real parts, then
    imaginary parts, of resolution `i`'s normalized STFT."""
    sp = spectrogram(x.transpose(1, 2), cfg.n_ffts[i], cfg.hop_lengths[i],
                     cfg.win_lengths[i], normalized=cfg.normalized)
    return torch.cat([sp.real, sp.imag], dim=1).transpose(2, 3).contiguous()


def msstftd_sub_forward(sub_params: dict, x: torch.Tensor,
                        cfg: MSSTFTConfig, i: int,
                        compute_dtype: torch.dtype = torch.float32):
    """One sub-discriminator: audio `[B, T, C]` → (logits `[B, out, t, w]`,
    five feature maps). The unit `disc_remat` recomputes in the backward.

    `compute_dtype` (bf16): the conv stack, hence the feature maps, in that
    dtype; the STFT stays float32 and the logits are returned in float32
    (JAX: `encodec_tpu/models/msstftd.py:104-125`)."""
    z = _spec(x, cfg, i).to(compute_dtype)
    fmap = []
    plan = _sub_channel_plan(cfg)
    for p, (_cin, _cout, stride, dil, pad, _k, _n) in zip(
            sub_params["convs"][:-1], plan[:-1]):
        z = F.leaky_relu(conv2d(p, z, stride=stride, dilation=dil,
                                padding=pad, impl=cfg.conv_impl),
                         cfg.leaky_slope)
        fmap.append(z)
    (_cin, _cout, stride, dil, pad, _k, _n) = plan[-1]
    z = conv2d(sub_params["convs"][-1], z, stride=stride, dilation=dil,
               padding=pad, impl=cfg.conv_impl)
    return z.float(), fmap


def msstftd_forward(params: dict, x: torch.Tensor, cfg: MSSTFTConfig,
                    compute_dtype: torch.dtype = torch.float32):
    """Audio `[B, T, C]` → (logits list, feature maps list of lists)."""
    logits, fmaps = [], []
    for i, sub in enumerate(params["discs"]):
        logit, fmap = msstftd_sub_forward(sub, x, cfg, i, compute_dtype)
        logits.append(logit)
        fmaps.append(fmap)
    return logits, fmaps


def msstftd_num_fmaps(cfg: MSSTFTConfig) -> int:
    """Feature maps per sub-discriminator (every conv but conv_post)."""
    return len(_sub_channel_plan(cfg)) - 1


# ---------------------------------------------------------------------------
# Chunked-time evaluation: exact GAN loss sums with O(chunk) memory
# ---------------------------------------------------------------------------

def sub_time_halo(cfg: MSSTFTConfig) -> int:
    """Total one-sided time padding of one sub-discriminator's stack."""
    return sum(pad[0] for (_c, _o, _s, _d, pad, _k, _n)
               in _sub_channel_plan(cfg))


def _mask_rows(a: torch.Tensor, off: int, T: int) -> torch.Tensor:
    """Zero the time rows of `a` (`[B, C, L, W]`, first row at absolute
    frame `off`) that fall outside `[0, T)`."""
    lo, hi = max(0, -off), min(a.shape[2], T - off)
    if lo == 0 and hi >= a.shape[2]:
        return a
    t = torch.arange(a.shape[2], device=a.device)
    valid = ((t >= lo) & (t < hi)).to(a.dtype)
    return a * valid[None, None, :, None]


def _sub_stack_valid(sub_params: dict, z: torch.Tensor, cfg: MSSTFTConfig,
                     off: int, T: int):
    """One sub-discriminator's conv stack on a haloed time slice `z`
    (`[B, 2C, L, W]`, first row at absolute frame `off`), VALID in time
    (frequency padding unchanged), with the rows outside the signal
    `[0, T)` zeroed after every layer: the whole-signal forward pads time
    with zeros at each layer, so every surviving row equals its value
    exactly. Returns (logits, [(feature map, rows of halo consumed)])."""
    plan = _sub_channel_plan(cfg)
    fmap = []
    shrink = 0
    for p, (_cin, _cout, stride, dil, pad, _k, _n) in zip(
            sub_params["convs"][:-1], plan[:-1]):
        z = conv2d(p, z, stride=stride, dilation=dil, padding=(0, pad[1]),
                   impl=cfg.conv_impl)
        shrink += pad[0]
        z = _mask_rows(F.leaky_relu(z, cfg.leaky_slope), off + shrink, T)
        fmap.append((z, shrink))
    (_cin, _cout, stride, dil, pad, _k, _n) = plan[-1]
    z = conv2d(sub_params["convs"][-1], z, stride=stride, dilation=dil,
               padding=(0, pad[1]), impl=cfg.conv_impl)
    shrink += pad[0]
    return _mask_rows(z.float(), off + shrink, T), fmap


def _logit_width(cfg: MSSTFTConfig, i: int) -> int:
    """Frequency bins of sub-discriminator `i`'s logits."""
    w = cfg.n_ffts[i] // 2 + 1
    for (_c, _o, stride, dil, pad, k, _n) in _sub_channel_plan(cfg):
        w = (w + 2 * pad[1] - dil[1] * (k[1] - 1) - 1) // stride[1] + 1
    return w


def msstftd_gan_sums_chunked(sub_params: dict, x: torch.Tensor,
                             x_hat: tp.Optional[torch.Tensor],
                             cfg: MSSTFTConfig, i: int, *,
                             chunk: int,
                             shard: tp.Tuple[int, int] = (0, 1),
                             compute_dtype: torch.dtype = torch.float32
                             ) -> dict:
    """GAN loss sums of sub-discriminator `i` over `x` (real) and `x_hat`
    (fake, may be None), chunk by chunk over time; each chunk's body runs
    under `torch.utils.checkpoint` (recomputed in the backward), so the
    activations held are one chunk's. Values equal the whole-signal
    forward's up to summation order (tested); sums are float32, added in
    chunk order, the last chunk ragged.

    `shard = (index, count)`: only block `index` of `count` contiguous,
    near-equal blocks of the chunks (every block non-empty: fewer chunks
    than blocks is a `ValueError`); the blocks' sums add up to the whole
    signal's. `n_logit` is the whole signal's count.

    Returns: lg_fake = Σ(1 - D(x̂))², sq_fake = ΣD(x̂)², lg_real =
    Σ(1 - D(x))², sum_fake / sum_real = ΣD, all over the valid logits;
    n_logit = their count; feat_diff[l] = Σ|D_l(x) - D_l(x̂)| (the real map
    detached), feat_real[l] = Σ|D_l(x)|.

    `compute_dtype` (bf16): the conv stacks in that dtype, the STFT and
    every sum in float32 (JAX: `encodec_tpu/models/msstftd.py:240-250`)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    H = sub_time_halo(cfg)
    z_real = _spec(x, cfg, i).to(compute_dtype)
    z_fake = (_spec(x_hat, cfg, i).to(compute_dtype)
              if x_hat is not None else None)
    B, _, T, _ = z_real.shape
    n_chunks = -(-T // chunk)
    index, count = shard
    if n_chunks < count:
        raise ValueError(
            f"sub-discriminator {i}: {n_chunks} time chunks of {chunk} "
            f"frames cannot be shared by {count} ranks; use a smaller "
            "disc_time_chunk or fewer sequence shards")

    def pad_t(z):
        return F.pad(z, (0, 0, H, H + n_chunks * chunk - T))

    z_real = pad_t(z_real)
    z_fake = pad_t(z_fake) if z_fake is not None else None

    def body(zr, zf, s):
        rows = min(chunk, T - s)       # valid logit rows of this chunk
        logits_r, fmap_r = _sub_stack_valid(sub_params, zr, cfg, s - H, T)
        out = [(1.0 - logits_r[:, :, :rows]).square().sum(), logits_r.sum()]
        if zf is not None:
            logits_f, fmap_f = _sub_stack_valid(sub_params, zf, cfg, s - H,
                                                T)
            fd, fr = [], []
            for (ar, sh), (af, _) in zip(fmap_r, fmap_f):
                # feature maps in float32 before the difference, as the
                # other GAN routes take them
                real = ar[:, :, H - sh:H - sh + chunk].detach().float()
                fake = af[:, :, H - sh:H - sh + chunk].float()
                fd.append((real - fake).abs().sum())
                fr.append(real.abs().sum())
            out += [(1.0 - logits_f[:, :, :rows]).square().sum(),
                    logits_f.square().sum(), logits_f.sum(),
                    torch.stack(fd), torch.stack(fr)]
        return tuple(out)

    names = ("lg_real", "sum_real") + (
        ("lg_fake", "sq_fake", "sum_fake", "feat_diff", "feat_real")
        if z_fake is not None else ())
    sums: dict = {}
    for c in range(n_chunks * index // count,
                   n_chunks * (index + 1) // count):
        s = c * chunk
        zr = z_real[:, :, s:s + chunk + 2 * H]
        zf = None if z_fake is None else z_fake[:, :, s:s + chunk + 2 * H]
        part = checkpoint(body, zr, zf, s, use_reentrant=False)
        for name, v in zip(names, part):
            sums[name] = v if name not in sums else sums[name] + v
    n_logit = T * B * cfg.out_channels * _logit_width(cfg, i)
    sums["n_logit"] = torch.tensor(float(n_logit), device=z_real.device)
    return sums


def msstftd_params_from_torch(state, cfg: MSSTFTConfig,
                              root: str = "discriminators.") -> dict:
    """A reference MultiScaleSTFTDiscriminator state dict
    (`{root}{i}.convs.{j}.conv.weight_g/_v`, `…conv_post.conv.…`) → the
    port's parameter tree (float32, on the CPU)."""
    n_convs = len(_sub_channel_plan(cfg)) - 1
    return {"discs": [
        {"convs": [conv2d_params_from_torch(state, f"{root}{i}.convs.{j}.")
                   for j in range(n_convs)]
         + [conv2d_params_from_torch(state, f"{root}{i}.conv_post.")]}
        for i in range(cfg.num_discriminators)]}
