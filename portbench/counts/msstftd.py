"""Operation counts of the multi-scale STFT discriminator from its shapes
(EnCodec §3.3; `reference/msstftd.py` for the layers): each sub-
discriminator's image is `frames` = (T − n_fft) / hop + 1 STFT frames of
n_fft / 2 + 1 bins, and its convs keep the frames and halve the bins at
each stride. FLOPs are 2·Cin·Cout·kh·kw per output."""

from __future__ import annotations

import typing as tp

from . import seanet

KERNELS = [(3, 9), (3, 9), (3, 9), (3, 9), (3, 3), (3, 3)]
STRIDES = [1, 2, 2, 2, 1, 1]
PADS = [4, 4, 4, 4, 1, 1]


def sub_convs(model: dict, i: int, length: int
              ) -> tp.List[tp.Tuple[int, int, int, int, int]]:
    """(cin, cout, kh·kw, frames, bins out) of each conv of sub `i`."""
    n_fft, hop = model["disc_n_ffts"][i], model["disc_hop_lengths"][i]
    frames = (length - n_fft) // hop + 1
    width = n_fft // 2 + 1
    f, c = model["filters"], model["channels"]
    chans = [(2 * c, f)] + [(f, f)] * 4 + [(f, 1)]
    out = []
    for (cin, cout), (kh, kw), s, p in zip(chans, KERNELS, STRIDES, PADS):
        width = (width + 2 * p - kw) // s + 1
        out.append((cin, cout, kh * kw, frames, width))
    return out


def forward_flops(model: dict, batch: int, length: int) -> tp.Tuple[
        float, float]:
    """(all convs, first convs) forward FLOPs of every sub on `batch`
    signals, and the STFTs' (2.5·n·log2 n a frame)."""
    total = first = 0.0
    for i in range(len(model["disc_n_ffts"])):
        convs = sub_convs(model, i, length)
        flops = [2.0 * ci * co * k * t * w * batch
                 for ci, co, k, t, w in convs]
        total += sum(flops)
        first += flops[0]
        n_fft = model["disc_n_ffts"][i]
        total += seanet.stft_flops(convs[0][3], n_fft, batch)
    return total, first


def gan_gen_flops(model: dict, batch: int, length: int) -> float:
    """The GAN terms of a generator step: the real signal forward (no
    graph), the reconstruction forward and its input gradient (the chunked
    route's recomputed forward not counted)."""
    fwd, _ = forward_flops(model, batch, length)
    return 3 * fwd


def disc_flops(model: dict, batch: int, length: int) -> float:
    """A discriminator step's discriminator: both signals forward, and
    backward to the weights and to every input but the images'."""
    fwd, first = forward_flops(model, batch, length)
    return 2 * fwd + 2 * (2 * fwd - first)
