"""The plain codec, to judge the codes and the audio a program served.

`judge` runs the plain encoder on the served clips, walks the served codes
stage by stage against its own latents (`rvq.teacher_forced_gap`), decodes
the served codes with the plain decoder and compares that audio with the
served audio. It never takes anything the program made but the codes and
the audio it is judging. It first holds the served codes to the shape
the traffic asks for (the batch, the stages of its bandwidth, the clips'
frames) and the served audio to the clips' length: a program that served
fewer stages or shorter audio has served another answer, and reads a
full gap of 1.
"""

from __future__ import annotations

import math

import torch

from . import rvq, seanet


@torch.no_grad()
def latents(params: dict, x: torch.Tensor, arch: dict) -> torch.Tensor:
    """Latents `[B, T', D]` of audio `[B, C, T]`."""
    return seanet.encoder(params["encoder"], x, arch)


def stages(arch: dict, bandwidth_kbps: float) -> int:
    """The stages served at a bandwidth: log2(bins) bits per code per
    frame."""
    bits = math.log2(arch["bins"]) * arch["frame_rate"]
    return int(1000 * bandwidth_kbps // bits)


@torch.no_grad()
def judge(params: dict, books: torch.Tensor, arch: dict, x: torch.Tensor,
          n_q: int, codes: torch.Tensor, audio: torch.Tensor) -> dict:
    """Readings of one served batch. Of the codes, by their teacher-forced
    distance gaps (relative to the latents' mean squared norm; 0 where a
    served code is the nearest): `code_gap`, the widest; `code_mean_gap`,
    the mean over every position and stage; `code_flip_share`, the share
    of positions and stages whose served code is not the nearest. Of the
    audio, `audio_gap`: the largest |served − plain decode of the served
    codes| over the plain decode's peak, per clip, the worst clip. `x`
    [B, C, T] the clips, `n_q` the stages asked for, `codes` [B, n_q, T'],
    `audio` [B, C, ≥T]; codes of another shape read 1 in every number,
    shorter audio 1 in `audio_gap`."""
    z = latents(params, x, arch)
    if tuple(codes.shape) != (x.shape[0], n_q, z.shape[1]):
        return dict.fromkeys(("code_gap", "code_mean_gap", "code_flip_share",
                              "audio_gap"), 1.0)
    gaps = rvq.teacher_forced_gap(books, z, codes, arch["shared_codebook"])
    q = rvq.decode(books, codes, arch["shared_codebook"])
    y = seanet.decoder(params["decoder"], q, arch)
    got = {"code_gap": gaps.max().item(),
           "code_mean_gap": gaps.mean().item(),
           "code_flip_share": (gaps > 0).double().mean().item()}
    if audio.shape[:2] != x.shape[:2] or audio.shape[-1] < x.shape[-1]:
        return dict(got, audio_gap=1.0)
    n = min(y.shape[-1], audio.shape[-1])
    y, served = y[..., :n], audio[..., :n].float()
    err = (served - y).abs().flatten(1).amax(1)
    peak = y.abs().flatten(1).amax(1)
    return dict(got, audio_gap=(err / peak).max().item())
