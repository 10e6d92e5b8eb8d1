"""Sequence-parallel SEANet encode and decode: time sharded over a `seq` axis.

Port of `encodec_tpu/parallel/sp.py` (`seanet_encode_sp`, `encode_sp`,
`seanet_decode_sp`, `decode_sp`), and the training forward's sharded
trunks (`seanet_encode_seq`, `seanet_decode_seq`, on a process group; the
inference functions are those under `torch.no_grad()`), with the checks
of what can be sharded (`check_seq_parallel`). Causal convolutions admit
exact time sharding: each conv layer needs only `effective_kernel -
stride` samples of left context, which the previous rank sends
(`comm.halo`, one small exchange per layer) while every rank computes its
shard; rank 0
primes its context with the reflect padding the batch forward applies at
the signal start (`ops.streaming.prime_conv_stream`). The LSTM runs at the
token rate (hop-times fewer steps), so after the sharded conv trunk the
`[B, T/hop, C]` features are all-gathered and the LSTM (K3 on the card)
and the final conv run replicated. The decoder mirrors it: the token-rate
head (init conv + LSTM) replicated, then each rank upsamples its slice of
the tokens, a transposed conv's `kernel - stride` overlap tail going to
the next rank like the streaming decoder's carry (`comm.tail_handoff`).
Each exchange and gather is differentiable: its backward sends the
cotangent back to the rank the data came from (`comm`'s convention: a
replicated tensor's cotangent is this rank's share), so the training
step's backward runs through the same code.

JAX's version is bit-exact on XLA. Here cuDNN (or oneDNN on the CPU) may
pick another algorithm for a shard's length than for the whole signal, so
the latents and audio agree to float rounding and the codes outside the
searches' tie flags. Inputs are the whole signal (or latents) on every
rank; each rank takes its shard; the outputs are whole on every rank.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .. import ops
from ..models.seanet import (SEANetConfig, _act, _resblock_dims,
                             resolve_activation)
from ..ops.conv import _apply_norm, conv_weights
from ..ops.streaming import prime_conv_stream, sconv1d_stream
from . import comm


def _context(y: torch.Tensor, ctx: int, k: int, s: int, d: int,
             group, cfg: SEANetConfig) -> torch.Tensor:
    """Left context of this shard: the previous shard's tail; on the first
    shard the batch-start padding of its own head (differentiable: the
    halo's cotangent goes back to the previous shard)."""
    if ctx == 0:
        return y[:, :0]
    if y.shape[1] < ctx:
        raise ValueError(
            f"sequence-parallel shard too short: per-shard length "
            f"{y.shape[1]} < receptive context {ctx} of a conv layer "
            f"(kernel {k}, stride {s}, dilation {d}). Use fewer shards or "
            f"a longer signal (analogous to streaming.min_first_chunk).")
    prime = (prime_conv_stream(y, k, s, d, pad_mode=cfg.pad_mode)
             if comm.rank(group) == 0 else None)
    return comm.halo(y[:, y.shape[1] - ctx:], prime, group)


def _sp_conv(p, y, *, k: int, s: int = 1, d: int = 1, cfg: SEANetConfig,
             group, norm: tp.Optional[str] = None) -> torch.Tensor:
    ctx = (k - 1) * d + 1 - s
    state = _context(y, ctx, k, s, d, group, cfg)
    out, _ = sconv1d_stream(p, y, state, kernel_size=k, stride=s, dilation=d,
                            norm=cfg.norm if norm is None else norm)
    return out


def _sp_resblock(p, x, cfg: SEANetConfig, dilations, group) -> torch.Tensor:
    ks, _ = _resblock_dims(cfg, x.shape[-1])
    y = x
    for conv_p, k, d in zip(p["convs"], ks, dilations):
        y = _act(y, cfg.activation_alpha)
        y = _sp_conv(conv_p, y, k=k, d=d, cfg=cfg, group=group)
    if "shortcut" in p:
        sc = _sp_conv(p["shortcut"], x, k=1, cfg=cfg, group=group)
    else:
        sc = x
    return sc + y


def _shard(x: torch.Tensor, group, multiple: int,
           unit: str = "") -> torch.Tensor:
    """This rank's equal slice of the time axis (dim 1), whose length must
    be a multiple of `multiple` per rank (`unit` names it in the error)."""
    n, r = comm.world(group), comm.rank(group)
    if x.shape[1] % (n * multiple):
        raise ValueError(f"length {x.shape[1]} is not a multiple of "
                         f"{n} shards x {unit}{multiple}")
    per = x.shape[1] // n
    return x[:, r * per:(r + 1) * per]


def _check_causal(sn: SEANetConfig, what: str) -> None:
    if not (sn.causal and sn.trim_right_ratio == 1.0):
        raise ValueError(f"{what} requires a causal model with "
                         "trim_right_ratio 1")


def check_seq_parallel(cfg, shards: int) -> None:
    """Raise `ValueError` where training cannot shard time over `shards`
    ranks exactly (`cfg` an `EncodecConfig` or a `SEANetConfig`): a
    non-causal model (its convs read right context) or a decoder whose
    transposed convs trim on the left, time group norm and a normalized
    model (statistics over the whole time axis), and stage remat (its
    recomputed region would hold the halo collectives). The length is
    checked at each step (`seanet_encode_seq`)."""
    sn = getattr(cfg, "seanet", cfg)
    what = f"sequence parallelism over {shards} shards"
    _check_causal(sn, what)
    if sn.norm == "time_group_norm":
        raise ValueError(f"{what}: time_group_norm normalizes over the "
                         "whole time axis")
    if getattr(cfg, "normalize", False):
        raise ValueError(f"{what}: audio_normalize scales each item by its "
                         "RMS over the whole time axis")
    if sn.remat:
        raise ValueError(f"{what}: model.remat recomputes whole stages in "
                         "the backward, and a stage's halo exchanges would "
                         "run again there; train without remat (shards "
                         "already hold 1/shards of the activations)")


def seanet_encode_seq(params, x: torch.Tensor, cfg: SEANetConfig, group, *,
                      plain: bool = False) -> torch.Tensor:
    """The encoder with time sharded over `group`: x `[B, T, C]` (whole,
    on every rank; `T % (shards * hop) == 0`) → latents `[B, T/hop,
    dimension]`, whole on every rank. Differentiable: the halos and the
    gather carry their cotangents back to the shards that sent them. The
    caller has checked `cfg` (`check_seq_parallel`, or the causal check
    of `seanet_encode_sp`). `plain=True` runs the LSTM's plain twin."""
    y = _sp_conv(params["init_conv"],
                 _shard(x, group, cfg.hop_length, "hop "),
                 k=cfg.kernel_size, cfg=cfg, group=group)
    for stage, ratio in zip(params["stages"], cfg.encoder_ratios):
        for j, res_p in enumerate(stage["res"]):
            y = _sp_resblock(res_p, y, cfg, [cfg.dilation_base ** j, 1],
                             group)
        y = _act(y, cfg.activation_alpha)
        y = _sp_conv(stage["down"], y, k=ratio * 2, s=ratio, cfg=cfg,
                     group=group)
    # the token-rate tail: gathered, then replicated
    y = comm.gather_time(y, group, dim=1)
    if cfg.lstm:
        y = ops.lstm(params["lstm"], y, skip=True, plain=plain)
    y = _act(y, cfg.activation_alpha)
    return ops.sconv1d(params["final_conv"], y,
                       kernel_size=cfg.last_kernel_size, causal=True,
                       norm=cfg.norm, pad_mode=cfg.pad_mode)


@torch.no_grad()
def seanet_encode_sp(params, x: torch.Tensor, cfg: SEANetConfig, mesh, *,
                     axis_name: str = "seq",
                     plain: bool = False) -> torch.Tensor:
    """Sequence-parallel `seanet_encoder`: x `[B, T, C]` with `T % (shards
    * hop) == 0` → latents `[B, T/hop, dimension]` on every rank.
    `plain=True` runs the LSTM's plain twin."""
    _check_causal(cfg, "sequence parallelism")
    return seanet_encode_seq(params, x, cfg, mesh.get_group(axis_name),
                             plain=plain)


def encode_sp(params, qstate, x: torch.Tensor, cfg, mesh, *,
              n_q: tp.Optional[int] = None, axis_name: str = "seq",
              plain: bool = False) -> torch.Tensor:
    """Sequence-parallel encode: audio `[B, T, C]` → codes `[B, K, T/hop]`
    (the RVQ is K2, replicated)."""
    from ..quant import rvq_encode
    emb = seanet_encode_sp(params["encoder"], x, cfg.seanet, mesh,
                           axis_name=axis_name, plain=plain)
    codes = rvq_encode(qstate, emb, cfg.rvq, n_q=min(n_q or cfg.rvq.n_q,
                                                     cfg.rvq.n_q),
                       plain=plain)
    return codes.permute(1, 0, 2)


def _sp_convtr(p, y, *, k: int, s: int, cfg: SEANetConfig,
               group) -> torch.Tensor:
    """Causal transposed conv with its overlap tail sent to the next rank:
    each shard computes its whole bias-free output; the `k - s` samples
    past its end belong to the next shard's head (rank 0 receives nothing:
    the stream-start state)."""
    w, b = conv_weights(p, y, transposed=True)
    full = F.conv_transpose1d(y.transpose(1, 2), w, None, stride=s)
    L_out = y.shape[1] * s
    pt = k - s
    out = full[:, :, :L_out]
    if pt > 0:
        out = comm.tail_handoff(out, full[:, :, L_out:L_out + pt], group)
    if b is not None:
        out = out + b[:, None]
    return _apply_norm(out, p, cfg.norm).transpose(1, 2)


def seanet_decode_seq(params, z: torch.Tensor, cfg: SEANetConfig, group, *,
                      plain: bool = False) -> torch.Tensor:
    """The decoder with time sharded over `group`, for causal models with
    `trim_right_ratio == 1`: z `[B, Tz, D]` (whole on every rank; `Tz %
    shards == 0`) → audio `[B, Tz*hop, C]`, whole on every rank. The
    token-rate head (init conv + LSTM) runs replicated, then each rank
    upsamples its slice of the tokens. Differentiable. The caller has
    checked `cfg`, as for `seanet_encode_seq`."""
    y = ops.sconv1d(params["init_conv"], z, kernel_size=cfg.kernel_size,
                    causal=True, norm=cfg.norm, pad_mode=cfg.pad_mode)
    if cfg.lstm:
        y = ops.lstm(params["lstm"], y, skip=True, plain=plain)
    y = _shard(y, group, 1)
    for stage, ratio in zip(params["stages"], cfg.ratios):
        y = _act(y, cfg.activation_alpha)
        y = _sp_convtr(stage["up"], y, k=ratio * 2, s=ratio, cfg=cfg,
                       group=group)
        for j, res_p in enumerate(stage["res"]):
            y = _sp_resblock(res_p, y, cfg, [cfg.dilation_base ** j, 1],
                             group)
    y = _act(y, cfg.activation_alpha)
    y = _sp_conv(params["final_conv"], y, k=cfg.last_kernel_size, cfg=cfg,
                 group=group, norm=cfg.resolved_decoder_final_norm())
    if cfg.final_activation is not None:
        y = resolve_activation(cfg.final_activation)(y)
    return comm.gather_time(y, group, dim=1)


@torch.no_grad()
def seanet_decode_sp(params, z: torch.Tensor, cfg: SEANetConfig, mesh, *,
                     axis_name: str = "seq",
                     plain: bool = False) -> torch.Tensor:
    """Sequence-parallel `seanet_decoder` for causal models with
    `trim_right_ratio == 1`: z `[B, Tz, D]` with `Tz % shards == 0` →
    audio `[B, Tz*hop, C]` on every rank."""
    _check_causal(cfg, "sequence-parallel decoding")
    return seanet_decode_seq(params, z, cfg, mesh.get_group(axis_name),
                             plain=plain)


def decode_sp(params, qstate, codes: torch.Tensor, cfg, mesh, *,
              axis_name: str = "seq", plain: bool = False) -> torch.Tensor:
    """Sequence-parallel decode: codes `[B, K, Tz]` → audio
    `[B, Tz*hop, C]`."""
    from ..quant import rvq_decode
    emb = rvq_decode(qstate, codes.permute(1, 0, 2), cfg.rvq)
    return seanet_decode_sp(params["decoder"], emb, cfg.seanet, mesh,
                            axis_name=axis_name, plain=plain)
