"""Sequence-parallel SEANet encode and decode: time sharded over a `seq` axis.

Port of `encodec_tpu/parallel/sp.py` (`seanet_encode_sp`, `encode_sp`,
`seanet_decode_sp`, `decode_sp`). Causal convolutions admit exact time
sharding: each conv layer needs only `effective_kernel - stride` samples
of left context, which the previous rank sends (`comm.shift_right`, one
small exchange per layer) while every rank computes its shard; rank 0
primes its context with the reflect padding the batch forward applies at
the signal start (`ops.streaming.prime_conv_stream`). The LSTM runs at the
token rate (hop-times fewer steps), so after the sharded conv trunk the
`[B, T/hop, C]` features are all-gathered and the LSTM (K3 on the card)
and the final conv run replicated. The decoder mirrors it: the token-rate
head (init conv + LSTM) replicated, then each rank upsamples its slice of
the tokens, a transposed conv's `kernel - stride` overlap tail going to
the next rank like the streaming decoder's carry.

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
from ..ops.conv import _apply_norm, effective_weight
from ..ops.streaming import prime_conv_stream, sconv1d_stream
from . import comm


def _halo_or_prime(y: torch.Tensor, ctx: int, k: int, s: int, d: int,
                   group, cfg: SEANetConfig) -> torch.Tensor:
    """Left context of this shard: the previous shard's tail; on the first
    shard the batch-start padding of its own head."""
    if ctx == 0:
        return y[:, :0]
    if y.shape[1] < ctx:
        raise ValueError(
            f"sequence-parallel shard too short: per-shard length "
            f"{y.shape[1]} < receptive context {ctx} of a conv layer "
            f"(kernel {k}, stride {s}, dilation {d}). Use fewer shards or "
            f"a longer signal (analogous to streaming.min_first_chunk).")
    halo = comm.shift_right(y[:, y.shape[1] - ctx:].contiguous(), group)
    if halo is None:
        return prime_conv_stream(y, k, s, d, pad_mode=cfg.pad_mode)
    return halo


def _sp_conv(p, y, *, k: int, s: int = 1, d: int = 1, cfg: SEANetConfig,
             group, norm: tp.Optional[str] = None) -> torch.Tensor:
    ctx = (k - 1) * d + 1 - s
    state = _halo_or_prime(y, ctx, k, s, d, group, cfg)
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


def _shard(x: torch.Tensor, group, multiple: int) -> torch.Tensor:
    """This rank's equal slice of the time axis (dim 1), whose length must
    be a multiple of `multiple` per rank."""
    n, r = comm.world(group), comm.rank(group)
    if x.shape[1] % (n * multiple):
        raise ValueError(f"length {x.shape[1]} is not a multiple of "
                         f"{n} shards x {multiple}")
    per = x.shape[1] // n
    return x[:, r * per:(r + 1) * per]


@torch.no_grad()
def seanet_encode_sp(params, x: torch.Tensor, cfg: SEANetConfig, mesh, *,
                     axis_name: str = "seq",
                     plain: bool = False) -> torch.Tensor:
    """Sequence-parallel `seanet_encoder`: x `[B, T, C]` with `T % (shards
    * hop) == 0` → latents `[B, T/hop, dimension]` on every rank.
    `plain=True` runs the LSTM's plain twin."""
    if not cfg.causal:
        raise ValueError("sequence parallelism requires a causal model")
    group = mesh.get_group(axis_name)
    y = _sp_conv(params["init_conv"], _shard(x, group, cfg.hop_length),
                 k=cfg.kernel_size, cfg=cfg, group=group)
    for stage, ratio in zip(params["stages"], cfg.encoder_ratios):
        for j, res_p in enumerate(stage["res"]):
            y = _sp_resblock(res_p, y, cfg, [cfg.dilation_base ** j, 1],
                             group)
        y = _act(y, cfg.activation_alpha)
        y = _sp_conv(stage["down"], y, k=ratio * 2, s=ratio, cfg=cfg,
                     group=group)
    # the token-rate tail: gathered, then replicated
    y = comm.all_gather(y.contiguous(), group, dim=1)
    if cfg.lstm:
        y = ops.lstm(params["lstm"], y, skip=True, plain=plain)
    y = _act(y, cfg.activation_alpha)
    return ops.sconv1d(params["final_conv"], y,
                       kernel_size=cfg.last_kernel_size, causal=True,
                       norm=cfg.norm, pad_mode=cfg.pad_mode)


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
    full = F.conv_transpose1d(y.transpose(1, 2),
                              effective_weight(p, transposed=True), None,
                              stride=s)
    L_out = y.shape[1] * s
    pt = k - s
    out = full[:, :, :L_out]
    if pt > 0:
        halo = comm.shift_right(full[:, :, L_out:L_out + pt].contiguous(),
                                group)
        if halo is not None:
            out = out.clone()
            out[:, :, :pt] += halo
    if p.get("b") is not None:
        out = out + p["b"][:, None]
    return _apply_norm(out, p, cfg.norm).transpose(1, 2)


@torch.no_grad()
def seanet_decode_sp(params, z: torch.Tensor, cfg: SEANetConfig, mesh, *,
                     axis_name: str = "seq",
                     plain: bool = False) -> torch.Tensor:
    """Sequence-parallel `seanet_decoder` for causal models with
    `trim_right_ratio == 1`: z `[B, Tz, D]` with `Tz % shards == 0` →
    audio `[B, Tz*hop, C]` on every rank."""
    if not (cfg.causal and cfg.trim_right_ratio == 1.0):
        raise ValueError("sequence-parallel decoding needs a causal model "
                         "with trim_right_ratio 1")
    group = mesh.get_group(axis_name)
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
    return comm.all_gather(y.contiguous(), group, dim=1)


def decode_sp(params, qstate, codes: torch.Tensor, cfg, mesh, *,
              axis_name: str = "seq", plain: bool = False) -> torch.Tensor:
    """Sequence-parallel decode: codes `[B, K, Tz]` → audio
    `[B, Tz*hop, C]`."""
    from ..quant import rvq_decode
    emb = rvq_decode(qstate, codes.permute(1, 0, 2), cfg.rvq)
    return seanet_decode_sp(params["decoder"], emb, cfg.seanet, mesh,
                            axis_name=axis_name, plain=plain)
