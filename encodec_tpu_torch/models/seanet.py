"""SEANet encoder/decoder as plain functions over parameter dicts.

Port of `encodec_tpu/models/seanet.py` (`seanet_encoder`, `seanet_decoder`,
the resblocks with shortcut, the ELU alpha, `decoder_final_norm` and
`final_activation`). Activations are `[B, T, C]` at these functions, like
the JAX package. Parameters are nested dicts mirroring the reference module
tree (the same tree the JAX package uses), in torch weight layout.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops

Params = tp.Dict[str, tp.Any]


@dataclasses.dataclass(frozen=True)
class SEANetConfig:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: tp.Tuple[int, ...] = (8, 5, 4, 2)   # decoder (upsampling) order
    activation_alpha: float = 1.0                # ELU alpha
    norm: str = "weight_norm"
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    causal: bool = False
    pad_mode: str = "reflect"
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    trim_right_ratio: float = 1.0                # decoder only
    final_activation: tp.Optional[str] = None    # e.g. 'tanh'
    # the fork hard-codes the decoder's final conv to norm='none';
    # upstream checkpoints need it normed like the rest
    decoder_final_norm: tp.Optional[str] = None  # None → use `norm`

    @property
    def encoder_ratios(self) -> tp.Tuple[int, ...]:
        return tuple(reversed(self.ratios))

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    def resolved_decoder_final_norm(self) -> str:
        return self.norm if self.decoder_final_norm is None else self.decoder_final_norm


def resolve_activation(name: str):
    """An activation by torch class name ('Tanh', 'ELU') or function name."""
    fn = getattr(torch, name, None) or getattr(torch, name.lower(), None) \
        or getattr(F, name.lower(), None)
    if fn is None:
        raise ValueError(f"unknown activation {name!r}")
    return fn


def _act(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return F.elu(x, alpha=alpha)


# ---------------------------------------------------------------------------
# Residual block
# ---------------------------------------------------------------------------

def _resblock_dims(cfg: SEANetConfig, dim: int):
    hidden = dim // cfg.compress
    return [cfg.residual_kernel_size, 1], [(dim, hidden), (hidden, dim)]


def init_resblock(gen: torch.Generator, cfg: SEANetConfig, dim: int,
                  device: torch.device) -> Params:
    ks, chans = _resblock_dims(cfg, dim)
    p: Params = {"convs": [
        ops.init_sconv1d(gen, cin, cout, k, norm=cfg.norm, device=device)
        for k, (cin, cout) in zip(ks, chans)]}
    if not cfg.true_skip:
        p["shortcut"] = ops.init_sconv1d(gen, dim, dim, 1, norm=cfg.norm,
                                         device=device)
    return p


def apply_resblock(p: Params, x: torch.Tensor, cfg: SEANetConfig,
                   dilations: tp.Sequence[int]) -> torch.Tensor:
    ks, _ = _resblock_dims(cfg, x.shape[-1])
    y = x
    for conv_p, k, d in zip(p["convs"], ks, dilations):
        y = _act(y, cfg.activation_alpha)
        y = ops.sconv1d(conv_p, y, kernel_size=k, dilation=d,
                        causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode)
    if "shortcut" in p:
        sc = ops.sconv1d(p["shortcut"], x, kernel_size=1, causal=cfg.causal,
                         norm=cfg.norm, pad_mode=cfg.pad_mode)
    else:
        sc = x
    return sc + y


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def init_seanet_encoder(gen: torch.Generator, cfg: SEANetConfig,
                        device: torch.device) -> Params:
    mult = 1
    p: Params = {
        "init_conv": ops.init_sconv1d(gen, cfg.channels, cfg.n_filters,
                                      cfg.kernel_size, norm=cfg.norm,
                                      device=device),
        "stages": [],
    }
    for ratio in cfg.encoder_ratios:
        dim = mult * cfg.n_filters
        p["stages"].append({
            "res": [init_resblock(gen, cfg, dim, device)
                    for _ in range(cfg.n_residual_layers)],
            "down": ops.init_sconv1d(gen, dim, dim * 2, ratio * 2,
                                     norm=cfg.norm, device=device),
        })
        mult *= 2
    if cfg.lstm:
        p["lstm"] = ops.init_lstm(gen, mult * cfg.n_filters,
                                  num_layers=cfg.lstm, device=device)
    p["final_conv"] = ops.init_sconv1d(gen, mult * cfg.n_filters,
                                       cfg.dimension, cfg.last_kernel_size,
                                       norm=cfg.norm, device=device)
    return p


def seanet_encoder(p: Params, x: torch.Tensor, cfg: SEANetConfig,
                   plain: bool = False) -> torch.Tensor:
    """Encode audio `[B, T, channels]` → latents `[B, T/hop, dimension]`.

    `plain=True` runs the LSTM's plain twin even on CUDA tensors."""
    y = ops.sconv1d(p["init_conv"], x, kernel_size=cfg.kernel_size,
                    causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode)
    for stage, ratio in zip(p["stages"], cfg.encoder_ratios):
        for j, res_p in enumerate(stage["res"]):
            y = apply_resblock(res_p, y, cfg, [cfg.dilation_base ** j, 1])
        y = _act(y, cfg.activation_alpha)
        y = ops.sconv1d(stage["down"], y, kernel_size=ratio * 2, stride=ratio,
                        causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode)
    if cfg.lstm:
        y = ops.lstm(p["lstm"], y, skip=True, plain=plain)
    y = _act(y, cfg.activation_alpha)
    return ops.sconv1d(p["final_conv"], y, kernel_size=cfg.last_kernel_size,
                       causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def init_seanet_decoder(gen: torch.Generator, cfg: SEANetConfig,
                        device: torch.device) -> Params:
    mult = int(2 ** len(cfg.ratios))
    p: Params = {
        "init_conv": ops.init_sconv1d(gen, cfg.dimension, mult * cfg.n_filters,
                                      cfg.kernel_size, norm=cfg.norm,
                                      device=device),
        "stages": [],
    }
    if cfg.lstm:
        p["lstm"] = ops.init_lstm(gen, mult * cfg.n_filters,
                                  num_layers=cfg.lstm, device=device)
    for ratio in cfg.ratios:
        dim = mult * cfg.n_filters
        p["stages"].append({
            "up": ops.init_sconv_transpose1d(gen, dim, dim // 2, ratio * 2,
                                             norm=cfg.norm, device=device),
            "res": [init_resblock(gen, cfg, dim // 2, device)
                    for _ in range(cfg.n_residual_layers)],
        })
        mult //= 2
    p["final_conv"] = ops.init_sconv1d(
        gen, cfg.n_filters, cfg.channels, cfg.last_kernel_size,
        norm=cfg.resolved_decoder_final_norm(), device=device)
    return p


def seanet_decoder(p: Params, z: torch.Tensor, cfg: SEANetConfig,
                   plain: bool = False) -> torch.Tensor:
    """Decode latents `[B, T, dimension]` → audio `[B, T*hop, channels]`.

    `plain=True` runs the LSTM's plain twin even on CUDA tensors."""
    y = ops.sconv1d(p["init_conv"], z, kernel_size=cfg.kernel_size,
                    causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode)
    if cfg.lstm:
        y = ops.lstm(p["lstm"], y, skip=True, plain=plain)
    for stage, ratio in zip(p["stages"], cfg.ratios):
        y = _act(y, cfg.activation_alpha)
        y = ops.sconv_transpose1d(stage["up"], y, kernel_size=ratio * 2,
                                  stride=ratio, causal=cfg.causal,
                                  norm=cfg.norm,
                                  trim_right_ratio=cfg.trim_right_ratio)
        for j, res_p in enumerate(stage["res"]):
            y = apply_resblock(res_p, y, cfg, [cfg.dilation_base ** j, 1])
    y = _act(y, cfg.activation_alpha)
    y = ops.sconv1d(p["final_conv"], y, kernel_size=cfg.last_kernel_size,
                    causal=cfg.causal, norm=cfg.resolved_decoder_final_norm(),
                    pad_mode=cfg.pad_mode)
    if cfg.final_activation is not None:
        y = resolve_activation(cfg.final_activation)(y)
    return y
