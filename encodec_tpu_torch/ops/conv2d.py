"""2-D convolution with torch-style symmetric padding and weight or spectral
norm: the MS-STFT discriminator's conv (reference NormConv2d,
conv.py:132-147).

Port of `encodec_tpu/ops/conv2d.py`. The JAX package computes it with
`jax.lax.conv_general_dilated` outside any Pallas kernel, so here it is
`F.conv2d` (cuDNN on the GPU, TF32 off: `device.py`). Activations are NCHW
`[B, C, time, freq]`, weights OIHW `[Cout, Cin, kh (time), kw (freq)]`;
JAX's NHWC/HWIO trees are converted only at the boundary
(`models.zoo.msstftd_params_from_jax`). A stride of (1, 2) walks
frequency, as the reference's does after its `b c w t -> b c t w`
rearrange.

JAX's `impl="taps"` (a tap-decomposed weight gradient that keeps XLA's
conv-backward-filter from building im2col patches on the TPU) is a TPU
lowering choice; `impl` is accepted and both values take cuDNN's weight
gradient, which differs from the tap sums only in reduction order.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from .conv import init_spectral, spectral_weight

Params = tp.Dict[str, tp.Any]
CONV2D_IMPLS = ("xla", "taps")


def init_conv2d(generator: torch.Generator, in_ch: int, out_ch: int,
                kernel_size: tp.Tuple[int, int], *, norm: str = "none",
                device: torch.device = torch.device("cpu")) -> Params:
    """torch.nn.Conv2d's default init (kaiming uniform a=sqrt(5), bias
    U(±1/sqrt(fan_in))), with weight norm per Cout or spectral norm."""
    kh, kw = kernel_size
    fan_in = in_ch * kh * kw
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
    w = ((torch.rand((out_ch, in_ch, kh, kw), generator=generator) * 2 - 1)
         * bound).to(device)
    b = ((torch.rand((out_ch,), generator=generator) * 2 - 1)
         / math.sqrt(fan_in)).to(device)
    p: Params = {"b": b}
    if norm == "weight_norm":
        p["v"] = w
        p["g"] = w.square().sum(dim=(1, 2, 3)).sqrt()
    elif norm == "spectral_norm":
        p["w"] = w
        p = init_spectral(p, generator)
    elif norm == "none":
        p["w"] = w
    else:
        raise ValueError(f"unsupported conv2d norm {norm!r}")
    return p


def weight2d(p: Params) -> torch.Tensor:
    """The OIHW weight, resolving weight norm (per Cout) or spectral norm."""
    if "v" in p:
        v = p["v"]
        return p["g"][:, None, None, None] * v / v.square().sum(
            dim=(1, 2, 3), keepdim=True).sqrt()
    if "w_orig" in p:
        return spectral_weight(p)
    return p["w"]


def conv2d(p: Params, x: torch.Tensor, *,
           stride: tp.Tuple[int, int] = (1, 1),
           dilation: tp.Tuple[int, int] = (1, 1),
           padding: tp.Tuple[int, int] = (0, 0),
           impl: str = "xla") -> torch.Tensor:
    """x: `[B, Cin, H, W]` → `[B, Cout, H', W']`, zero padding
    `(pad_h, pad_w)` on both sides of each axis. Computes in `x`'s dtype:
    the weight is resolved from the float32 masters, then it and the bias
    are cast to that dtype (JAX: `encodec_tpu/ops/conv2d.py:60-85`)."""
    if impl not in CONV2D_IMPLS:
        raise ValueError(f"unknown conv2d impl {impl!r}")
    b = p.get("b")
    return F.conv2d(x, weight2d(p).to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding, dilation=dilation)


def conv2d_params_from_torch(state, prefix: str) -> Params:
    """Reference NormConv2d `{prefix}conv.*` keys (numpy arrays or tensors;
    the weight is OIHW already) → float32 CPU tensors."""
    def get(key):
        v = state[key]
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", torch.float32).clone()
        return torch.from_numpy(np.array(v, dtype=np.float32))

    p: Params = {}
    if f"{prefix}conv.weight_v" in state:
        p["v"] = get(f"{prefix}conv.weight_v")
        p["g"] = get(f"{prefix}conv.weight_g").reshape(-1)
    else:
        p["w"] = get(f"{prefix}conv.weight")
    if f"{prefix}conv.bias" in state:
        p["b"] = get(f"{prefix}conv.bias")
    return p
