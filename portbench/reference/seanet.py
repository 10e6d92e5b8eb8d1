"""The plain SEANet encoder and decoder (EnCodec, arXiv:2210.13438 §3.1),
in float32 PyTorch with no kernel of the port and no cache.

It reads the benchmark's parameter tree by its names:
- a conv is `{"w"}` or weight norm `{"v", "g"}` (g per dim 0) or spectral
  norm `{"w_orig", "u_sn", "v_sn"}`, with `"b"` and, for the norms that
  act on activations, `"norm": {"scale", "bias"}`;
- the encoder is `init_conv`, `stages[i]` (`res[j]` = `convs[0..1]`,
  `shortcut`; `down`), `lstm` (`layers[l]`: `w_ih`, `w_hh`, `b_ih`,
  `b_hh`, gates i, f, g, o) and `final_conv`;
- the decoder is `init_conv`, `lstm`, `stages[i]` (`up`, a transposed
  conv, then `res`) and `final_conv`.
Activations are `[B, C, T]` inside. The streamable convs pad as the
published SEANet does: `kernel - stride` in all (all on the left when
causal), plus what makes the last window full; the transposed convs trim
the same amount (on the right when causal). The LSTM is a loop over time.
With `remat`, each stage is recomputed in the backward
(`torch.utils.checkpoint`): the same values, less memory.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def conv_weight(p: dict, transposed: bool = False) -> torch.Tensor:
    if "v" in p:
        v = p["v"]
        norm = torch.linalg.vector_norm(v.flatten(1), dim=1)
        shape = (-1,) + (1,) * (v.dim() - 1)
        return v * (p["g"] / norm).reshape(shape)
    if "w_orig" in p:
        w = p["w_orig"]
        mat = (w.transpose(0, 1) if transposed else w).flatten(1)
        sigma = p["u_sn"].detach() @ (mat @ p["v_sn"].detach())
        return w / sigma
    return p["w"]


def _norm(y: torch.Tensor, p: dict, norm: str) -> torch.Tensor:
    if norm == "layer_norm":
        return F.layer_norm(y.transpose(1, 2), (y.shape[1],),
                            p["norm"]["scale"], p["norm"]["bias"],
                            1e-5).transpose(1, 2)
    if norm == "time_group_norm":
        return F.group_norm(y, 1, p["norm"]["scale"], p["norm"]["bias"], 1e-5)
    return y


def _pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    if mode != "reflect":
        return F.pad(x, (left, right))
    extra = max(0, max(left, right) - x.shape[-1] + 1)
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., :y.shape[-1] - extra]


def conv1d(p: dict, x: torch.Tensor, arch: dict, kernel: int,
           stride: int = 1, dilation: int = 1,
           norm: tp.Optional[str] = None) -> torch.Tensor:
    norm = arch["norm"] if norm is None else norm
    ek = (kernel - 1) * dilation + 1
    pad_total = ek - stride
    t = x.shape[-1]
    n_frames = (t - ek + pad_total) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + ek - pad_total - t
    if arch["causal"]:
        left, right = pad_total, extra
    else:
        left = pad_total - pad_total // 2
        right = pad_total // 2 + extra
    x = _pad(x, left, right, arch["pad_mode"])
    y = F.conv1d(x, conv_weight(p), p.get("b"), stride=stride,
                 dilation=dilation)
    return _norm(y, p, norm)


def conv_transpose1d(p: dict, x: torch.Tensor, arch: dict, kernel: int,
                     stride: int) -> torch.Tensor:
    y = F.conv_transpose1d(x, conv_weight(p, transposed=True), p.get("b"),
                           stride=stride)
    y = _norm(y, p, arch["norm"])
    pad_total = kernel - stride
    if arch["causal"]:
        right = math.ceil(pad_total * arch["trim_right_ratio"])
    else:
        right = pad_total // 2
    left = pad_total - right
    return y[..., left:y.shape[-1] - right]


def lstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The stacked LSTM with its skip, over `[B, C, T]`: a loop over time,
    one step at a time."""
    y = x.transpose(1, 2)
    inp = y
    for layer in p["layers"]:
        w_hh = layer["w_hh"]
        hidden = w_hh.shape[1]
        xp = inp @ layer["w_ih"].t() + layer["b_ih"] + layer["b_hh"]
        h = xp.new_zeros(xp.shape[0], hidden)
        c = xp.new_zeros(xp.shape[0], hidden)
        outs = []
        for t in range(xp.shape[1]):
            gates = xp[:, t] + h @ w_hh.t()
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        inp = torch.stack(outs, dim=1)
    return (inp + y).transpose(1, 2)


def _resblock(p: dict, x: torch.Tensor, arch: dict,
              dilation: int) -> torch.Tensor:
    y = x
    for j, cp in enumerate(p["convs"]):
        k, d = (arch["residual_kernel_size"], dilation) if j == 0 else (1, 1)
        y = conv1d(cp, F.elu(y), arch, k, dilation=d)
    sc = conv1d(p["shortcut"], x, arch, 1) if "shortcut" in p else x
    return sc + y


def _stage(fn, y: torch.Tensor, remat: bool) -> torch.Tensor:
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, y, use_reentrant=False)
    return fn(y)


def encoder(p: dict, x: torch.Tensor, arch: dict,
            remat: bool = False) -> torch.Tensor:
    """Audio `[B, C, T]` → latents `[B, T', D]`."""
    y = conv1d(p["init_conv"], x, arch, arch["kernel_size"])
    for st, r in zip(p["stages"], reversed(arch["ratios"])):
        def fn(y, st=st, r=r):
            for j, rp in enumerate(st["res"]):
                y = _resblock(rp, y, arch, arch["dilation_base"] ** j)
            return conv1d(st["down"], F.elu(y), arch, 2 * r, stride=r)
        y = _stage(fn, y, remat)
    y = lstm(p["lstm"], y)
    y = conv1d(p["final_conv"], F.elu(y), arch, arch["last_kernel_size"])
    return y.transpose(1, 2)


def decoder(p: dict, z: torch.Tensor, arch: dict,
            remat: bool = False) -> torch.Tensor:
    """Latents `[B, T', D]` → audio `[B, C, T'·hop]`."""
    y = conv1d(p["init_conv"], z.transpose(1, 2), arch, arch["kernel_size"])
    y = lstm(p["lstm"], y)
    for st, r in zip(p["stages"], arch["ratios"]):
        def fn(y, st=st, r=r):
            y = conv_transpose1d(st["up"], F.elu(y), arch, 2 * r, r)
            for j, rp in enumerate(st["res"]):
                y = _resblock(rp, y, arch, arch["dilation_base"] ** j)
            return y
        y = _stage(fn, y, remat)
    return conv1d(p["final_conv"], F.elu(y), arch, arch["last_kernel_size"],
                  norm=arch["decoder_final_norm"])
