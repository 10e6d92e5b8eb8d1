"""Streamable 1-D convolutions, transposed convolutions and norms.

Port of `encodec_tpu/ops/conv.py` (`sconv1d`, `sconv_transpose1d`, the
weight-norm fold, `layer_norm`, `time_group_norm`). The JAX package never
had a Pallas kernel for these — XLA computed them — so the convolutions go
to `F.conv1d` / `F.conv_transpose1d` (cuDNN on the GPU, with TF32 off; see
`device.py`). The TPU-only lowerings (`conv1d_shift`, `lowering=`) are not
ported.

Parameters are kept in torch layout: conv weights `[Cout, Cin, K]`,
transposed-conv weights `[Cin, Cout, K]`. Weight norm is the reference's
`weight_norm(dim=0)` of the torch weight: per-Cout for a conv but per-*Cin*
for a transposed conv (an upstream quirk the published checkpoints carry).
In torch layout both reduce over dims (1, 2), with `g` indexed by dim 0.
Spectral norm (`torch.nn.utils.spectral_norm`) keeps `w_orig` and the
power-iteration vectors `u_sn` / `v_sn` as leaves of the parameter tree:
`u`/`v` are buffers (no gradient reaches them), refreshed once per training
step by `spectral_norm_update_tree`, as the JAX package does.

Public functions take and return channels-last `[B, T, C]`; internally
they run channels-first `[B, C, T]` for `F.conv1d`.

Reduced precision (bf16 training compute, `EncodecModel.set_precision(
'fast')`): a conv computes in its input's dtype. Its effective weight
(weight or spectral norm) is computed from the float32 masters and then
cast, with the bias, to that dtype (`conv_weights`); the norms take their
statistics in float32 and cast the result back. On float32 inputs every
cast is the identity, so the float32 path is unchanged bit for bit.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from .pad import get_extra_padding_for_conv1d, pad_time, unpad1d

Params = tp.Dict[str, tp.Any]

CONV_NORMALIZATIONS = frozenset(["none", "weight_norm", "spectral_norm",
                                 "layer_norm", "time_group_norm"])


# ---------------------------------------------------------------------------
# Initialization (torch.nn.Conv1d defaults: kaiming uniform a=sqrt(5),
# bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
# ---------------------------------------------------------------------------

def _uniform(shape, bound: float, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def _with_norm_params(params: Params, norm: str, out_ch: int,
                      generator: torch.Generator, device: torch.device,
                      transposed: bool = False) -> Params:
    if norm == "weight_norm":
        v = params.pop("w")
        params["v"] = v
        params["g"] = v.square().sum(dim=(1, 2)).sqrt()
    elif norm == "spectral_norm":
        params = init_spectral(params, generator, transposed)
    elif norm in ("layer_norm", "time_group_norm"):
        params["norm"] = {
            "scale": torch.ones(out_ch, device=device),
            "bias": torch.zeros(out_ch, device=device),
        }
    return params


def init_sconv1d(generator: torch.Generator, in_ch: int, out_ch: int,
                 kernel_size: int, *, norm: str = "none",
                 device: torch.device = torch.device("cpu")) -> Params:
    if norm not in CONV_NORMALIZATIONS:
        raise ValueError(f"unsupported norm {norm!r}")
    fan_in = in_ch * kernel_size
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    params: Params = {
        "w": _uniform((out_ch, in_ch, kernel_size), bound, generator, device),
        "b": _uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator, device)}
    return _with_norm_params(params, norm, out_ch, generator, device)


def init_sconv_transpose1d(generator: torch.Generator, in_ch: int,
                           out_ch: int, kernel_size: int, *,
                           norm: str = "none",
                           device: torch.device = torch.device("cpu")
                           ) -> Params:
    if norm not in CONV_NORMALIZATIONS:
        raise ValueError(f"unsupported norm {norm!r}")
    # torch ConvTranspose1d: weight [Cin, Cout, K], fan_in = Cout * K
    fan_in = out_ch * kernel_size
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    params: Params = {
        "w": _uniform((in_ch, out_ch, kernel_size), bound, generator, device),
        "b": _uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator, device)}
    return _with_norm_params(params, norm, out_ch, generator, device,
                             transposed=True)


# ---------------------------------------------------------------------------
# Spectral norm (JAX: `encodec_tpu/ops/conv.py:69-160`)
# ---------------------------------------------------------------------------

def _sn_matrix(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """The `[Cout, rest]` matrix view torch's spectral_norm takes: dim 0 of
    a conv weight (`[Cout, Cin, K...]`), dim 1 of a transposed conv's
    (`[Cin, Cout, K]`), the other dims flattened in order."""
    if transposed:
        w = w.transpose(0, 1)
    return w.reshape(w.shape[0], -1)


def _sn_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def spectral_norm_power_iterate(params: Params, n_power_iterations: int = 1,
                                eps: float = 1e-12,
                                transposed: bool = False) -> Params:
    """`n` power-iteration updates of `u_sn`/`v_sn` (torch's training-mode
    spectral-norm hook, as an explicit state update). Returns new params;
    the new vectors carry no graph."""
    with torch.no_grad():
        w_mat = _sn_matrix(params["w_orig"], transposed)
        u, v = params["u_sn"], params["v_sn"]
        for _ in range(n_power_iterations):
            v = _sn_normalize(w_mat.t() @ u, eps)
            u = _sn_normalize(w_mat @ v, eps)
    return dict(params, u_sn=u, v_sn=v)


def spectral_weight(params: Params, transposed: bool = False) -> torch.Tensor:
    """`w_orig / σ` with `σ = uᵀ W v` from the stored vectors; `u` and `v`
    are detached (buffers), so only `w_orig` gets a gradient."""
    w = params["w_orig"]
    sigma = torch.dot(params["u_sn"].detach(),
                      _sn_matrix(w, transposed) @ params["v_sn"].detach())
    return w / sigma


def spectral_norm_update_tree(tree, transposed: bool = False):
    """One power iteration for every spectral-norm conv of a parameter tree
    (the identity without any). The port's trees name their transposed
    convs `up` (the SEANet decoder's upsampling stages): those take their
    matrix view from dim 1."""
    if isinstance(tree, dict):
        if "w_orig" in tree and "u_sn" in tree:
            return spectral_norm_power_iterate(tree, transposed=transposed)
        return {k: spectral_norm_update_tree(v, transposed=k == "up")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(spectral_norm_update_tree(v) for v in tree)
    return tree


def init_spectral(params: Params, generator: torch.Generator,
                  transposed: bool = False, eps: float = 1e-12) -> Params:
    """`w` → `w_orig` with normalized gaussian `u_sn` [Cout] and `v_sn`
    [rest] drawn from `generator`."""
    w = params.pop("w")
    h, wd = _sn_matrix(w, transposed).shape
    params["w_orig"] = w
    params["u_sn"] = _sn_normalize(
        torch.randn(h, generator=generator, dtype=torch.float32), eps).to(
            w.device)
    params["v_sn"] = _sn_normalize(
        torch.randn(wd, generator=generator, dtype=torch.float32), eps).to(
            w.device)
    return params


# ---------------------------------------------------------------------------
# Weight norm
# ---------------------------------------------------------------------------

def effective_weight(params: Params, transposed: bool = False
                     ) -> torch.Tensor:
    """The conv weight, folding weight norm `g·v/‖v‖` or spectral norm
    `w_orig/σ` when present (`transposed`: a transposed conv's weight)."""
    if "v" in params:
        v = params["v"]
        norm = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
        return params["g"][:, None, None] * v / norm
    if "w_orig" in params:
        return spectral_weight(params, transposed)
    return params["w"]


def conv_weights(params: Params, x: torch.Tensor, transposed: bool = False
                 ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """`(weight, bias)` for a conv on `x`: the effective weight from the
    float32 masters, then weight and bias cast to `x.dtype` (JAX casts at
    the same point, `encodec_tpu/ops/conv.py:386-393`)."""
    w = effective_weight(params, transposed).to(x.dtype)
    b = params.get("b")
    return w, None if b is None else b.to(x.dtype)


def fold_weight_norm(params: Params) -> Params:
    """Fold weight-norm (v, g) into a plain weight for inference."""
    if "v" not in params:
        return params
    out = {k: v for k, v in params.items() if k not in ("v", "g")}
    out["w"] = effective_weight(params)
    return out


def fold_weight_norm_tree(tree):
    """`fold_weight_norm` applied to every conv dict of a parameter tree."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            return fold_weight_norm(tree)
        return {k: fold_weight_norm_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fold_weight_norm_tree(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# Norm layers, channels-first [B, C, T]
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor, dims, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Statistics and the affine map in float32 whatever `x`'s dtype; the
    result in `x`'s dtype (JAX: `encodec_tpu/ops/conv.py:220-242`)."""
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + eps) * scale[:, None]
           + bias[:, None])
    return out.to(x.dtype)


def _apply_norm(y: torch.Tensor, params: Params, norm: str) -> torch.Tensor:
    if norm == "layer_norm":
        return _normalize(y, (1,), params["norm"]["scale"],
                          params["norm"]["bias"], 1e-5)
    if norm == "time_group_norm":
        return _normalize(y, (1, 2), params["norm"]["scale"],
                          params["norm"]["bias"], 1e-5)
    return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel axis of `[B, T, C]`, per time step."""
    return _normalize(x.transpose(1, 2), (1,), scale, bias, eps).transpose(1, 2)


def time_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(1, C) over `[B, T, C]`: normalize over (T, C) per item."""
    return _normalize(x.transpose(1, 2), (1, 2), scale, bias,
                      eps).transpose(1, 2)


# ---------------------------------------------------------------------------
# Streamable convs (padding contract + norm)
# ---------------------------------------------------------------------------

def sconv1d(params: Params, x: torch.Tensor, *, kernel_size: int,
            stride: int = 1, dilation: int = 1,
            causal: bool = False, norm: str = "none",
            pad_mode: str = "reflect") -> torch.Tensor:
    """Conv1d with causal/asymmetric padding on `[B, T, C]` → `[B, T', C']`."""
    if causal and norm == "time_group_norm":
        raise ValueError("GroupNorm doesn't support causal evaluation.")
    effective_k = (kernel_size - 1) * dilation + 1
    padding_total = effective_k - stride
    extra_padding = get_extra_padding_for_conv1d(
        x.shape[1], effective_k, stride, padding_total)
    if causal:
        paddings = (padding_total, extra_padding)
    else:
        padding_right = padding_total // 2
        paddings = (padding_total - padding_right, padding_right + extra_padding)
    xc = pad_time(x.transpose(1, 2), paddings, mode=pad_mode)
    w, b = conv_weights(params, x)
    y = F.conv1d(xc, w, b, stride=stride, dilation=dilation)
    return _apply_norm(y, params, norm).transpose(1, 2)


def sconv_transpose1d(params: Params, x: torch.Tensor, *, kernel_size: int,
                      stride: int = 1, causal: bool = False,
                      norm: str = "none",
                      trim_right_ratio: float = 1.0) -> torch.Tensor:
    """ConvTranspose1d on `[B, T, C]` that trims `kernel_size - stride` of
    implicit padding (causal: right-trim by `trim_right_ratio`)."""
    if not (causal or trim_right_ratio == 1.0):
        raise ValueError("trim_right_ratio != 1 only makes sense for causal")
    if causal and norm == "time_group_norm":
        raise ValueError("GroupNorm doesn't support causal evaluation.")
    padding_total = kernel_size - stride
    w, b = conv_weights(params, x, transposed=True)
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride)
    y = _apply_norm(y, params, norm).transpose(1, 2)
    if causal:
        padding_right = math.ceil(padding_total * trim_right_ratio)
    else:
        padding_right = padding_total // 2
    return unpad1d(y, (padding_total - padding_right, padding_right))
