"""Streaming (chunked) causal convolution primitives.

Port of `encodec_tpu/ops/streaming.py`. A causal conv needs only
`effective_kernel - stride` samples of left context, and a causal
transposed conv only the `kernel - stride` samples of overlap-add tail it
spills past its chunk; these functions carry that context as explicit
state, so chunks whose lengths are stride multiples reproduce the batch
forward. Like the JAX package, chunks and states are channels-last
`[B, L, C]`; each conv runs channels-first on `[state | chunk]`, a
contiguous tensor like the batch path's padded input. A returned state is
a view of the conv input it came from.

The TPU lowering switches (`precision=`, `lowering=`) are not ported: the
port has only the float32 path.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .conv import _apply_norm, conv_weights
from .pad import pad_time

Params = tp.Dict[str, tp.Any]


def _check_norm(norm: str) -> None:
    if norm == "time_group_norm":
        # a chunk sees a time slice; whole-time group-norm statistics are
        # not computable (and causal group norm is refused upstream too)
        raise ValueError("GroupNorm doesn't support causal evaluation.")


def _with_context(x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """`[state | x]` as a contiguous channels-first `[B, C, ctx + L]`, in
    `x`'s dtype (a stream whose model changed its precision mode carries
    its contexts on in the new dtype)."""
    return torch.cat([state.to(x.dtype).transpose(1, 2), x.transpose(1, 2)],
                     dim=2)


def conv_stream_init(batch: int, in_ch: int, kernel_size: int,
                     stride: int = 1, dilation: int = 1,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device = torch.device("cpu")
                     ) -> torch.Tensor:
    """Zero left context `[B, Ke - s, Cin]` for a causal conv. The batch
    path pads the signal start with `pad_mode` (reflect by default), so use
    `prime_conv_stream` to match it on the first chunk."""
    effective_k = (kernel_size - 1) * dilation + 1
    return torch.zeros(batch, effective_k - stride, in_ch, dtype=dtype,
                       device=device)


def sconv1d_stream(params: Params, x: torch.Tensor, state: torch.Tensor, *,
                   kernel_size: int, stride: int = 1, dilation: int = 1,
                   norm: str = "none"
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of a causal SConv1d.

    x: `[B, L, Cin]` with `L % stride == 0`; state: `[B, Ke - s, Cin]`.
    Returns `(y [B, L/s, Cout], new_state)`."""
    _check_norm(norm)
    if x.shape[1] % stride:
        raise ValueError(f"chunk length {x.shape[1]} is not a multiple of "
                         f"the stride {stride}")
    ctx = (kernel_size - 1) * dilation + 1 - stride
    full = _with_context(x, state)
    w, b = conv_weights(params, x)
    y = F.conv1d(full, w, b, stride=stride, dilation=dilation)
    y = _apply_norm(y, params, norm).transpose(1, 2)
    return y, full[:, :, full.shape[2] - ctx:].transpose(1, 2)


def prime_conv_stream(x_head: torch.Tensor, kernel_size: int, stride: int = 1,
                      dilation: int = 1, pad_mode: str = "reflect"
                      ) -> torch.Tensor:
    """The stream-start left context that matches the batch path: the
    `pad_mode` padding of the first samples `x_head` (`[B, L, C]`), as
    `[B, ctx, C]`. The left padding reads at most `ctx + 1` samples, so
    only those are padded."""
    ctx = (kernel_size - 1) * dilation + 1 - stride
    head = x_head[:, :ctx + 1].transpose(1, 2)
    return pad_time(head, (ctx, 0), mode=pad_mode)[:, :, :ctx].transpose(1, 2)


def convtr_stream_init(batch: int, out_ch: int, kernel_size: int,
                       stride: int = 1, dtype: torch.dtype = torch.float32,
                       device: torch.device = torch.device("cpu")
                       ) -> torch.Tensor:
    """Overlap-add carry `[B, k - s, Cout]` of a causal transposed conv."""
    return torch.zeros(batch, kernel_size - stride, out_ch, dtype=dtype,
                       device=device)


def sconv_transpose1d_stream(params: Params, x: torch.Tensor,
                             carry: torch.Tensor, *, kernel_size: int,
                             stride: int = 1, norm: str = "none"
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of a causal SConvTranspose1d with
    `trim_right_ratio == 1` (all trimming on the right).

    x: `[B, L, Cin]`; carry: `[B, k - s, Cout]`, the bias-free overlap tail
    of the previous chunk. Returns `(y [B, L*s, Cout], new_carry)`."""
    if norm not in ("none", "weight_norm"):
        raise ValueError("streaming transposed conv supports parameter "
                         f"norms only, got {norm!r}")
    pt = kernel_size - stride
    w, b = conv_weights(params, x)
    full = F.conv_transpose1d(x.transpose(1, 2), w, None, stride=stride)
    if pt > 0:
        full[:, :, :pt] += carry.to(x.dtype).transpose(1, 2)
    L_out = x.shape[1] * stride
    y = full[:, :, :L_out]
    if b is not None:
        # in place, so y keeps the batch path's layout (a slice of the
        # whole conv output), and elementwise ops downstream take the same
        # code paths as there
        y += b[:, None]
    return y.transpose(1, 2), full[:, :, L_out:].transpose(1, 2)


def sconv1d_stream_finish(params: Params, x: torch.Tensor,
                          state: torch.Tensor, *, kernel_size: int,
                          stride: int = 1, dilation: int = 1,
                          norm: str = "none", pad_mode: str = "reflect"
                          ) -> torch.Tensor:
    """Final step of a causal SConv1d stream on a tail `x` of any length
    `r > 0`: the `(-r) mod s` right padding with `pad_mode` that the batch
    path applies at the end of the signal (the stream so far consumed a
    stride multiple), giving the last `ceil(r / s)` output frames. The
    padding's reflect source fits in `[state | x]`, as the state holds
    `Ke - s >= s - 1` samples for every strided SEANet conv."""
    _check_norm(norm)
    extra = (-x.shape[1]) % stride
    full = _with_context(x, state)
    if extra:
        full = pad_time(full, (0, extra), mode=pad_mode)
    w, b = conv_weights(params, x)
    y = F.conv1d(full, w, b, stride=stride, dilation=dilation)
    return _apply_norm(y, params, norm).transpose(1, 2)
