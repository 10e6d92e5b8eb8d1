"""Stacked LSTM with a residual skip (the SEANet SLSTM).

Port of `encodec_tpu/ops/lstm.py`. The input projection of a whole layer,
`x·W_ihᵀ + b_ih + b_hh`, is one large `torch.matmul` outside any kernel;
each layer's recurrence goes to the K3 wrapper (`kernels.lstm_scan`: the
CUDA kernel for CUDA tensors, its plain twin for CPU tensors), from zero
state or, for streaming (`state=`, `return_state=`), from the carried
`(h, c)`. `lstm_step` runs the plain cell (no path calls it on the card).

Training: when grad mode is on and a parameter, the input or the state
requires a gradient, each layer's recurrence runs through `LstmLayer`, a
`torch.autograd.Function` whose forward is K3's saving variant (it also
keeps every step's c) and whose backward is K3's backward kernel
(`kernels.lstm_scan_backward`), with the pre-activations and dW_hh as one
matmul each around it. Otherwise (inference) the layer runs the plain K3
launch, as it always did.
The recurrence always computes in float32 (K3, its saving variant, its
backward and its twin are float32 kernels): a bf16 input is cast up
before the input projection and the result cast back on exit; a caller's
streaming state joins in float32, and the returned state is float32
(JAX: `encodec_tpu/ops/lstm.py:95-125`).
Gate packing follows torch.nn.LSTM (i, f, g, o).
Parameters per layer, torch layout: w_ih [4H, in], w_hh [4H, H], b_ih, b_hh.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..kernels import (lstm_scan, lstm_scan_backward, lstm_scan_backward_plain,
                       lstm_scan_plain)
from ..kernels.lstm_cuda import lstm_cell

Params = tp.Dict[str, tp.Any]


def init_lstm(generator: torch.Generator, dimension: int, num_layers: int = 2,
              hidden: tp.Optional[int] = None,
              device: torch.device = torch.device("cpu")) -> Params:
    hidden = hidden or dimension
    bound = 1.0 / math.sqrt(hidden)

    def u(*shape):
        r = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((r * 2.0 - 1.0) * bound).to(device)

    layers = []
    for i in range(num_layers):
        in_dim = dimension if i == 0 else hidden
        layers.append({"w_ih": u(4 * hidden, in_dim), "w_hh": u(4 * hidden, hidden),
                       "b_ih": u(4 * hidden), "b_hh": u(4 * hidden)})
    return {"layers": layers}


def _project(layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Hoisted input projection `[B, T, C]` → gate inputs `[B, T, 4H]`."""
    return (torch.matmul(x, layer["w_ih"].t()) + layer["b_ih"]
            + layer["b_hh"]).contiguous()


class LstmLayer(torch.autograd.Function):
    """One layer's recurrence with its gradient: `apply(xp, w_hh, h0, c0,
    plain)` → (h `[B, T, H]`, cT `[B, H]`); h0 and c0 both or neither.

    Forward: K3 with `save_c` (the kernel on CUDA, the twin on the CPU or
    with `plain`), keeping xp, h and every step's c. Backward: the
    pre-activations `xp + [h0; h_{<T-1}] W_hhᵀ` (one matmul), the backward
    kernel (or its twin) for d xp, dh0 and dc0, and `dW_hh = d xpᵀ [h0;
    h_{<T-1}]` (one matmul). The pre-activations exist only during this
    layer's backward."""

    @staticmethod
    def forward(ctx, xp, w_hh, h0, c0, plain):
        scan = lstm_scan_plain if plain else lstm_scan
        out, c_seq = scan(xp, w_hh, h0, c0, save_c=True)
        ctx.plain = plain
        ctx.stateful = h0 is not None
        ctx.save_for_backward(xp, w_hh, out, c_seq, h0, c0)
        cT = (c_seq[:, -1] if c_seq.shape[1] else
              (xp.new_zeros(xp.shape[0], w_hh.shape[1]) if c0 is None
               else c0)).clone()
        return out, cT

    @staticmethod
    def backward(ctx, d_out, d_cT):
        xp, w_hh, out, c_seq, h0, c0 = ctx.saved_tensors
        B, T, H4 = xp.shape
        H = H4 // 4
        first = out.new_zeros(B, 1, H) if h0 is None else h0[:, None]
        h_prev = torch.cat([first, out[:, :-1]], dim=1)
        pre = torch.addmm(xp.reshape(B * T, H4), h_prev.reshape(B * T, H),
                          w_hh.t()).reshape(B, T, H4)
        d_out = (out.new_zeros(B, T, H) if d_out is None
                 else d_out.contiguous())
        bwd = lstm_scan_backward_plain if ctx.plain else lstm_scan_backward
        kw = {} if ctx.plain else {"state_grad": ctx.stateful}
        dgates, dh0, dc0 = bwd(pre, c_seq, d_out, w_hh, c0,
                               None if d_cT is None else d_cT.contiguous(),
                               **kw)
        del pre
        dw_hh = dgates.reshape(B * T, H4).t() @ h_prev.reshape(B * T, H)
        if not ctx.stateful:
            dh0 = dc0 = None
        return dgates, dw_hh, dh0, dc0, None


def _trains(params: Params, x: torch.Tensor, state) -> bool:
    if not torch.is_grad_enabled():
        return False
    tensors = [x, *(state or ())]
    for layer in params["layers"]:
        tensors.extend(layer.values())
    return any(t.requires_grad for t in tensors)


def lstm(params: Params, x: torch.Tensor, *, skip: bool = True,
         state: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
         return_state: bool = False, plain: bool = False):
    """Stacked LSTM over `[B, T, C]` with an additive residual skip.

    `state` is an optional `(h, c)` pair of `[num_layers, B, H]` tensors;
    zeros when omitted (SLSTM always starts from zero). With
    `return_state` it returns `(y, (h, c))`, the final state in the same
    form. `plain=True` runs the plain recurrence even on CUDA tensors (the
    kernel's twin, used to hold the kernel path against it on the card).
    With grad mode on and anything requiring a gradient, every layer goes
    through `LstmLayer` (K3's saving forward and the backward kernel)."""
    scan = lstm_scan_plain if plain else lstm_scan
    train = _trains(params, x, state)
    in_dtype = x.dtype
    x = x.float()
    if state is not None:
        state = tuple(t.float() for t in state)
    y = x
    hs, cs = [], []
    for i, layer in enumerate(params["layers"]):
        h0, c0 = (None, None) if state is None else (
            state[0][i].contiguous(), state[1][i].contiguous())
        xp, w_hh = _project(layer, y), layer["w_hh"].contiguous()
        if train:
            y, cT = LstmLayer.apply(xp, w_hh, h0, c0, plain)
            hs.append(y[:, -1] if y.shape[1] else
                      (xp.new_zeros(xp.shape[0], w_hh.shape[1]) if h0 is None
                       else h0))
            cs.append(cT)
            continue
        out = scan(xp, w_hh, h0, c0, return_state=return_state)
        if return_state:
            y, hT, cT = out
            hs.append(hT)
            cs.append(cT)
        else:
            y = out
    if skip:
        y = y + x
    y = y.to(in_dtype)
    if return_state:
        return y, (torch.stack(hs), torch.stack(cs))
    return y


def lstm_step(params: Params, x: torch.Tensor,
              state: tp.Tuple[torch.Tensor, torch.Tensor]):
    """Single-timestep stacked LSTM update for streaming.

    x: [B, C]; state: (h, c) each [L, B, H]. Returns (y [B, H], new_state).
    No skip connection (the caller decides). Computes in float32 and
    returns `y` in `x`'s dtype, the state in float32."""
    h, c = (t.float() for t in state)
    y = x.float()
    new_h, new_c = [], []
    for i, layer in enumerate(params["layers"]):
        gates = (y @ layer["w_ih"].t() + h[i] @ layer["w_hh"].t()
                 + layer["b_ih"] + layer["b_hh"])
        hi, ci = lstm_cell(h[i], c[i], gates)
        new_h.append(hi)
        new_c.append(ci)
        y = hi
    return y.to(x.dtype), (torch.stack(new_h), torch.stack(new_c))
