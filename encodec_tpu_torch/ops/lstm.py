"""Stacked LSTM with a residual skip (the SEANet SLSTM).

Port of `encodec_tpu/ops/lstm.py`. The input projection of a whole layer,
`x·W_ihᵀ + b_ih + b_hh`, is one large `torch.matmul` outside any kernel;
the zero-state full-sequence recurrence goes to the K3 wrapper
(`kernels.lstm_scan`: the CUDA kernel for CUDA tensors, its plain twin for
CPU tensors). Streaming paths (`state=`, `return_state=`, `lstm_step`) run
the plain recurrence. Gate packing follows torch.nn.LSTM (i, f, g, o).
Parameters per layer, torch layout: w_ih [4H, in], w_hh [4H, H], b_ih, b_hh.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..kernels import lstm_scan, lstm_scan_plain
from ..kernels.lstm_cuda import lstm_cell, lstm_recurrence

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


def lstm(params: Params, x: torch.Tensor, *, skip: bool = True,
         state: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
         return_state: bool = False, plain: bool = False):
    """Stacked LSTM over `[B, T, C]` with an additive residual skip.

    `state` is an optional `(h, c)` pair of `[num_layers, B, H]` tensors;
    zeros when omitted (SLSTM always starts from zero). `plain=True` runs
    the plain recurrence even on CUDA tensors (the kernel's twin, used to
    hold the kernel path against it on the card)."""
    layers = params["layers"]
    y = x
    if state is None and not return_state:
        scan = lstm_scan_plain if plain else lstm_scan
        for layer in layers:
            y = scan(_project(layer, y), layer["w_hh"].contiguous())
        return y + x if skip else y
    B = x.shape[0]
    H = layers[0]["w_hh"].shape[-1]
    if state is None:
        h0 = c0 = x.new_zeros(len(layers), B, H)
    else:
        h0, c0 = state
    hs, cs = [], []
    for i, layer in enumerate(layers):
        y, hT, cT = lstm_recurrence(_project(layer, y), layer["w_hh"],
                                    h0[i], c0[i])
        hs.append(hT)
        cs.append(cT)
    if skip:
        y = y + x
    if return_state:
        return y, (torch.stack(hs), torch.stack(cs))
    return y


def lstm_step(params: Params, x: torch.Tensor,
              state: tp.Tuple[torch.Tensor, torch.Tensor]):
    """Single-timestep stacked LSTM update for streaming.

    x: [B, C]; state: (h, c) each [L, B, H]. Returns (y [B, H], new_state).
    No skip connection (the caller decides)."""
    h, c = state
    y = x
    new_h, new_c = [], []
    for i, layer in enumerate(params["layers"]):
        gates = (y @ layer["w_ih"].t() + h[i] @ layer["w_hh"].t()
                 + layer["b_ih"] + layer["b_hh"])
        hi, ci = lstm_cell(h[i], c[i], gates)
        new_h.append(hi)
        new_c.append(ci)
        y = hi
    return y, (torch.stack(new_h), torch.stack(new_c))
