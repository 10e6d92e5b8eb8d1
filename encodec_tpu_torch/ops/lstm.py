"""Stacked LSTM with a residual skip (the SEANet SLSTM).

Port of `encodec_tpu/ops/lstm.py`. The input projection of a whole layer,
`x·W_ihᵀ + b_ih + b_hh`, is one large `torch.matmul` outside any kernel;
each layer's recurrence goes to the K3 wrapper (`kernels.lstm_scan`: the
CUDA kernel for CUDA tensors, its plain twin for CPU tensors), from zero
state or, for streaming (`state=`, `return_state=`), from the carried
`(h, c)`. `lstm_step` runs the plain cell (no path calls it on the card).
Gate packing follows torch.nn.LSTM (i, f, g, o).
Parameters per layer, torch layout: w_ih [4H, in], w_hh [4H, H], b_ih, b_hh.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..kernels import lstm_scan, lstm_scan_plain
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


def lstm(params: Params, x: torch.Tensor, *, skip: bool = True,
         state: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
         return_state: bool = False, plain: bool = False):
    """Stacked LSTM over `[B, T, C]` with an additive residual skip.

    `state` is an optional `(h, c)` pair of `[num_layers, B, H]` tensors;
    zeros when omitted (SLSTM always starts from zero). With
    `return_state` it returns `(y, (h, c))`, the final state in the same
    form. `plain=True` runs the plain recurrence even on CUDA tensors (the
    kernel's twin, used to hold the kernel path against it on the card)."""
    scan = lstm_scan_plain if plain else lstm_scan
    y = x
    hs, cs = [], []
    for i, layer in enumerate(params["layers"]):
        h0, c0 = (None, None) if state is None else (
            state[0][i].contiguous(), state[1][i].contiguous())
        out = scan(_project(layer, y), layer["w_hh"].contiguous(), h0, c0,
                   return_state=return_state)
        if return_state:
            y, hT, cT = out
            hs.append(hT)
            cs.append(cT)
        else:
            y = out
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
