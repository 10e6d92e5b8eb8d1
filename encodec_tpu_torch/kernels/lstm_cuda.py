"""K3: the LSTM recurrence — CUDA kernel wrapper and its plain twin.

Replaces `encodec_tpu/kernels/lstm_pallas.py::lstm_scan_pallas`. The kernel
(`csrc/lstm_scan.cu`) is bounded by the T-step dependency chain, not by
FLOPs or bytes; it runs as one persistent cooperative grid split by hidden
unit, with each CTA's slice of W_hh resident in shared memory and one
grid-wide barrier per step (see the source for the design).

`lstm_scan` is the entry point: for CPU tensors it runs the plain PyTorch
twin `lstm_scan_plain`; for CUDA tensors it launches the kernel or raises —
there is no fallback. `lstm_scan.launches` counts kernel launches.
"""

from __future__ import annotations

import typing as tp

import torch

from . import build
from .validate import check_tensor, require_same_device

# Largest dynamic shared memory one launch may ask for; the batch is split
# into chunks that fit (each chunk is an independent set of sequences).
_SMEM_LIMIT = 200 * 1024


def lstm_cell(h: torch.Tensor, c: torch.Tensor, gates: torch.Tensor
              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell update from pre-activation gates [B, 4H] (i, f, g, o)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain recurrence from state (h, c) [B, H]: returns (ys [B, T, H], hT, cT).

    `gates = xp_t + h W_hhᵀ`, the reference's association order."""
    w_hh_t = w_hh.t()
    ys = []
    for t in range(xp.shape[1]):
        h, c = lstm_cell(h, c, xp[:, t] + h @ w_hh_t)
        ys.append(h)
    if not ys:
        return xp.new_zeros(xp.shape[0], 0, w_hh.shape[1]), h, c
    return torch.stack(ys, dim=1), h, c


def lstm_scan_plain(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin of the kernel: zero-state recurrence."""
    B, H = xp.shape[0], w_hh.shape[1]
    zero = xp.new_zeros(B, H)
    return lstm_recurrence(xp, w_hh, zero, zero)[0]


def _units_per_cta(H: int) -> int:
    # at most 128 CTAs (the H100 has 132 SMs): U = ceil(H / 128)
    return max(1, -(-H // 128))


def _batch_chunk(B: int, H: int, U: int, max_cells: int) -> int:
    R = 4 * U
    chunk = min(B, max_cells // U)
    while chunk > 1 and 4 * (R * H + chunk * H + R * chunk + U * chunk) > _SMEM_LIMIT:
        chunk -= 1
    return chunk


def lstm_scan(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One LSTM layer's zero-state recurrence.

    xp: `[B, T, 4H]` f32 gate inputs (x W_ihᵀ + b_ih + b_hh); w_hh: `[4H, H]`
    f32 (torch layout). Returns h `[B, T, H]` f32. Both contiguous, on one
    device."""
    check_tensor("xp", xp, ndim=3)
    check_tensor("w_hh", w_hh, ndim=2)
    require_same_device(xp, w_hh)
    B, T, H4 = xp.shape
    H = w_hh.shape[1]
    if H4 != 4 * H or w_hh.shape[0] != H4:
        raise ValueError(f"shape mismatch: xp {tuple(xp.shape)}, "
                         f"w_hh {tuple(w_hh.shape)} (want [B,T,4H], [4H,H])")
    if xp.device.type == "cpu":
        return lstm_scan_plain(xp, w_hh)
    lib = build.load_library("lstm_scan")
    out = torch.empty(B, T, H, device=xp.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    U = _units_per_cta(H)
    n_blocks = -(-H // U)
    if n_blocks * T >= 2 ** 32:
        raise ValueError(f"sequence too long for the barrier counter (T={T})")
    max_cells = lib.lstm_scan_max_cells()
    chunk = _batch_chunk(B, H, U, max_cells)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    with torch.cuda.device(xp.device):
        for b0 in range(0, B, chunk):
            nb = min(chunk, B - b0)
            counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
            rc = lib.lstm_scan_launch(
                xp[b0:b0 + nb].data_ptr(), w_hh.data_ptr(),
                out[b0:b0 + nb].data_ptr(), counter.data_ptr(),
                nb, T, H, U, stream)
            build.check(lib, "lstm_scan", rc)
            lstm_scan.launches += 1
    return out


lstm_scan.launches = 0  # type: ignore[attr-defined]
