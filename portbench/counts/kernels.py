"""The card's peaks and the least time of each hand-written kernel.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense, at its
700 W limit: FP32 outside the tensor cores 67 TFLOP/s (the port's path:
TF32 is off, its kernels are FP32), HBM 3.35 TB/s. A kernel's bound is the
larger of its operations over the FP32 peak and its bytes over the HBM
peak, each input byte read once and each output byte written once.

K3 (the LSTM recurrence, `kernels/csrc/lstm_scan.cu`, `lstm_grid.cu`) runs
one layer's recurrence over xp = x·W_ihᵀ + b (computed outside it): per
step and row the product h·W_hhᵀ, 2·H·4H FLOPs, so 8·B·T·H² a layer. Its
saving forward also writes every step's c. K3's backward
(`lstm_bwd.cu`, `lstm_bwd_cluster.cu`) carries dh back through W_hh, again
8·B·T·H², reading the pre-activations, the saved c and d out, writing the
gate gradients.
"""

from __future__ import annotations

FP32_PEAK = 67e12       # FLOP/s
HBM_PEAK = 3.35e12      # B/s
F32 = 4                 # bytes


def k3_forward(batch: int, t: int, h: int, save_c: bool = False) -> dict:
    """FLOPs and bytes of one K3 forward launch."""
    flops = 8.0 * batch * t * h * h
    bytes_ = F32 * (batch * t * 4 * h      # xp
                    + 4 * h * h            # W_hh
                    + batch * t * h        # h out
                    + (batch * t * h if save_c else 0))
    return {"flops": flops, "bytes": float(bytes_)}


def k3_backward(batch: int, t: int, h: int) -> dict:
    """FLOPs and bytes of one K3 backward launch."""
    flops = 8.0 * batch * t * h * h
    bytes_ = F32 * (batch * t * 4 * h      # pre-activations
                    + batch * t * h        # saved c
                    + batch * t * h        # d out
                    + 4 * h * h            # W_hh
                    + batch * t * 4 * h)   # d gates
    return {"flops": flops, "bytes": float(bytes_)}


def bound_s(work: dict) -> float:
    """The least seconds of `work` on the card."""
    return max(work["flops"] / FP32_PEAK, work["bytes"] / HBM_PEAK)
