"""Argument checks shared by the kernel wrappers.

A wrapper hands raw pointers to CUDA, so it takes only what the kernel
takes: float32 (or the stated dtype), the stated rank, contiguous, on the
CPU (plain twin) or a CUDA device (kernel), all on one device. Anything
else raises; nothing is converted silently.
"""

from __future__ import annotations

import torch

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_PER_BLOCK = 232_448


def check_tensor(name: str, t, *, ndim: int,
                 dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t.device, torch.device) or t.device.type not in (
            "cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_same_device(*tensors) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
