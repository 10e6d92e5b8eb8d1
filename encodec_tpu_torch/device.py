"""Device resolution and float32 policy.

Every factory and `EncodecModel` takes `device=` (default ``"cuda"``) and
resolves it here. A CUDA request without a visible GPU raises: the port
never moves to the CPU quietly. The CPU is used only when the caller asks
for it, as the tests do.

FP32 is FP32: TF32 is switched off for matmuls AND for cuDNN convolutions
(the cuDNN flag defaults to True, which would run every conv at reduced
precision — the 'fast' mode the reference's container writer refuses).
"""

from __future__ import annotations

import typing as tp

import torch


def set_fp32_policy() -> None:
    """Disable TF32 for cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: tp.Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """`device` as a `torch.device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' explicitly to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cuda', 'cuda:N' or 'cpu')")
    set_fp32_policy()
    return dev
