"""Device resolution and float32 policy.

Every factory and `EncodecModel` takes `device=` (default ``"cuda"``) and
resolves it here. A CUDA request without a visible GPU raises: the port
never moves to the CPU quietly. The CPU is used only when the caller asks
for it, as the tests do.

FP32 is FP32: TF32 is switched off for matmuls AND for cuDNN convolutions
(the cuDNN flag defaults to True, which would run every conv at reduced
precision — the 'fast' mode the reference's container writer refuses).
A model at `set_precision('high')` turns TF32 on only around its own
calls (`precision_scope`), and puts the flags back as it found them.
Both use PyTorch's `allow_tf32` flags and no other flag API (mixing them
with the `fp32_precision` settings makes PyTorch raise).
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch

PRECISION_MODES = ("highest", "high", "fast")


def set_fp32_policy() -> None:
    """Disable TF32 for cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_precision_mode(mode: str) -> str:
    """`mode` if it is one of `PRECISION_MODES`; else a ValueError."""
    if mode not in PRECISION_MODES:
        raise ValueError(f"unknown precision mode {mode!r}; expected one of "
                         f"{PRECISION_MODES}")
    return mode


@contextlib.contextmanager
def precision_scope(mode: str) -> tp.Iterator[None]:
    """TF32 for cuBLAS matmuls and cuDNN convolutions inside the block
    when `mode` is 'high', float32 ('highest', 'fast') otherwise; on exit,
    normal or by an exception, both flags are put back as they were. (The
    CPU has no TF32: there 'high' computes as 'highest'.)"""
    check_precision_mode(mode)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    tf32 = mode == "high"
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


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
