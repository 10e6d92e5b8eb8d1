"""encodec_tpu_torch: the PyTorch/CUDA port of the encodec_tpu codec.

The JAX package `encodec_tpu` stays the reference; this package mirrors its
module layout (`ops/`, `quant/`, `models/`, `stream/`, `utils/`, `kernels/`)
with PyTorch idiom: plain functions over tensors and nested parameter dicts,
an explicit `device`, and `torch.Generator` for random init.

It imports torch, numpy and the standard library only — never `jax` or
`encodec_tpu`. On a CUDA device the three hand-written Hopper kernels
(`kernels/csrc/*.cu`: RVQ stage search, fused RVQ encode, LSTM recurrence)
are the path; their plain PyTorch twins run only for CPU tensors.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
