"""K1 and K2: RVQ codebook search — CUDA kernel wrappers and plain twins.

K1 `nearest_codebook` replaces
`encodec_tpu/kernels/vq_pallas.py::nearest_codebook_pallas`, extended to
return the top-2 margin the container writer's near-tie guard reads. K2
`rvq_encode_fused` replaces `vq_pallas.py::rvq_encode_pallas`: every stage
in one launch with the residual kept on chip. Both kernels live in
`csrc/vq_search.cu`; at the 24 kHz shapes they are bounded by FP32 FFMA
throughput (full-f32 dots are required for code parity), and keep the
`[N, bins]` distance matrix out of device memory (see the source).

For CPU tensors the wrappers run the plain PyTorch twins; for CUDA tensors
they launch the kernel or raise — no fallback. `<wrapper>.launches` counts
kernel launches.
"""

from __future__ import annotations

import typing as tp

import torch

from . import build
from .validate import check_tensor, require_same_device


def distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Negated squared distances `[N, bins]` in the reference association
    order `-((‖x‖² - 2·x·Eᵀ) + ‖E‖²)`."""
    x_sq = x.square().sum(1, keepdim=True)
    e_sq = embed.square().sum(1)[None, :]
    return -((x_sq - 2.0 * (x @ embed.t())) + e_sq)


def nearest_codebook_plain(x: torch.Tensor, embed: torch.Tensor
                           ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: (idx int32 [N], margin f32 [N]).

    `idx` is the first maximum of the negated distance; `margin` is
    `best - max over j != idx` (0 on an exact tie)."""
    dist = distances(x, embed)
    best, idx = dist.max(dim=1)
    if dist.shape[1] > 1:
        second = dist.scatter(1, idx[:, None], float("-inf")).amax(dim=1)
    else:
        second = torch.full_like(best, float("-inf"))
    return idx.to(torch.int32), best - second


def rvq_encode_fused_plain(x: torch.Tensor, embed: torch.Tensor, n_q: int,
                           shared: bool = False) -> torch.Tensor:
    """Plain twin of K2: codes `[n_q, N]` int32."""
    residual = x
    codes = []
    for k in range(n_q):
        book = embed[0 if shared else k]
        idx = distances(residual, book).argmax(dim=1)
        codes.append(idx)
        residual = residual - book[idx]
    if not codes:
        return x.new_zeros((0, x.shape[0]), dtype=torch.int32)
    return torch.stack(codes).to(torch.int32)


def _check_search(x: torch.Tensor, embed: torch.Tensor, book_dims: int) -> None:
    check_tensor("x", x, ndim=2)
    check_tensor("embed", embed, ndim=book_dims)
    require_same_device(x, embed)
    if embed.shape[-1] != x.shape[1]:
        raise ValueError(f"dimension mismatch: x {tuple(x.shape)}, "
                         f"embed {tuple(embed.shape)}")
    if embed.shape[-2] < 1:
        raise ValueError("empty codebook")


def nearest_codebook(x: torch.Tensor, embed: torch.Tensor
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """K1: nearest codebook row and top-2 margin for each row of x.

    x: `[N, D]` f32, embed: `[bins, D]` f32, contiguous, one device.
    Returns (idx int32 `[N]`, margin f32 `[N]`)."""
    _check_search(x, embed, 2)
    if x.device.type == "cpu":
        return nearest_codebook_plain(x, embed)
    lib = build.load_library("vq_search")
    N, D = x.shape
    idx = torch.empty(N, dtype=torch.int32, device=x.device)
    margin = torch.empty(N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.vq_nearest_launch(
            x.data_ptr(), embed.data_ptr(), N, embed.shape[0], D,
            idx.data_ptr(), margin.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "vq_search", rc)
    nearest_codebook.launches += 1
    return idx, margin


def rvq_encode_fused(x: torch.Tensor, embed: torch.Tensor, n_q: int,
                     shared: bool = False) -> torch.Tensor:
    """K2: full residual-VQ encode in one launch.

    x: `[N, D]` f32; embed: `[n_books, bins, D]` f32 (book 0 reused for
    every stage when `shared`). Returns codes `[n_q, N]` int32."""
    _check_search(x, embed, 3)
    if n_q < 0 or (not shared and n_q > embed.shape[0]):
        raise ValueError(f"n_q={n_q} but {embed.shape[0]} codebooks")
    if x.device.type == "cpu":
        return rvq_encode_fused_plain(x, embed, n_q, shared)
    lib = build.load_library("vq_search")
    N, D = x.shape
    codes = torch.empty(n_q, N, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.vq_rvq_launch(
            x.data_ptr(), embed.data_ptr(), N, embed.shape[1], D, n_q,
            int(shared), codes.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "vq_search", rc)
    rvq_encode_fused.launches += 1
    return codes


nearest_codebook.launches = 0  # type: ignore[attr-defined]
rvq_encode_fused.launches = 0  # type: ignore[attr-defined]
