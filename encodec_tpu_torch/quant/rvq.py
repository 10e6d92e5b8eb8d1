"""Residual vector quantization, inference half.

Port of `encodec_tpu/quant/rvq.py`: `RVQConfig`/`RVQState`, `rvq_encode`,
`rvq_encode_margins`, `resolve_ties_f64`, `rvq_decode` and the bandwidth
bookkeeping, with shared and independent codebooks. Distances keep the
reference association order `‖x‖² − 2·x·Eᵀ + ‖E‖²` with the first-index
argmax, so codes equal the JAX package's.

The searches go through the kernel wrappers: `rvq_encode` is K2
(`kernels.rvq_encode_fused`, all stages in one launch) and
`rvq_encode_margins` is K1 per stage (`kernels.nearest_codebook`) with the
residual update `r −= E[idx]` in torch. `plain=True` runs the plain twins
even on CUDA tensors, to hold the kernel path against them on the card.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ..kernels import (nearest_codebook, nearest_codebook_plain,
                       rvq_encode_fused, rvq_encode_fused_plain)


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    dimension: int = 256
    n_q: int = 8
    bins: int = 1024
    kmeans_init: bool = True
    shared_codebook: bool = False  # fork quirk: one VQ reused for all stages

    @property
    def num_books(self) -> int:
        return 1 if self.shared_codebook else self.n_q


class RVQState(tp.NamedTuple):
    """EMA codebook state. Leading axis = codebook index (1 if shared)."""
    embed: torch.Tensor         # [n_books, bins, dim]
    embed_avg: torch.Tensor     # [n_books, bins, dim]
    cluster_size: torch.Tensor  # [n_books, bins]
    inited: bool


def init_rvq(generator: torch.Generator, cfg: RVQConfig,
             device: torch.device = torch.device("cpu")) -> RVQState:
    """Fresh codebooks: all zeros with `kmeans_init` (filled by the first
    training batch — every code is 0 until then), else kaiming uniform."""
    shape = (cfg.num_books, cfg.bins, cfg.dimension)
    if cfg.kmeans_init:
        embed = torch.zeros(shape)
    else:
        bound = math.sqrt(3.0) * math.sqrt(2.0 / cfg.dimension)
        embed = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    embed = embed.to(device)
    return RVQState(embed=embed, embed_avg=embed.clone(),
                    cluster_size=torch.zeros(shape[:2], device=device),
                    inited=not cfg.kmeans_init)


def _active_n_q(cfg: RVQConfig, n_q: tp.Optional[int]) -> int:
    # the reference slices `layers[:n_q]`, capping at the available stages
    return min(n_q or cfg.n_q, cfg.n_q)


def rvq_encode(state: RVQState, x: torch.Tensor, cfg: RVQConfig,
               n_q: tp.Optional[int] = None, plain: bool = False
               ) -> torch.Tensor:
    """Encode `[B, T, D]` → codes `[K, B, T]` int32 (K2)."""
    n_q = _active_n_q(cfg, n_q)
    B, T, D = x.shape
    flat = x.reshape(B * T, D).contiguous()
    embed = state.embed.contiguous()
    fn = rvq_encode_fused_plain if plain else rvq_encode_fused
    return fn(flat, embed, n_q, cfg.shared_codebook).reshape(n_q, B, T)


def rvq_encode_margins(state: RVQState, x: torch.Tensor, cfg: RVQConfig,
                       n_q: tp.Optional[int] = None, plain: bool = False
                       ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """`rvq_encode` plus per-stage top-2 margins (K1 per stage).

    Returns (codes `[K, B, T]` int32 — the same selection as `rvq_encode` —
    and margins `[K, B, T]` f32 = best minus runner-up negated distance),
    for the container writer's near-tie guard."""
    n_q = _active_n_q(cfg, n_q)
    B, T, D = x.shape
    residual = x.reshape(B * T, D).contiguous()
    search = nearest_codebook_plain if plain else nearest_codebook
    codes, margins = [], []
    for k in range(n_q):
        book = state.embed[0 if cfg.shared_codebook else k].contiguous()
        idx, margin = search(residual, book)
        codes.append(idx)
        margins.append(margin)
        residual = residual - book[idx.long()]
    if not codes:
        empty = x.new_zeros((0, B, T))
        return empty.to(torch.int32), empty
    return (torch.stack(codes).reshape(n_q, B, T),
            torch.stack(margins).reshape(n_q, B, T))


def resolve_ties_f64(state: RVQState, z: np.ndarray, cfg: RVQConfig,
                     n_q: int) -> np.ndarray:
    """Host float64 RVQ chain for flagged near-tie positions: the canonical
    cross-writer resolution. `z`: [N, D] latents. Returns codes [N, K].

    Exact squared distances in f64 with numpy argmin (first index on exact
    ties, the reference order). The resolution is relative to `z`: two
    writers agree where their encoders produced the same latents to within
    the f64 margin."""
    z = np.asarray(z, np.float64)
    out = np.empty((z.shape[0], n_q), np.int64)
    residual = z.copy()
    books = (state.embed[:1] if cfg.shared_codebook else state.embed[:n_q])
    books = books.detach().cpu().numpy().astype(np.float64)
    for k in range(n_q):
        embed = books[0] if cfg.shared_codebook else books[k]
        d = ((residual[:, None, :] - embed[None]) ** 2).sum(-1)
        idx = np.argmin(d, axis=1)
        out[:, k] = idx
        residual -= embed[idx]
    return out


def rvq_decode(state: RVQState, codes: torch.Tensor, cfg: RVQConfig
               ) -> torch.Tensor:
    """Decode codes `[K, B, T]` → quantized latents `[B, T, D]`."""
    n_q = codes.shape[0]
    codes = codes.long()
    if cfg.shared_codebook:
        quantized = state.embed[0][codes]                      # [K, B, T, D]
    else:
        stages = torch.arange(n_q, device=codes.device)[:, None, None]
        quantized = state.embed[stages, codes]                 # [K, B, T, D]
    return quantized.sum(dim=0)


# ---------------------------------------------------------------------------
# Bandwidth bookkeeping (ref vq.py:116-131)
# ---------------------------------------------------------------------------

def bandwidth_per_quantizer(bins: int, frame_rate: float) -> float:
    """kbps·1000 contributed by one codebook at the given frame rate."""
    return math.log2(bins) * frame_rate


def num_quantizers_for_bandwidth(cfg: RVQConfig, frame_rate: float,
                                 bandwidth: tp.Optional[float]) -> int:
    bw_per_q = bandwidth_per_quantizer(cfg.bins, frame_rate)
    n_q = cfg.n_q
    if bandwidth and bandwidth > 0.0:
        n_q = int(max(1, math.floor(bandwidth * 1000 / bw_per_q)))
    return n_q
