"""Residual vector quantization: inference and training.

Port of `encodec_tpu/quant/rvq.py`: `RVQConfig`/`RVQState`, `rvq_encode`,
`rvq_encode_margins`, `resolve_ties_f64`, `rvq_decode`, the bandwidth
bookkeeping and the training half (`_kmeans`, `_sample_vectors`,
`_stage_train`, `rvq_forward`: EMA codebooks, lazy k-means init on the
first batch's residuals, dead-code expiry, the straight-through estimator
and the commit loss), with shared and independent codebooks. Distances
keep the reference association order `‖x‖² − 2·x·Eᵀ + ‖E‖²` with the
first-index argmax, so codes equal the JAX package's.

The searches go through the kernel wrappers: `rvq_encode` is K2
(`kernels.rvq_encode_fused`, all stages in one launch) and
`rvq_encode_margins` is K1 per stage (`kernels.nearest_codebook`) with the
residual update `r −= E[idx]` in torch. In training every search (each
stage and each k-means iteration) is K1. `plain=True` runs the plain twins
even on CUDA tensors, to hold the kernel path against them on the card.

Training draws (k-means seeds, expiry replacements) come from an explicit
CPU `torch.Generator`, so a run on the card and one on the CPU draw the
same indices; the indices can also be passed in (`init_idx`, `sample_idx`),
which is how the tests feed JAX's draws to the port. The EMA statistics
are one-hot matmuls (no atomics), so a step gives the same bits run to
run.

Under a data-parallel training step (`dp`, a `parallel.comm.DataParallel`;
`ops.batch_reduce.LOCAL` otherwise) each rank holds its rows of the global
batch, and every draw from the step's
generator sees the global rows in rank order, so the ranks' codebooks and
generator states stay identical and equal the single process's on the
whole batch: the lazy k-means init runs on the gathered residual on every
rank, the EMA statistics are summed over ranks before the decay, the
expiry draws row indices over the global N (the owning rank contributes
each drawn row, the others zeros, summed: x + 0 is exact), and the commit
loss is the global mean.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ..kernels import (nearest_codebook, nearest_codebook_plain,
                       rvq_encode_fused, rvq_encode_fused_plain)
from ..ops.batch_reduce import LOCAL, BatchReduce


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    dimension: int = 256
    n_q: int = 8
    bins: int = 1024
    decay: float = 0.99
    kmeans_init: bool = True
    kmeans_iters: int = 50
    threshold_ema_dead_code: float = 2.0
    epsilon: float = 1e-5
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
# Training path (ref core_vq.py:65-98, 101-255, 316-346, 364-445)
# ---------------------------------------------------------------------------

Draws = tp.Optional[tp.Sequence[tp.Optional[torch.Tensor]]]


def _search(x: torch.Tensor, embed: torch.Tensor, plain: bool,
            margins: tp.Optional[list] = None) -> torch.Tensor:
    """Nearest codebook row of each row of x (K1, or its twin), int64;
    K1's top-2 margins are appended to `margins` when given."""
    fn = nearest_codebook_plain if plain else nearest_codebook
    idx, margin = fn(x.contiguous(), embed.contiguous())
    if margins is not None:
        margins.append(margin)
    return idx.long()


def _draw(n: int, num: int, generator: tp.Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """`num` row indices of n: the first `num` of a permutation when n ≥ num,
    else `num` uniform draws (JAX's `permutation` / `randint` choice). Drawn
    on the CPU, so the card and the CPU draw alike."""
    if n >= num:
        idx = torch.randperm(n, generator=generator)[:num]
    else:
        idx = torch.randint(0, n, (num,), generator=generator)
    return idx.to(device)


def _one_hot(idx: torch.Tensor, bins: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(idx.shape[0], bins, dtype=dtype, device=idx.device
                       ).scatter_(1, idx[:, None], 1.0)


def _kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int,
            generator: tp.Optional[torch.Generator] = None,
            init_idx: tp.Optional[torch.Tensor] = None, plain: bool = False
            ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain k-means (ref core_vq.py:76-98). samples: [N, D].

    Seeds from the rows `init_idx` (drawn from `generator` when not given);
    returns (means [clusters, D], counts [clusters]). Like the reference,
    the counts are the LAST iteration's assignment, against the means
    before their final update: they seed the cluster-size EMA."""
    if init_idx is None:
        init_idx = _draw(samples.shape[0], num_clusters, generator,
                         samples.device)
    means = samples[init_idx.to(samples.device)]
    counts = samples.new_zeros(num_clusters)
    for _ in range(num_iters):
        one_hot = _one_hot(_search(samples, means, plain), num_clusters,
                           samples.dtype)
        counts = one_hot.sum(0)
        sums = one_hot.t() @ samples
        new_means = sums / counts.clamp(min=1.0)[:, None]
        means = torch.where((counts == 0)[:, None], means, new_means)
    return means, counts


def _sample_vectors(samples: torch.Tensor, num: int,
                    generator: tp.Optional[torch.Generator] = None,
                    idx: tp.Optional[torch.Tensor] = None,
                    dp: BatchReduce = LOCAL) -> torch.Tensor:
    """Random batch vectors for init and expiry (ref core_vq.py:65-73): the
    rows `idx`, drawn from `generator` when not given. Under data
    parallelism `samples` is this rank's block of the global rows and the
    indices are global."""
    r, ranks = dp.rows()
    n = samples.shape[0]
    if idx is None:
        idx = _draw(n * ranks, num, generator, samples.device)
    idx = idx.to(samples.device)
    if ranks == 1:
        return samples[idx]
    local = idx - r * n
    mine = (local >= 0) & (local < n)
    rows = samples[local.clamp(0, n - 1)]
    return dp.sum(torch.where(mine[:, None], rows, torch.zeros_like(rows)))


def _stage_train(cfg: RVQConfig, residual: torch.Tensor, embed: torch.Tensor,
                 embed_avg: torch.Tensor, cluster_size: torch.Tensor,
                 generator: tp.Optional[torch.Generator] = None,
                 sample_idx: tp.Optional[torch.Tensor] = None,
                 plain: bool = False, margins: tp.Optional[list] = None,
                 dp: BatchReduce = LOCAL):
    """One RVQ stage in training mode (residual: [N, D]).

    Returns (quantized_st [N, D], codes [N] int64, commit_loss [], new
    (embed, embed_avg, cluster_size)). The codebook statistics carry no
    gradient; quantized_st passes the gradient straight through to the
    residual, and the commit loss pulls the residual to its code. The
    search's top-2 margins [N] are appended to `margins` when given. `dp`
reduces the statistics, the draws and the commit loss over the batch."""
    x = residual
    xd = x.detach()
    idx = _search(xd, embed, plain, margins)
    one_hot = _one_hot(idx, cfg.bins, x.dtype)
    quantized = embed[idx]

    # EMA codebook update (ref core_vq.py:240-252)
    cluster_size_new = (cluster_size * cfg.decay
                        + dp.sum(one_hot.sum(0)) * (1 - cfg.decay))
    embed_sum = dp.sum(one_hot.t() @ xd)
    embed_avg_new = embed_avg * cfg.decay + embed_sum * (1 - cfg.decay)
    n = cluster_size_new.sum()
    smoothed = ((cluster_size_new + cfg.epsilon)
                / (n + cfg.bins * cfg.epsilon) * n)
    embed_out = embed_avg_new / smoothed[:, None]

    # Dead-code expiry. Deliberate deviation from the reference, as in the
    # JAX package: its expiry write to `embed` is clobbered by the EMA copy
    # at the end of the same forward. Here under-used codes are replaced by
    # random batch vectors and the EMA average is kept consistent, so the
    # replacement survives the next normalization.
    if cfg.threshold_ema_dead_code > 0:
        expired = (cluster_size_new < cfg.threshold_ema_dead_code)[:, None]
        replacement = _sample_vectors(xd, cfg.bins, generator, sample_idx,
                                      dp)
        embed_out = torch.where(expired, replacement, embed_out)
        embed_avg_new = torch.where(expired, replacement * smoothed[:, None],
                                    embed_avg_new)

    # straight-through + commit loss (ref core_vq.py:316-346)
    quantized_st = x + (quantized - x).detach()
    commit_loss = dp.mean((quantized_st.detach() - x).square().mean())
    return (quantized_st, idx, commit_loss,
            (embed_out, embed_avg_new, cluster_size_new))


def rvq_forward(state: RVQState, x: torch.Tensor, cfg: RVQConfig, *,
                n_q: tp.Optional[int] = None, training: bool = True,
                generator: tp.Optional[torch.Generator] = None,
                plain: bool = False, init_idx: Draws = None,
                sample_idx: Draws = None,
                margins: tp.Optional[list] = None, dp: BatchReduce = LOCAL):
    """Full RVQ forward (the training semantics of the reference's
    `vq(x, n_q)`). x: [B, T, D] latents.

    Returns (quantized [B, T, D], codes [K, B, T] int32, commit_losses [K],
    new_state). `training=False` encodes with K2 and decodes, leaving the
    state as it is. Training draws from `generator`; `init_idx` (per book,
    the k-means seeds) and `sample_idx` (per stage, the expiry
    replacements) give the draws instead. With `margins` (a list), each
    training stage's top-2 search margins [B·T] are appended to it, for a
    near-tie guard when two routes are compared. `dp` spans the batch's
    reductions and draws over a data-parallel step's ranks (x is this
    rank's rows)."""
    n_q = _active_n_q(cfg, n_q)
    B, T, D = x.shape
    if not training:
        codes = rvq_encode(state, x.detach(), cfg, n_q=n_q, plain=plain)
        quantized = rvq_decode(state, codes, cfg)
        return quantized, codes, x.new_zeros(n_q), state
    flat = x.reshape(B * T, D)

    # Lazy k-means init on the first training batch (ref core_vq.py:142-153):
    # book k's k-means sees the RESIDUAL after the books before it quantize
    # with their fresh means, not the raw latents.
    if cfg.kmeans_init and not state.inited:
        residual = dp.gather(flat.detach())
        means, counts = [], []
        for k in range(cfg.num_books):
            m, c = _kmeans(residual, cfg.bins, cfg.kmeans_iters, generator,
                           None if init_idx is None else init_idx[k], plain)
            residual = residual - m[_search(residual, m, plain)]
            means.append(m)
            counts.append(c)
        embed = torch.stack(means)
        state = RVQState(embed, embed.clone(), torch.stack(counts), True)

    embed, embed_avg, csize = state.embed, state.embed_avg, state.cluster_size
    new_e, new_ea, new_cs = list(embed), list(embed_avg), list(csize)
    residual = flat
    qs, codes, commits = [], [], []
    for k in range(n_q):
        b = 0 if cfg.shared_codebook else k
        q, idx, commit, (new_e[b], new_ea[b], new_cs[b]) = _stage_train(
            cfg, residual, new_e[b], new_ea[b], new_cs[b], generator,
            None if sample_idx is None else sample_idx[k], plain, margins, dp)
        residual = residual - q
        qs.append(q)
        codes.append(idx)
        commits.append(commit)
    # stages beyond n_q keep their previous state
    new_state = RVQState(torch.stack(new_e), torch.stack(new_ea),
                         torch.stack(new_cs), state.inited)
    quantized = torch.stack(qs).sum(0).reshape(B, T, D)
    return (quantized, torch.stack(codes).to(torch.int32).reshape(n_q, B, T),
            torch.stack(commits), new_state)


def rvq_intermediate_results(state: RVQState, x: torch.Tensor,
                             cfg: RVQConfig, n_q: tp.Optional[int] = None
                             ) -> tp.Dict[str, torch.Tensor]:
    """Each stage's quantized output beside their sum (ref vq.py:80-89),
    the hierarchy probe of the visualization tools: `{"quantized" [B, T,
    D], "codes" [K, B, T], "quantized_stack" [K, B, T, D]}`; the codes
    from K2."""
    n_q = _active_n_q(cfg, n_q)
    codes = rvq_encode(state, x, cfg, n_q=n_q)
    if cfg.shared_codebook:
        stack = state.embed[0][codes.long()]
    else:
        stack = torch.stack([state.embed[k][codes[k].long()]
                             for k in range(n_q)])
    return {"quantized": stack.sum(dim=0), "codes": codes,
            "quantized_stack": stack}


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
