"""K1 and K2: RVQ codebook search — CUDA kernel wrappers and plain twins.

K1 `nearest_codebook` replaces
`encodec_tpu/kernels/vq_pallas.py:43::nearest_codebook_pallas`, extended to
return the top-2 margin the container writer's near-tie guard reads, and
on request the winner's score (its negated distance, the number the search
compared), on which `parallel.tp` merges codebook shards. K2
`rvq_encode_fused` replaces `vq_pallas.py:124::rvq_encode_pallas`: every
stage in one launch with the residual kept on chip. Both kernels live in
`csrc/vq_search.cu`; their work is bounded by FP32 FFMA throughput
(full-f32 dots are required for code parity), and they keep the
`[N, bins]` distance matrix out of device memory (see the source).

Both are one cluster split-bins search: a thread-block cluster of up to 8
CTAs shares a 32-row tile and each CTA searches one slice of the bins with
a 4×4 register tile fed by float4 shared loads from a cp.async ring; the
CTAs merge their results through distributed shared memory, lowest index
first on exact ties. K2 runs that search once per stage, with the residual
tile held in every CTA of the cluster for all stages and one cluster
barrier per stage, so its codes equal K1's run once per stage with the
f32 update `r −= E[idx]` (`rvq_encode_margins`) bit for bit. `nearest_plan`
and `rvq_plan` size the launches: the largest cluster that keeps the grid
within one wave of CTA slots, so at the main path's N=750 (a 10 s request)
24 row tiles become 192 CTAs.

K1 has a second route for the shapes where the 32-row tiles fill a wave of
slots and the split would be C=1 (training's D=256 searches over tens of
thousands of rows): the row-block kernel, one CTA of 256 threads per 128
rows walking all of its bins in tiles of 128, D streamed in k-slabs of 32
through a 4-deep cp.async ring, an 8×8 register tile per thread, ‖x‖² and
‖e‖² computed once per CTA; clusters of up to 8 CTAs split the bins where
the row blocks leave a wave's tail (`_rowblock_plan`). Its indices,
margins and scores equal the cluster route's bit for bit (the same fmaf
chains). `nearest_plan` chooses the route from (N, bins, D, SMs) alone;
there is no switch.

For CPU tensors the wrappers run the plain PyTorch twins; for CUDA tensors
they launch the kernel or raise — no fallback. `<wrapper>.launches` counts
kernel launches; `nearest_codebook.rowblock_launches` counts those of
K1's row-block route.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as tp

import torch

from . import build
from .validate import SMEM_PER_BLOCK, check_tensor, require_same_device

# The search's layout, shared by K1 and K2; `csrc/vq_search.cu` reports
# the same numbers (vq_nearest_* and vq_rvq_*: rows_per_cta, tile_bins,
# threads, max_cluster, smem_bytes), which the card tests compare with
# these.
K1_ROWS = 32          # rows of x per cluster tile
K1_TILE_BINS = 64     # bins per shared-memory ring stage
K1_STAGES = 2
K1_THREADS = 128      # 8 row groups x 16 bin groups, 4x4 outputs each
K1_MAX_CLUSTER = 8    # the portable cluster size
SMEM_PER_SM = 233_472  # shared memory of one SM (228 KB)
SMEM_RESERVED = 1_024  # per resident CTA, reserved by the runtime

# K1's row-block route (`vq_nearest_rowblock_kernel`; the source reports
# the same numbers through vq_rowblock_*).
K1R_ROWS = 128         # rows of x per CTA
K1R_TILE_BINS = 128    # bins per tile
K1R_SLAB = 32          # columns of D per k-slab
K1R_STAGES = 4         # k-slabs in flight
K1R_THREADS = 256      # 16 row groups x 16 bin groups, 8x8 outputs each
K1R_CTAS_PER_SM = 1    # what its registers allow


def _tiles_bytes(D: int) -> int:
    """The row tile and the ring, rows padded to a stride of 4·(odd)
    floats (conflict-free float4 loads)."""
    ld = 4 * ((((D + 3) // 4) + 1) | 1)
    return (K1_ROWS + K1_STAGES * K1_TILE_BINS) * ld * 4


def nearest_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one K1 CTA: the row tile and the ring, plus
    four 32-float arrays (‖x‖², and the slice's best, index, runner-up)."""
    return _tiles_bytes(D) + 4 * K1_ROWS * 4


def rowblock_smem_bytes() -> int:
    """Dynamic shared memory of one row-block CTA, the same for every D:
    the ring of k-slabs (128 rows and 128 bins of 32 columns, padded to
    36), ‖x‖² and ‖e‖² [128] each, and the CTA's best, index and runner-up
    [128] each."""
    slab = (K1R_ROWS + K1R_TILE_BINS) * (K1R_SLAB + 4)
    return (K1R_STAGES * slab + K1R_ROWS + K1R_TILE_BINS + 3 * K1R_ROWS) * 4


def rvq_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one K2 CTA: the residual tile and the ring,
    plus ‖x‖² [32], two stage buffers of 32 (best, index) pairs, and the
    merged indices [32]."""
    return _tiles_bytes(D) + 6 * K1_ROWS * 4


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """A K1 or K2 launch: `row_tiles` clusters of `cluster` CTAs; CTA r of a
    cluster searches bins `[r·bins_per_cta, min(bins, (r+1)·bins_per_cta))`
    for the cluster's `rows` rows. `route` is "cluster" (32-row tiles, the
    split-bins kernel) or "rowblock" (K1's 128-row blocks)."""
    N: int
    bins: int
    row_tiles: int
    cluster: int
    bins_per_cta: int
    smem_bytes: int
    route: str = "cluster"
    rows: int = K1_ROWS

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.cluster

    def bin_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        p = self.bins_per_cta
        return [(r * p, min(self.bins, (r + 1) * p))
                for r in range(self.cluster)]

    def row_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        return [(i * self.rows, min(self.N, (i + 1) * self.rows))
                for i in range(self.row_tiles)]


def _slots(sm_count: int, smem: int) -> int:
    """Resident CTAs on the card, by shared memory."""
    return sm_count * (SMEM_PER_SM // (smem + SMEM_RESERVED))


def _split_plan(kernel: str, N: int, bins: int, D: int, sm_count: int,
                smem: int) -> SearchPlan:
    """Split the bins over the largest cluster (≤ 8 CTAs, each at least one
    64-bin stage) that keeps the grid within one wave of CTA slots on
    `sm_count` SMs; with more row tiles than slots, no split (C=1)."""
    if N < 0 or bins < 1 or D < 1 or sm_count < 1:
        raise ValueError(f"bad {kernel} shape N={N} bins={bins} D={D} "
                         f"sm_count={sm_count}")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{kernel}: D={D} needs {smem} B of shared memory "
                         f"per CTA (at most {SMEM_PER_BLOCK})")
    row_tiles = -(-N // K1_ROWS)
    cluster = max(1, min(K1_MAX_CLUSTER, -(-bins // K1_TILE_BINS),
                         _slots(sm_count, smem) // max(1, row_tiles)))
    return SearchPlan(N=N, bins=bins, row_tiles=row_tiles, cluster=cluster,
                      bins_per_cta=-(-bins // cluster), smem_bytes=smem)


def _rowblock_plan(N: int, bins: int, sm_count: int) -> SearchPlan:
    """K1's row-block route: 128-row blocks, each a cluster of C CTAs that
    split the bins, with the C (≤ 8, each CTA at least one bin) that gives
    the fewest waves × bin tiles per CTA, the smallest on a tie: C=2 where
    the row blocks alone would leave a second wave a third full. A wave is
    `sm_count / C` clusters: exact for C ≤ 2, while the H100 holds only
    39, 30 and 15 clusters of 3, 4 and 8 (the crossover's small N)."""
    row_tiles = -(-N // K1R_ROWS)
    slots = sm_count * K1R_CTAS_PER_SM
    best = None
    for c in range(1, min(K1_MAX_CLUSTER, -(-bins // K1R_TILE_BINS)) + 1):
        per = -(-bins // c)
        if (c - 1) * per >= bins:
            continue
        cost = -(-row_tiles * c // slots) * -(-per // K1R_TILE_BINS)
        if best is None or cost < best[0]:
            best = (cost, c, per)
    _, cluster, per = best
    return SearchPlan(N=N, bins=bins, row_tiles=row_tiles, cluster=cluster,
                      bins_per_cta=per, smem_bytes=rowblock_smem_bytes(),
                      route="rowblock", rows=K1R_ROWS)


@functools.lru_cache(maxsize=256)
def nearest_plan(N: int, bins: int, D: int, sm_count: int) -> SearchPlan:
    """K1's launch: the cluster split (`_split_plan`) while the 32-row
    tiles leave room for two CTAs per tile in a wave of slots; past that,
    where the split would be C=1, the row-block route (`_rowblock_plan`).
    D ≤ 352 on both."""
    plan = _split_plan("K1", N, bins, D, sm_count, nearest_smem_bytes(D))
    if 2 * plan.row_tiles > _slots(sm_count, plan.smem_bytes):
        return _rowblock_plan(N, bins, sm_count)
    return plan


def _route_plan(route: tp.Optional[str], N: int, bins: int, D: int,
                sm_count: int) -> SearchPlan:
    """`nearest_plan`, or (tests only) the plan of the given route."""
    if route is None:
        return nearest_plan(N, bins, D, sm_count)
    # the split plan also refuses what neither kernel takes
    split = _split_plan("K1", N, bins, D, sm_count, nearest_smem_bytes(D))
    if route == "cluster":
        return split
    if route == "rowblock":
        return _rowblock_plan(N, bins, sm_count)
    raise ValueError(f"unknown K1 route {route!r}")


@functools.lru_cache(maxsize=256)
def rvq_plan(N: int, bins: int, D: int, sm_count: int) -> SearchPlan:
    """K2's launch (see `_split_plan`), from K2's own shared memory; the
    same split serves every stage. D ≤ 352."""
    return _split_plan("K2", N, bins, D, sm_count, rvq_smem_bytes(D))


def distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Negated squared distances `[N, bins]` in the reference association
    order `-((‖x‖² - 2·x·Eᵀ) + ‖E‖²)`."""
    x_sq = x.square().sum(1, keepdim=True)
    e_sq = embed.square().sum(1)[None, :]
    return -((x_sq - 2.0 * (x @ embed.t())) + e_sq)


def nearest_codebook_plain(x: torch.Tensor, embed: torch.Tensor,
                           return_score: bool = False) -> tp.Tuple:
    """Plain twin of K1: (idx int32 [N], margin f32 [N]), and with
    `return_score` the winner's score f32 [N].

    `idx` is the first maximum of the negated distance (`score` is that
    maximum); `margin` is `best - max over j != idx` (0 on an exact tie)."""
    dist = distances(x, embed)
    best, idx = dist.max(dim=1)
    if dist.shape[1] > 1:
        second = dist.scatter(1, idx[:, None], float("-inf")).amax(dim=1)
    else:
        second = torch.full_like(best, float("-inf"))
    if return_score:
        return idx.to(torch.int32), best - second, best
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_search(x: torch.Tensor, embed: torch.Tensor, book_dims: int) -> None:
    check_tensor("x", x, ndim=2)
    check_tensor("embed", embed, ndim=book_dims)
    require_same_device(x, embed)
    if embed.shape[-1] != x.shape[1]:
        raise ValueError(f"dimension mismatch: x {tuple(x.shape)}, "
                         f"embed {tuple(embed.shape)}")
    if embed.shape[-2] < 1:
        raise ValueError("empty codebook")


def nearest_codebook(x: torch.Tensor, embed: torch.Tensor,
                     return_score: bool = False,
                     _route: tp.Optional[str] = None) -> tp.Tuple:
    """K1: nearest codebook row and top-2 margin for each row of x.

    x: `[N, D]` f32, embed: `[bins, D]` f32, contiguous, one device.
    Returns (idx int32 `[N]`, margin f32 `[N]`): the first maximum of the
    negated distance and best minus runner-up (0 on an exact tie); with
    `return_score` also that maximum, the winner's score f32 `[N]`. On
    CUDA the launch follows `nearest_plan` (cluster or row-block route,
    the same bits); D is limited by shared memory (D ≤ 352). `_route`
    ("cluster" or "rowblock") is for tests that compare the routes."""
    _check_search(x, embed, 2)
    if x.device.type == "cpu":
        return nearest_codebook_plain(x, embed, return_score)
    lib = build.load_library("vq_search")
    N, D = x.shape
    plan = _route_plan(_route, N, embed.shape[0], D, _sm_count(x.device))
    launch = (lib.vq_rowblock_launch if plan.route == "rowblock"
              else lib.vq_nearest_launch)
    idx = torch.empty(N, dtype=torch.int32, device=x.device)
    margin = torch.empty(N, dtype=torch.float32, device=x.device)
    score = (torch.empty(N, dtype=torch.float32, device=x.device)
             if return_score else None)
    out = (idx, margin, score) if return_score else (idx, margin)
    if N == 0:
        return out
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), embed.data_ptr(), N, embed.shape[0], D,
            plan.cluster, plan.bins_per_cta, idx.data_ptr(), margin.data_ptr(),
            score.data_ptr() if score is not None else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "vq_search", rc)
    nearest_codebook.launches += 1
    if plan.route == "rowblock":
        nearest_codebook.rowblock_launches += 1
    return out


def rvq_encode_fused(x: torch.Tensor, embed: torch.Tensor, n_q: int,
                     shared: bool = False) -> torch.Tensor:
    """K2: full residual-VQ encode in one launch.

    x: `[N, D]` f32; embed: `[n_books, bins, D]` f32 (book 0 reused for
    every stage when `shared`). Returns codes `[n_q, N]` int32: on CUDA
    the same codes as K1 run once per stage with the f32 update
    `r −= E[idx]`, bit for bit. The launch follows `rvq_plan`; D ≤ 352."""
    _check_search(x, embed, 3)
    books_needed = min(n_q, 1) if shared else n_q
    if n_q < 0 or books_needed > embed.shape[0]:
        raise ValueError(f"n_q={n_q} but {embed.shape[0]} codebooks")
    if x.device.type == "cpu":
        return rvq_encode_fused_plain(x, embed, n_q, shared)
    lib = build.load_library("vq_search")
    N, D = x.shape
    plan = rvq_plan(N, embed.shape[1], D, _sm_count(x.device))
    codes = torch.empty(n_q, N, dtype=torch.int32, device=x.device)
    if N == 0 or n_q == 0:
        return codes
    with torch.cuda.device(x.device):
        rc = lib.vq_rvq_launch(
            x.data_ptr(), embed.data_ptr(), N, embed.shape[1], D, n_q,
            int(shared), plan.cluster, plan.bins_per_cta, codes.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "vq_search", rc)
    rvq_encode_fused.launches += 1
    return codes


nearest_codebook.launches = 0  # type: ignore[attr-defined]
nearest_codebook.rowblock_launches = 0  # type: ignore[attr-defined]
rvq_encode_fused.launches = 0  # type: ignore[attr-defined]
