"""K3: the LSTM recurrence — CUDA kernel wrappers and their plain twin.

Replaces `encodec_tpu/kernels/lstm_pallas.py:55::lstm_scan_pallas`. Both
kernels are bounded by the T-step dependency chain, not by FLOPs or bytes,
and keep W_hh resident on the card for the whole launch. `lstm_scan`
picks one by the hidden size:

- H ≤ 512, the cluster kernel (`csrc/lstm_scan.cu`, laid out by
  `lstm_plan`): one thread-block cluster per sequence in flight. The
  cluster's CTAs (16 at H=512) split the hidden units, keep their rows of
  W_hh resident (three quarters in registers, the rest in shared memory),
  and send each step's h slice straight into every CTA's shared memory
  (`st.async` counted on the receiver's mbarrier): no grid-wide barrier,
  no L2 round trip. Sequences spread over as many clusters as the card
  holds at once.
- 512 < H ≤ 1024 (`GRID_MAX_H`), the grid kernel (`csrc/lstm_grid.cu`,
  laid out by `grid_plan`): W_hh (16 MiB at H=1024) is more than any
  cluster holds, so one cooperative grid of one CTA per SM splits the
  hidden units (H=1024: 128 CTAs of 8 units, their 32 gate rows in
  registers), computes its rows for every sequence each step, and
  exchanges h through L2 with one grid barrier per step. This is the
  breathing tokenizer's H (32·2⁵). A batch larger than the kernel's
  shared memory holds runs as several launches.

A CUDA call with H > 1024 raises. Both kernels start from zero state or,
unlike the TPU kernel, from a given `(h0, c0)`, and can return the final
state: a chunked stream carries `(h, c)` from one launch to the next, and
the split gives the same bits as one launch over the whole sequence.

`lstm_scan` is the entry point: for CPU tensors it runs the plain PyTorch
twin `lstm_scan_plain`; for CUDA tensors it launches a kernel or raises —
there is no fallback. `lstm_scan.launches` counts kernel launches of both
kernels, `lstm_scan.stateful_launches` those that started from a given
state, and `lstm_scan.grid_launches` those of the grid kernel.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from . import build
from .validate import SMEM_PER_BLOCK, check_tensor, require_same_device

# K3's layout; `csrc/lstm_scan.cu` reports the same numbers
# (lstm_scan_units_per_cta_max, _max_cluster, _reg_rows, _threads,
# _smem_bytes), which the card tests compare with these.
K3_WARPS = 8
K3_THREADS = 32 * K3_WARPS
K3_UNITS_PER_WARP = 4
K3_ROWS_PER_WARP = 4 * K3_UNITS_PER_WARP     # i, f, g, o rows of 4 units
K3_MAX_UNITS = K3_WARPS * K3_UNITS_PER_WARP  # 32 units per CTA
K3_REG_ROWS = 12                             # of each warp's 16 rows
K3_KCHUNK = 128                              # k covered by a float4 per lane
K3_MAX_H = 4 * K3_KCHUNK
K3_MAX_CLUSTER = 16                          # non-portable above 8

# The grid kernel's layout; `csrc/lstm_grid.cu` reports the same numbers
# (lstm_grid_threads, _max_units, _batch_tile, _max_batch, _max_h,
# _smem_bytes).
GRID_WARPS = 16
GRID_THREADS = 32 * GRID_WARPS
GRID_ROWS_PER_WARP = 2                       # W_hh rows per warp, registers
GRID_MAX_UNITS = GRID_WARPS * GRID_ROWS_PER_WARP // 4   # 8 units per CTA
GRID_BATCH_TILE = 8                          # sequences per matvec pass
GRID_MAX_BATCH = GRID_THREADS // GRID_MAX_UNITS         # a cell per thread
GRID_MAX_H = 8 * K3_KCHUNK                   # k slice: 8 float4s per lane


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


def lstm_scan_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                    h0: tp.Optional[torch.Tensor] = None,
                    c0: tp.Optional[torch.Tensor] = None,
                    return_state: bool = False):
    """The plain PyTorch twin of the kernel, with `lstm_scan`'s signature:
    the recurrence from `(h0, c0)` (zeros when not given)."""
    if h0 is None:
        h0 = c0 = xp.new_zeros(xp.shape[0], w_hh.shape[1])
    out, hT, cT = lstm_recurrence(xp, w_hh, h0, c0)
    return (out, hT, cT) if return_state else out


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """K3's launch: `n_clusters` clusters of `cluster` CTAs; CTA r owns
    hidden units `[r·units_per_cta, (r+1)·units_per_cta)` ∩ `[0, H)`, and
    cluster k runs batch items k, k + n_clusters, ..."""
    B: int
    H: int
    cluster: int
    units_per_cta: int
    n_clusters: int
    k_chunks: int
    reg_rows: int     # W_hh rows per CTA held in registers
    smem_rows: int    # W_hh rows per CTA held in shared memory
    smem_bytes: int

    def unit_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        u = self.units_per_cta
        return [(r * u, min(self.H, (r + 1) * u)) for r in range(self.cluster)]

    def batch_items(self) -> tp.List[tp.List[int]]:
        return [list(range(k, self.B, self.n_clusters))
                for k in range(self.n_clusters)]


def lstm_smem_bytes(H: int) -> int:
    """Dynamic shared memory of one K3 CTA: its shared W_hh rows and two h
    buffers, each zero-padded to a multiple of 128 floats, and the two
    buffers' mbarriers."""
    hp = -(-H // K3_KCHUNK) * K3_KCHUNK
    smem_rows = K3_WARPS * (K3_ROWS_PER_WARP - K3_REG_ROWS)
    return (smem_rows + 2) * hp * 4 + 2 * 8


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """The grid kernel's launches: `ctas` CTAs, CTA g owning hidden units
    `[g·units_per_cta, (g+1)·units_per_cta)` ∩ `[0, H)` for every sequence;
    the batch runs as `n_launches` launches of at most `batch_per_launch`
    sequences (`batch_ranges`), each with `smem_bytes` of shared memory."""
    B: int
    H: int
    ctas: int
    units_per_cta: int
    k_chunks: int
    batch_per_launch: int
    n_launches: int
    smem_bytes: int

    def unit_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        u = self.units_per_cta
        return [(g * u, min(self.H, (g + 1) * u)) for g in range(self.ctas)]

    def batch_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        n = self.batch_per_launch
        return [(b, min(self.B, b + n)) for b in range(0, self.B, n)]


def grid_smem_bytes(H: int, B: int) -> int:
    """Dynamic shared memory of one grid-kernel CTA for a launch of B
    sequences: h of every sequence, zero-padded to a multiple of 128 floats,
    and the 32 rows' recurrent sums, both for B rounded up to a multiple of
    the batch tile."""
    bp = -(-B // GRID_BATCH_TILE) * GRID_BATCH_TILE
    hp = -(-H // K3_KCHUNK) * K3_KCHUNK
    return bp * (hp + GRID_WARPS * GRID_ROWS_PER_WARP) * 4


def grid_max_batch(H: int) -> int:
    """The most sequences one grid launch takes at H: a multiple of the
    batch tile whose h fits one block's shared memory, at most one cell
    (unit, sequence) per thread (H=1024: 48; H ≤ 768: 64)."""
    b = GRID_MAX_BATCH
    while grid_smem_bytes(H, b) > SMEM_PER_BLOCK:
        b -= GRID_BATCH_TILE
    return b


def grid_plan(B: int, H: int, max_ctas: int) -> GridPlan:
    """Units per CTA = ceil(H / max_ctas) (≤ 8), so the grid is one CTA per
    SM or fewer (H=1024 on 132 SMs: 128 CTAs of 8 units; H=513: 129 of 4);
    the batch is split evenly over the fewest launches that fit."""
    if not K3_MAX_H < H <= GRID_MAX_H:
        raise ValueError(f"the K3 grid kernel takes {K3_MAX_H} < H <= "
                         f"{GRID_MAX_H}, got {H}")
    if max_ctas < 1:
        raise RuntimeError(f"the card cannot hold one K3 grid CTA "
                           f"(max co-resident CTAs {max_ctas})")
    units = -(-H // max_ctas)
    if units > GRID_MAX_UNITS:
        raise RuntimeError(
            f"the K3 grid kernel needs {-(-H // GRID_MAX_UNITS)} co-resident "
            f"CTAs at H={H}; the card holds {max_ctas}")
    n_launches = max(1, -(-B // grid_max_batch(H)))
    per_launch = max(1, -(-B // n_launches))
    return GridPlan(B=B, H=H, ctas=-(-H // units), units_per_cta=units,
                    k_chunks=-(-H // K3_KCHUNK), batch_per_launch=per_launch,
                    n_launches=n_launches,
                    smem_bytes=grid_smem_bytes(H, per_launch))


def lstm_plan(B: int, H: int, max_active_clusters: int) -> LstmPlan:
    """The cluster kernel's launch (H ≤ 512): the smallest power-of-two
    cluster whose CTAs (≤ 32 units each) cover H (H=512 → 16 CTAs of 32
    units; H=200 → 8 of 25), and one cluster per batch item up to what the
    card holds at once (`max_active_clusters`, from
    `cudaOccupancyMaxActiveClusters` on the card). Above 512 the grid
    kernel takes H (`grid_plan`)."""
    if not 1 <= H <= K3_MAX_H:
        raise ValueError(f"the K3 cluster kernel takes 1 <= H <= {K3_MAX_H}, "
                         f"got {H}")
    if max_active_clusters < 1:
        raise RuntimeError("the card cannot hold one K3 cluster "
                           f"(max active clusters {max_active_clusters})")
    cluster = 1
    while cluster * K3_MAX_UNITS < H:
        cluster *= 2
    k_chunks = -(-H // K3_KCHUNK)
    smem = lstm_smem_bytes(H)
    assert smem <= SMEM_PER_BLOCK
    return LstmPlan(B=B, H=H, cluster=cluster, units_per_cta=-(-H // cluster),
                    n_clusters=max(1, min(B, max_active_clusters)),
                    k_chunks=k_chunks,
                    reg_rows=K3_WARPS * K3_REG_ROWS,
                    smem_rows=K3_WARPS * (K3_ROWS_PER_WARP - K3_REG_ROWS),
                    smem_bytes=smem)


_MAX_ACTIVE: tp.Dict[tp.Tuple[int, int, int], int] = {}


def max_active_clusters(H: int, device: torch.device) -> int:
    """How many K3 clusters for H the card holds at once (cached)."""
    cluster = lstm_plan(1, H, 1).cluster
    key = (torch.cuda.current_device() if device.index is None
           else device.index, H, cluster)
    if key not in _MAX_ACTIVE:
        lib = build.load_library("lstm_scan")
        with torch.cuda.device(device):
            n = lib.lstm_scan_max_clusters(H, cluster)
        if n < 0:
            build.check(lib, "lstm_scan", -n)
        _MAX_ACTIVE[key] = n
    return _MAX_ACTIVE[key]


def max_grid_ctas(H: int, device: torch.device) -> int:
    """How many grid-kernel CTAs for H the card holds at once, at the most
    shared memory a launch at H uses (cached): SMs × CTAs per SM, from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    key = (torch.cuda.current_device() if device.index is None
           else device.index, H, -1)
    if key not in _MAX_ACTIVE:
        lib = build.load_library("lstm_grid")
        with torch.cuda.device(device):
            n = lib.lstm_grid_max_ctas(H, grid_max_batch(H))
        if n < 0:
            build.check(lib, "lstm_grid", -n)
        _MAX_ACTIVE[key] = n
    return _MAX_ACTIVE[key]


def _launch_grid(plan: GridPlan, xp, w_hh, h0, c0, out, c_out) -> None:
    """The grid kernel over the plan's batch ranges, one launch each, each
    with its own zeroed arrival counter."""
    lib = build.load_library("lstm_grid")
    counters = torch.zeros(plan.n_launches, device=xp.device,
                           dtype=torch.int32)
    stream = torch.cuda.current_stream(xp.device).cuda_stream

    def ptr(t, b0):
        return None if t is None else t[b0:].data_ptr()

    for i, (b0, b1) in enumerate(plan.batch_ranges()):
        rc = lib.lstm_grid_launch(
            ptr(xp, b0), w_hh.data_ptr(), ptr(h0, b0), ptr(c0, b0),
            ptr(out, b0), ptr(c_out, b0), counters[i:].data_ptr(), b1 - b0,
            xp.shape[1], plan.H, plan.units_per_cta, plan.ctas, stream)
        build.check(lib, "lstm_grid", rc)
        lstm_scan.launches += 1
        lstm_scan.grid_launches += 1
        if h0 is not None:
            lstm_scan.stateful_launches += 1


def lstm_scan(xp: torch.Tensor, w_hh: torch.Tensor,
              h0: tp.Optional[torch.Tensor] = None,
              c0: tp.Optional[torch.Tensor] = None,
              return_state: bool = False):
    """One LSTM layer's recurrence.

    xp: `[B, T, 4H]` f32 gate inputs (x W_ihᵀ + b_ih + b_hh); w_hh: `[4H, H]`
    f32 (torch layout); h0, c0: `[B, H]` f32 initial state, both or neither
    (zero state). Returns h `[B, T, H]` f32 or, with `return_state`,
    `(h, hT, cT)` (`hT` is the view `h[:, -1]`). All contiguous, on one
    device. On CUDA, H ≤ 512 runs one launch of the cluster kernel
    (`lstm_plan`), 512 < H ≤ 1024 the grid kernel (`grid_plan`: one launch
    per batch range)."""
    check_tensor("xp", xp, ndim=3)
    check_tensor("w_hh", w_hh, ndim=2)
    if (h0 is None) != (c0 is None):
        raise ValueError("pass both h0 and c0, or neither")
    state = () if h0 is None else (h0, c0)
    for name, t in zip(("h0", "c0"), state):
        check_tensor(name, t, ndim=2)
    require_same_device(xp, w_hh, *state)
    B, T, H4 = xp.shape
    H = w_hh.shape[1]
    if H4 != 4 * H or w_hh.shape[0] != H4:
        raise ValueError(f"shape mismatch: xp {tuple(xp.shape)}, "
                         f"w_hh {tuple(w_hh.shape)} (want [B,T,4H], [4H,H])")
    if any(tuple(t.shape) != (B, H) for t in state):
        raise ValueError(f"h0/c0 must be [B, H] = [{B}, {H}], got "
                         f"{[tuple(t.shape) for t in state]}")
    if xp.device.type == "cpu":
        return lstm_scan_plain(xp, w_hh, h0, c0, return_state)
    if not 1 <= H <= GRID_MAX_H:
        raise ValueError(f"the K3 kernels take 1 <= H <= {GRID_MAX_H}, "
                         f"got {H}")
    grid = H > K3_MAX_H
    plan = (grid_plan(B, H, max_grid_ctas(H, xp.device)) if grid
            else lstm_plan(B, H, max_active_clusters(H, xp.device)))
    out = torch.empty(B, T, H, device=xp.device, dtype=torch.float32)
    if B == 0 or T == 0:
        if not return_state:
            return out
        zero = xp.new_zeros(B, H)
        return (out, zero, zero) if h0 is None else (out, h0, c0)
    c_out = (torch.empty(B, H, device=xp.device, dtype=torch.float32)
             if return_state else None)
    with torch.cuda.device(xp.device):
        if grid:
            _launch_grid(plan, xp, w_hh, h0, c0, out, c_out)
            return (out, out[:, -1], c_out) if return_state else out
        lib = build.load_library("lstm_scan")
        rc = lib.lstm_scan_launch(
            xp.data_ptr(), w_hh.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            None if c0 is None else c0.data_ptr(), out.data_ptr(),
            None if c_out is None else c_out.data_ptr(), B, T, H,
            plan.cluster, plan.units_per_cta, plan.n_clusters,
            torch.cuda.current_stream(xp.device).cuda_stream)
    build.check(lib, "lstm_scan", rc)
    lstm_scan.launches += 1
    if h0 is not None:
        lstm_scan.stateful_launches += 1
    return (out, out[:, -1], c_out) if return_state else out


lstm_scan.launches = 0  # type: ignore[attr-defined]
lstm_scan.stateful_launches = 0  # type: ignore[attr-defined]
lstm_scan.grid_launches = 0  # type: ignore[attr-defined]
