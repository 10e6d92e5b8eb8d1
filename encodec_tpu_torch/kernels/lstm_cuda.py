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
  holds at once (7 at H=512 on an H100); above that count each cluster
  steps two sequences together (one pass over the weights feeds both)
  where that costs less than another wave of one (`cluster_batch`), so
  B ≤ 14 runs in one wave.
- 512 < H ≤ 1024 (`GRID_MAX_H`), the grid kernel (`csrc/lstm_grid.cu`,
  laid out by `grid_plan`): W_hh (16 MiB at H=1024) is more than any
  cluster holds, so one cooperative grid of one CTA per SM splits the
  hidden units (H=1024: 128 CTAs of 8 units, their 32 gate rows in
  registers, 8 rows x 8 k per lane), computes its rows for every sequence
  each step, and exchanges h through `out` in L2: launches of fewer than
  10 sequences poll `out` (filled with an empty mark first) for the words
  of h_{t-1}, larger ones wait on a barrier per step. This is the
  breathing tokenizer's H (32·2⁵). A batch larger than the kernel's shared
  memory holds runs as several launches.

A CUDA call with H > 1024 raises. Both kernels start from zero state or,
unlike the TPU kernel, from a given `(h0, c0)`, and can return the final
state: a chunked stream carries `(h, c)` from one launch to the next, and
the split gives the same bits as one launch over the whole sequence.

Training (`save_c=True`) runs a third compile-time variant of either
kernel that also stores every step's c `[B, T, H]` for the backward; its
`out` has the plain launch's bits.

The backward, `lstm_scan_backward`, has kernels of its own: the JAX
package has no TPU kernel for it (its trainer differentiates the
`lax.scan` of `encodec_tpu/ops/lstm.py:56-72`, and XLA runs the VJP). It
picks one by H, as `lstm_scan` does:

- H ≤ 512, the cluster backward (`csrc/lstm_bwd_cluster.cu`, laid out by
  `bwd_cluster_plan`): the forward's cluster design transposed. CTA r of
  a cluster holds the 4H × U slab of W_hh's columns of its units; each
  step every CTA sends its units' dgates_t to every CTA's shared memory
  (`st.async`), and each forms dh for its own units from the whole
  dgates vector. Sequences per cluster as in the forward
  (`cluster_batch`).
- 512 < H ≤ 1024, the grid backward (`csrc/lstm_bwd.cu`, laid out by
  `bwd_plan`): one cooperative grid of one CTA per SM, each CTA holding
  the gate rows of W_hh of its hidden units, writing its rows' products
  with dgates_t as partial sums to L2 and adding the partials of its own
  units after one grid barrier per step.

Their plain twin is `lstm_scan_backward_plain`. `ops.lstm` ties the two
directions together in a `torch.autograd.Function`.

`lstm_scan` and `lstm_scan_backward` are the entry points: for CPU tensors
they run the plain PyTorch twins; for CUDA tensors they launch a kernel or
raise — there is no fallback. `lstm_scan.launches` counts forward launches
of both kernels, `lstm_scan.stateful_launches` those that started from a
given state, `lstm_scan.grid_launches` those of the grid kernel and
`lstm_scan.save_launches` the saving ones; `lstm_scan_backward.launches`
counts backward launches and `lstm_scan_backward.cluster_launches` those
of the cluster backward. A CUDA call of `lstm_scan` whose inputs need a
gradient raises: the kernel's output carries none.
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
K3_MAX_SEQS = 2                              # sequences side by side per cluster
# a step of two sequences side by side, in steps of one, at H=512 on an
# H100 (PERF.md §6): what `cluster_batch` weighs a round of two by
K3_PAIR_STEP = 1.70                          # the forward
K3_BWD_PAIR_STEP = 1.56                      # the cluster backward

# The grid kernel's layout; `csrc/lstm_grid.cu` reports the same numbers
# (lstm_grid_threads, _max_units, _lane_rows, _lane_k, _batch_tile,
# _max_batch, _max_h, _smem_bytes). Its 16 warps are 4 row groups x 4 k
# slices; a lane holds 8 gate rows x 8 k of W_hh in registers.
GRID_WARPS = 16
GRID_THREADS = 32 * GRID_WARPS
GRID_ROW_GROUPS = 4                          # warp w: rows of group w % 4
GRID_LANE_ROWS = 8                           # W_hh rows per lane and warp
GRID_LANE_K = 8                              # k per lane: two float4s
GRID_HALF_SLICE = 128                        # the gap between them
GRID_K_SLICE = 32 * GRID_LANE_K              # 256 k per warp (w // 4)
GRID_MAX_UNITS = GRID_ROW_GROUPS * GRID_LANE_ROWS // 4  # 8 units per CTA
GRID_BATCH_TILE = 2                          # sequences per matvec pass
GRID_MAX_BATCH = GRID_THREADS // GRID_MAX_UNITS         # a cell per thread
GRID_SLICE_STRIDE = 40                       # floats per (k slice, sequence)
GRID_MAX_H = 4 * GRID_K_SLICE                # 1024
GRID_FENCED_BATCH = 10                       # from here: a barrier per step
# lanes are paired in this order whatever the batch tile
BUTTERFLY = (16, 8, 4, 2, 1)

# The cluster backward's layout (H ≤ 512) is the cluster kernel's: 8 warps
# of 4 units, each warp's 16 rows (the W_hh columns of its units in each
# gate block) split between registers and shared memory as `k3_reg_rows`
# says, k in float4 slices of 128; `csrc/lstm_bwd_cluster.cu` reports the
# same numbers (lstm_bwd_cluster_units_per_cta_max, _max_cluster,
# _reg_rows, _threads, _max_seqs, _smem_bytes).

# The grid backward's layout; `csrc/lstm_bwd.cu` reports the same numbers
# (lstm_bwd_threads, _max_units, _min_units, _cols, _batch_tile, _max_h,
# _max_ctas_limit, _smem_bytes). Thread x holds the CTA's
# 4U gate rows of W_hh at columns x and x + 512.
BWD_WARPS = 16
BWD_THREADS = 32 * BWD_WARPS
BWD_MAX_UNITS = 8                            # units (4U rows) per CTA
BWD_COLS = 2                                 # W_hh columns per thread
BWD_BATCH_TILE = 4                           # sequences per product pass
BWD_MAX_H = BWD_COLS * BWD_THREADS           # 1024
BWD_MAX_CTAS = 128                           # CTAs of one launch
BWD_MIN_UNITS = K3_MAX_H // BWD_MAX_CTAS + 1  # H > 512 on ≤ 128 CTAs: 5
BWD_CELL_INPUTS = 8                          # a cell's pre (4), c, c_prev, dy, dh
BWD_CHAINS = 16                              # of a cell's sum of partials


def k3_reg_rows(seqs: int) -> int:
    """W_hh rows per warp a cluster kernel (forward or backward) holds in
    registers: 12 of 16 with one sequence per cluster; with two, their
    accumulators take the registers of two rows, which move to shared
    memory."""
    return K3_REG_ROWS if seqs == 1 else K3_REG_ROWS - 2


def lstm_cell(h: torch.Tensor, c: torch.Tensor, gates: torch.Tensor
              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell update from pre-activation gates [B, 4H] (i, f, g, o)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor, save_c: bool = False):
    """Plain recurrence from state (h, c) [B, H]: returns (ys [B, T, H], hT,
    cT), and with `save_c` also every step's c [B, T, H].

    `gates = xp_t + h W_hhᵀ`, the reference's association order."""
    w_hh_t = w_hh.t()
    ys, cs = [], []
    for t in range(xp.shape[1]):
        h, c = lstm_cell(h, c, xp[:, t] + h @ w_hh_t)
        ys.append(h)
        cs.append(c)
    if not ys:
        empty = xp.new_zeros(xp.shape[0], 0, w_hh.shape[1])
        return (empty, h, c, empty) if save_c else (empty, h, c)
    out = torch.stack(ys, dim=1)
    return (out, h, c, torch.stack(cs, dim=1)) if save_c else (out, h, c)


def lstm_scan_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                    h0: tp.Optional[torch.Tensor] = None,
                    c0: tp.Optional[torch.Tensor] = None,
                    return_state: bool = False, save_c: bool = False):
    """The plain PyTorch twin of the kernel, with `lstm_scan`'s signature:
    the recurrence from `(h0, c0)` (zeros when not given)."""
    _check_modes(return_state, save_c)
    if h0 is None:
        h0 = c0 = xp.new_zeros(xp.shape[0], w_hh.shape[1])
    res = lstm_recurrence(xp, w_hh, h0, c0, save_c)
    if save_c:
        return res[0], res[3]
    return res if return_state else res[0]


def _check_modes(return_state: bool, save_c: bool) -> None:
    if return_state and save_c:
        raise ValueError("save_c returns every step's c; the final state is "
                         "(out[:, -1], c[:, -1]): pass one of return_state "
                         "and save_c")


def lstm_scan_backward_plain(pre: torch.Tensor, c_seq: torch.Tensor,
                             dy: torch.Tensor, w_hh: torch.Tensor,
                             c0: tp.Optional[torch.Tensor] = None,
                             dc_last: tp.Optional[torch.Tensor] = None):
    """The plain PyTorch twin of the backward kernel, with
    `lstm_scan_backward`'s signature: the reverse recurrence over the
    forward's pre-activations `pre` [B, T, 4H] and cell states `c_seq`
    [B, T, H], given `dy` [B, T, H] (the gradient of h) and `dc_last`
    (of the final c). Returns (dgates [B, T, 4H], dh0 [B, H], dc0 [B, H])."""
    B, T, H4 = pre.shape
    H = H4 // 4
    dgates = torch.empty_like(pre)
    dc = pre.new_zeros(B, H) if dc_last is None else dc_last
    c_prev0 = pre.new_zeros(B, H) if c0 is None else c0
    d_next = None
    for t in reversed(range(T)):
        dh = dy[:, t] if d_next is None else dy[:, t] + d_next @ w_hh
        a_i, a_f, a_g, a_o = pre[:, t].chunk(4, dim=-1)
        i, f, o = torch.sigmoid(a_i), torch.sigmoid(a_f), torch.sigmoid(a_o)
        g = torch.tanh(a_g)
        c_prev = c_seq[:, t - 1] if t > 0 else c_prev0
        tc = torch.tanh(c_seq[:, t])
        dc = dc + dh * o * (1.0 - tc * tc)
        d_next = torch.cat([dc * g * (i * (1.0 - i)),
                            dc * c_prev * (f * (1.0 - f)),
                            dc * i * (1.0 - g * g),
                            dh * tc * (o * (1.0 - o))], dim=-1)
        dgates[:, t] = d_next
        dc = dc * f
    dh0 = pre.new_zeros(B, H) if d_next is None else d_next @ w_hh
    return dgates, dh0, dc


class _ClusterBatch:
    """The batch of a cluster kernel's launch: cluster k takes batch items
    k, k + n_clusters, ... and runs them `seqs_per_cluster` side by side,
    in rounds (slot j of a round takes the round's j-th item)."""
    B: int
    H: int
    cluster: int
    units_per_cta: int
    seqs_per_cluster: int
    n_clusters: int

    def unit_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        u = self.units_per_cta
        return [(r * u, min(self.H, (r + 1) * u)) for r in range(self.cluster)]

    def batch_items(self) -> tp.List[tp.List[int]]:
        return [list(range(k, self.B, self.n_clusters))
                for k in range(self.n_clusters)]

    def rounds(self) -> tp.List[tp.List[tp.List[int]]]:
        """Per cluster, its items in rounds of at most `seqs_per_cluster`."""
        s = self.seqs_per_cluster
        return [[items[i:i + s] for i in range(0, len(items), s)]
                for items in self.batch_items()]

    @property
    def waves(self) -> int:
        """Rounds of the busiest cluster: T steps each (with all its
        clusters resident at once, the launch's time in units of one
        round)."""
        return max(len(r) for r in self.rounds())


@dataclasses.dataclass(frozen=True)
class LstmPlan(_ClusterBatch):
    """K3's launch: `n_clusters` clusters of `cluster` CTAs; CTA r owns
    hidden units `[r·units_per_cta, (r+1)·units_per_cta)` ∩ `[0, H)`, and
    cluster k runs batch items k, k + n_clusters, ..., `seqs_per_cluster`
    side by side (`rounds`)."""
    B: int
    H: int
    cluster: int
    units_per_cta: int
    seqs_per_cluster: int
    n_clusters: int
    k_chunks: int
    reg_rows: int     # W_hh rows per CTA held in registers
    smem_rows: int    # W_hh rows per CTA held in shared memory
    smem_bytes: int


def lstm_smem_bytes(H: int, seqs: int = 1) -> int:
    """Dynamic shared memory of one K3 CTA: its shared W_hh rows and, per
    sequence slot, two h buffers, each zero-padded to a multiple of 128
    floats, and the two buffers' mbarriers."""
    hp = -(-H // K3_KCHUNK) * K3_KCHUNK
    smem_rows = K3_WARPS * (K3_ROWS_PER_WARP - k3_reg_rows(seqs))
    return (smem_rows + 2 * seqs) * hp * 4 + 2 * seqs * 8


def _cluster_size(H: int) -> int:
    """The smallest power-of-two cluster whose CTAs (≤ 32 units each)
    cover H: 16 at H=512, 8 at H=200, 1 up to 32."""
    cluster = 1
    while cluster * K3_MAX_UNITS < H:
        cluster *= 2
    return cluster


def cluster_batch(B: int, max_active_clusters: int,
                  pair_step: float) -> tp.Tuple[int, int]:
    """(sequences per cluster, clusters) of a cluster kernel's launch: one
    sequence per cluster up to what the card holds at once; above it two
    per cluster on ceil(B / 2) clusters, at most that count, where their
    rounds at `pair_step` steps of one each cost less than ceil(B / count)
    waves of one (a round whose second slot is idle costs a pair step
    all the same). So B up to twice the count runs in one wave, and B
    between twice and three times it (15-21 at H=512 on an H100) runs
    three waves of one rather than two rounds of two."""
    n = max_active_clusters
    if B <= n:
        return 1, max(1, B)
    pairs = min(n, -(-B // K3_MAX_SEQS))
    rounds = -(-(-(-B // pairs)) // K3_MAX_SEQS)
    if rounds * pair_step < -(-B // n):
        return K3_MAX_SEQS, pairs
    return 1, n


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """The grid kernel's launches: `ctas` CTAs, CTA g owning hidden units
    `[g·units_per_cta, (g+1)·units_per_cta)` ∩ `[0, H)` for every sequence;
    the batch runs as `n_launches` launches of at most `batch_per_launch`
    sequences (`batch_ranges`), each with `smem_bytes` of shared memory.
    Inside a CTA, warp w holds rows `lane_rows(w)` over k slice w // 4
    (`k_slices` of them busy) and lane l the k of `lane_k(w, l)`; a launch
    of n sequences runs them in `batch_tiles(n)`."""
    B: int
    H: int
    ctas: int
    units_per_cta: int
    k_slices: int
    batch_per_launch: int
    n_launches: int
    smem_bytes: int

    def unit_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        u = self.units_per_cta
        return [(g * u, min(self.H, (g + 1) * u)) for g in range(self.ctas)]

    def batch_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        n = self.batch_per_launch
        return [(b, min(self.B, b + n)) for b in range(0, self.B, n)]

    def lane_rows(self, warp: int) -> tp.List[int]:
        """CTA rows q of warp `warp` (row q is gate q // U of the CTA's unit
        q % U; rows at or past 4U hold zeros)."""
        g = warp % GRID_ROW_GROUPS
        return list(range(g * GRID_LANE_ROWS, (g + 1) * GRID_LANE_ROWS))

    def lane_k(self, warp: int, lane: int) -> tp.List[int]:
        """The k of W_hh (and h) lane `lane` of warp `warp` holds: two
        float4s 128 apart in the warp's 256-k slice (zeros at k ≥ H)."""
        k = (warp // GRID_ROW_GROUPS) * GRID_K_SLICE + 4 * lane
        return [k + m * GRID_HALF_SLICE + e for m in range(2)
                for e in range(4)]

    def busy(self, warp: int) -> bool:
        """Whether warp `warp` has a valid row and k: idle warps skip the
        matvec."""
        return (warp % GRID_ROW_GROUPS) * GRID_LANE_ROWS < 4 * (
            self.units_per_cta) and warp // GRID_ROW_GROUPS < self.k_slices

    @staticmethod
    def fenced(n: int) -> bool:
        """Whether a launch of n copies h once after a barrier per step
        (n ≥ 10) rather than polling `out` for it."""
        return n >= GRID_FENCED_BATCH

    @staticmethod
    def batch_tiles(n: int) -> tp.List[int]:
        """Sequences per matvec pass for a launch of n: tiles of 2, a lone
        last sequence alone. The lanes' sums pair lanes in `BUTTERFLY`
        order and the k slices add in slice order whatever the tile, so a
        sequence's bits depend neither on its slot nor on n."""
        return [GRID_BATCH_TILE] * (n // GRID_BATCH_TILE) + [1] * (
            n % GRID_BATCH_TILE)


def grid_smem_bytes(H: int, B: int) -> int:
    """Dynamic shared memory of one grid-kernel CTA for a launch of B
    sequences: h of every sequence, zero-padded to whole 256-k slices, and
    the 4 k slices' row sums (40 floats per sequence each), both for B
    rounded up to the batch tile."""
    bp = -(-B // GRID_BATCH_TILE) * GRID_BATCH_TILE
    hp = -(-H // GRID_K_SLICE) * GRID_K_SLICE
    return bp * (hp + 4 * GRID_SLICE_STRIDE) * 4


def grid_max_batch(H: int) -> int:
    """The most sequences one grid launch takes at H: a multiple of the
    batch tile whose h fits one block's shared memory, at most one cell
    (unit, sequence) per thread (H > 768: 48; H ≤ 768: 64)."""
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
                    k_slices=-(-H // GRID_K_SLICE),
                    batch_per_launch=per_launch, n_launches=n_launches,
                    smem_bytes=grid_smem_bytes(H, per_launch))


def lstm_plan(B: int, H: int, max_active_clusters: int) -> LstmPlan:
    """The cluster kernel's launch (H ≤ 512): the smallest power-of-two
    cluster whose CTAs (≤ 32 units each) cover H (H=512 → 16 CTAs of 32
    units; H=200 → 8 of 25), and one cluster per batch item up to what the
    card holds at once (`max_active_clusters`, from
    `cudaOccupancyMaxActiveClusters` on the card), two per cluster above
    it where that is cheaper (`cluster_batch`). Above 512 the grid kernel
    takes H (`grid_plan`)."""
    if not 1 <= H <= K3_MAX_H:
        raise ValueError(f"the K3 cluster kernel takes 1 <= H <= {K3_MAX_H}, "
                         f"got {H}")
    if max_active_clusters < 1:
        raise RuntimeError("the card cannot hold one K3 cluster "
                           f"(max active clusters {max_active_clusters})")
    cluster = _cluster_size(H)
    seqs, n_clusters = cluster_batch(B, max_active_clusters, K3_PAIR_STEP)
    smem = lstm_smem_bytes(H, seqs)
    assert smem <= SMEM_PER_BLOCK
    return LstmPlan(B=B, H=H, cluster=cluster, units_per_cta=-(-H // cluster),
                    seqs_per_cluster=seqs, n_clusters=n_clusters,
                    k_chunks=-(-H // K3_KCHUNK),
                    reg_rows=K3_WARPS * k3_reg_rows(seqs),
                    smem_rows=K3_WARPS * (K3_ROWS_PER_WARP
                                          - k3_reg_rows(seqs)),
                    smem_bytes=smem)


_MAX_ACTIVE: tp.Dict[tp.Tuple[int, int, int], int] = {}


def max_active_clusters(H: int, device: torch.device) -> int:
    """How many K3 clusters for H the card holds at once (cached)."""
    cluster = _cluster_size(H)
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


def _launch_grid(plan: GridPlan, xp, w_hh, h0, c0, out, c_out, c_seq) -> None:
    """The grid kernel over the plan's batch ranges, one launch each with
    its own zeroed arrival counter (a launch that polls first fills its rows
    of `out` with the kernel's empty mark)."""
    lib = build.load_library("lstm_grid")
    counters = torch.zeros(plan.n_launches, device=xp.device,
                           dtype=torch.int32)
    stream = torch.cuda.current_stream(xp.device).cuda_stream

    def ptr(t, b0):
        return None if t is None else t[b0:].data_ptr()

    for i, (b0, b1) in enumerate(plan.batch_ranges()):
        rc = lib.lstm_grid_launch(
            ptr(xp, b0), w_hh.data_ptr(), ptr(h0, b0), ptr(c0, b0),
            ptr(out, b0), ptr(c_out, b0), ptr(c_seq, b0),
            counters[i:].data_ptr(), b1 - b0, xp.shape[1], plan.H,
            plan.units_per_cta, plan.ctas, stream)
        build.check(lib, "lstm_grid", rc)
        _count_forward(h0, c_seq)
        lstm_scan.grid_launches += 1


def _count_forward(h0, c_seq) -> None:
    lstm_scan.launches += 1
    if h0 is not None:
        lstm_scan.stateful_launches += 1
    if c_seq is not None:
        lstm_scan.save_launches += 1


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


def lstm_scan(xp: torch.Tensor, w_hh: torch.Tensor,
              h0: tp.Optional[torch.Tensor] = None,
              c0: tp.Optional[torch.Tensor] = None,
              return_state: bool = False, save_c: bool = False):
    """One LSTM layer's recurrence.

    xp: `[B, T, 4H]` f32 gate inputs (x W_ihᵀ + b_ih + b_hh); w_hh: `[4H, H]`
    f32 (torch layout); h0, c0: `[B, H]` f32 initial state, both or neither
    (zero state). Returns h `[B, T, H]` f32 or, with `return_state`,
    `(h, hT, cT)` (`hT` is the view `h[:, -1]`), or, with `save_c`,
    `(h, c)` with every step's c `[B, T, H]` (for the backward). All
    contiguous, on one device. On CUDA, H ≤ 512 runs one launch of the
    cluster kernel (`lstm_plan`), 512 < H ≤ 1024 the grid kernel
    (`grid_plan`: one launch per batch range). The result carries no
    gradient: a CUDA call whose inputs need one raises (train through
    `ops.lstm`)."""
    _check_modes(return_state, save_c)
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
        return lstm_scan_plain(xp, w_hh, h0, c0, return_state, save_c)
    if _needs_grad(xp, w_hh, *state):
        raise RuntimeError(
            "lstm_scan: the K3 kernel's output carries no gradient, and an "
            "input requires one; train through ops.lstm (its autograd "
            "function runs the backward kernel), or call under "
            "torch.no_grad()")
    if not 1 <= H <= GRID_MAX_H:
        raise ValueError(f"the K3 kernels take 1 <= H <= {GRID_MAX_H}, "
                         f"got {H}")
    grid = H > K3_MAX_H
    plan = (grid_plan(B, H, max_grid_ctas(H, xp.device)) if grid
            else lstm_plan(B, H, max_active_clusters(H, xp.device)))
    out = torch.empty(B, T, H, device=xp.device, dtype=torch.float32)
    c_seq = torch.empty_like(out) if save_c else None
    if B == 0 or T == 0:
        if save_c:
            return out, c_seq
        if not return_state:
            return out
        zero = xp.new_zeros(B, H)
        return (out, zero, zero) if h0 is None else (out, h0, c0)
    c_out = (torch.empty(B, H, device=xp.device, dtype=torch.float32)
             if return_state else None)

    def result():
        if save_c:
            return out, c_seq
        return (out, out[:, -1], c_out) if return_state else out

    with torch.cuda.device(xp.device):
        if grid:
            _launch_grid(plan, xp, w_hh, h0, c0, out, c_out, c_seq)
            return result()
        lib = build.load_library("lstm_scan")
        rc = lib.lstm_scan_launch(
            xp.data_ptr(), w_hh.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            None if c0 is None else c0.data_ptr(), out.data_ptr(),
            None if c_out is None else c_out.data_ptr(),
            None if c_seq is None else c_seq.data_ptr(), B, T, H,
            plan.cluster, plan.units_per_cta, plan.seqs_per_cluster,
            plan.n_clusters, torch.cuda.current_stream(xp.device).cuda_stream)
    build.check(lib, "lstm_scan", rc)
    _count_forward(h0, c_seq)
    return result()


lstm_scan.launches = 0  # type: ignore[attr-defined]
lstm_scan.stateful_launches = 0  # type: ignore[attr-defined]
lstm_scan.grid_launches = 0  # type: ignore[attr-defined]
lstm_scan.save_launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def bwd_route(H: int) -> str:
    """Which backward kernel takes H: "cluster" for H ≤ 512 (the forward's
    cluster kernel's range), "grid" for 512 < H ≤ 1024."""
    if not 1 <= H <= BWD_MAX_H:
        raise ValueError(f"the K3 backward kernels take 1 <= H <= "
                         f"{BWD_MAX_H}, got {H}")
    return "cluster" if H <= K3_MAX_H else "grid"


@dataclasses.dataclass(frozen=True)
class BwdClusterPlan(_ClusterBatch):
    """The cluster backward's launch (H ≤ 512): `n_clusters` clusters of
    `cluster` CTAs; CTA r owns hidden units `[r·units_per_cta,
    (r+1)·units_per_cta)` ∩ `[0, H)` and holds their columns of W_hh, all
    4H rows (`slab`); cluster k runs batch items k, k + n_clusters, ...,
    `seqs_per_cluster` side by side (`rounds`). Each step every CTA sends
    its units' 4 gates of dgates_t to every CTA, and dh of a unit is
    summed in `sum_order`."""
    B: int
    H: int
    cluster: int
    units_per_cta: int
    seqs_per_cluster: int
    n_clusters: int
    k_chunks: int
    reg_rows: int     # W_hh columns per CTA held in registers
    smem_rows: int    # W_hh columns per CTA held in shared memory
    smem_bytes: int

    def slab(self, rank: int) -> tp.List[tp.Tuple[int, int, str]]:
        """CTA `rank`'s part of W_hh [4H, H], the columns of its units over
        all 4H rows, as (gate g, unit u, where): W_hh[g·H : (g+1)·H, u],
        k < H of it at lane k // 4 % 32 of float4 slice k // 128. Warp w
        takes units w·4 .. w·4+3; its row q = g·4 + jj (unit w·4 + jj in
        gate g's block) lives in registers for q < `k3_reg_rows` (12 with one
        sequence per cluster, 10 with two), else in shared memory."""
        u0, u1 = self.unit_ranges()[rank]
        held = []
        for w in range(K3_WARPS):
            for q in range(K3_ROWS_PER_WARP):
                u = u0 + w * K3_UNITS_PER_WARP + (q & 3)
                if u < u1:
                    held.append((q >> 2, u, "reg" if q < k3_reg_rows(
                        self.seqs_per_cluster) else "smem"))
        return held

    @staticmethod
    def sum_order() -> tp.Tuple:
        """How dh_t of a unit is summed, the same in every slot and launch:
        each lane sums its k slice of a row (k = m·128 + 4·lane .. +3, m
        ascending, one fma chain), the butterfly pairs lanes xor 16, 8, 4,
        2 (folds) and 1, the unit's four gate sums add in gate order, then
        dy_t: (dy, (((i, f), g), o))."""
        return ("dy", ((("i", "f"), "g"), "o"))


def bwd_cluster_smem_bytes(H: int, seqs: int = 1) -> int:
    """Dynamic shared memory of one cluster-backward CTA: its shared W_hh
    columns and, per sequence slot, two dgates buffers (4 gate segments,
    each zero-padded to a multiple of 128 floats) and their mbarriers."""
    hp = -(-H // K3_KCHUNK) * K3_KCHUNK
    smem_rows = K3_WARPS * (K3_ROWS_PER_WARP - k3_reg_rows(seqs))
    return (smem_rows + 2 * seqs * 4) * hp * 4 + 2 * seqs * 8


def bwd_cluster_plan(B: int, H: int,
                     max_active_clusters: int) -> BwdClusterPlan:
    """The cluster backward's launch (H ≤ 512): the forward's cluster and
    units (H=512 → 16 CTAs of 32 units; H=200 → 8 of 25), one sequence per
    cluster up to what the card holds at once (`max_active_clusters`, from
    `cudaOccupancyMaxActiveClusters`), two above it where that is cheaper
    (`cluster_batch`): one launch for any B. Above 512 the grid backward
    takes H (`bwd_plan`)."""
    if bwd_route(H) != "cluster":
        raise ValueError(f"the K3 cluster backward takes 1 <= H <= "
                         f"{K3_MAX_H}, got {H}")
    if max_active_clusters < 1:
        raise RuntimeError("the card cannot hold one K3 backward cluster "
                           f"(max active clusters {max_active_clusters})")
    cluster = _cluster_size(H)
    seqs, n_clusters = cluster_batch(B, max_active_clusters,
                                     K3_BWD_PAIR_STEP)
    smem = bwd_cluster_smem_bytes(H, seqs)
    assert smem <= SMEM_PER_BLOCK
    return BwdClusterPlan(
        B=B, H=H, cluster=cluster, units_per_cta=-(-H // cluster),
        seqs_per_cluster=seqs, n_clusters=n_clusters,
        k_chunks=-(-H // K3_KCHUNK), reg_rows=K3_WARPS * k3_reg_rows(seqs),
        smem_rows=K3_WARPS * (K3_ROWS_PER_WARP - k3_reg_rows(seqs)),
        smem_bytes=smem)


def max_bwd_clusters(H: int, device: torch.device) -> int:
    """How many cluster-backward clusters for H the card holds at once
    (cached)."""
    cluster = _cluster_size(H)
    key = (torch.cuda.current_device() if device.index is None
           else device.index, H, -3 - cluster)
    if key not in _MAX_ACTIVE:
        lib = build.load_library("lstm_bwd_cluster")
        with torch.cuda.device(device):
            n = lib.lstm_bwd_cluster_max_clusters(H, cluster)
        if n < 0:
            build.check(lib, "lstm_bwd_cluster", -n)
        _MAX_ACTIVE[key] = n
    return _MAX_ACTIVE[key]


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's launches: `ctas` CTAs, CTA g owning hidden
    units `[g·units_per_cta, (g+1)·units_per_cta)` ∩ `[0, H)` (their 4U
    gate rows of W_hh, row q = gate q // U of unit q % U) for every
    sequence; thread x holds those rows at `thread_columns(x)`. Each step
    a CTA writes its rows' products with dgates_t, `[B, H]`, into one
    parity of a `partial_bytes` buffer laid out `[2][owner CTA][B][block]`
    (`partial_offset`), and adds the `ctas` partials of each of its units
    in `sum_chains` and `sum_tree` order. The batch runs as `n_launches` launches of at
    most `batch_per_launch` sequences (`batch_ranges`), each with
    `smem_bytes` of shared memory."""
    B: int
    H: int
    ctas: int
    units_per_cta: int
    batch_per_launch: int
    n_launches: int
    smem_bytes: int
    partial_bytes: int

    def unit_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        u = self.units_per_cta
        return [(g * u, min(self.H, (g + 1) * u)) for g in range(self.ctas)]

    def batch_ranges(self) -> tp.List[tp.Tuple[int, int]]:
        n = self.batch_per_launch
        return [(b, min(self.B, b + n)) for b in range(0, self.B, n)]

    def thread_columns(self, x: int) -> tp.List[int]:
        return [k for k in (x + c * BWD_THREADS for c in range(BWD_COLS))
                if k < self.H]

    def partial_offset(self, b: int, source: int, k: int) -> int:
        """Where CTA `source` writes its partial for sequence b, column k
        (a float index into one parity): in the block of k's owner, which
        reads `[b][source][unit]` contiguously."""
        U = self.units_per_cta
        sb = bwd_block_floats(self.ctas, U)
        owner = k // U
        return ((owner * self.batch_per_launch + b) * sb + source * U
                + k - owner * U)

    def sum_chains(self) -> tp.List[tp.List[int]]:
        """The order a unit's partials are added: 16 chains of sources in
        source order (`sum_tree` combines them), then added to dy."""
        return [list(range(j, self.ctas, BWD_CHAINS))
                for j in range(BWD_CHAINS)]

    @staticmethod
    def sum_tree() -> tp.Tuple:
        """How the 16 chains are combined: in pairs, pairs of pairs, ...
        (nested tuples of chain indices), whether 16 threads add them by
        shuffles xor 1, 2, 4, 8 (B·U ≤ 32) or one thread does."""
        level: tp.List[tp.Any] = list(range(BWD_CHAINS))
        while len(level) > 1:
            level = [(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        return level[0]

    def spread(self) -> bool:
        """Whether 16 threads take each cell's sum (few cells)."""
        return (self.batch_per_launch * self.units_per_cta * BWD_CHAINS
                <= BWD_THREADS)

    @staticmethod
    def batch_tiles(n: int) -> tp.List[int]:
        """Sequences per product pass for a launch of n: tiles of 4, then
        one at a time; each sequence's products sum the rows in q order
        whatever its tile."""
        return [BWD_BATCH_TILE] * (n // BWD_BATCH_TILE) + [1] * (
            n % BWD_BATCH_TILE)


def bwd_block_floats(ctas: int, units: int) -> int:
    """One (owner CTA, sequence) block of partials: every source's units,
    padded to whole float4s."""
    return -(-ctas * units // 4) * 4


def bwd_smem_bytes(B: int, ctas: int, units: int) -> int:
    """Dynamic shared memory of one backward CTA for a launch of B
    sequences: dgates_t of its 32 rows and its block of partials per
    sequence (its row padded by the units rounded up to 4, so a warp's
    cells read distinct banks), and 8 inputs of the coming step per cell."""
    stride = bwd_block_floats(ctas, units) + -(-units // 4) * 4
    return B * (4 * BWD_MAX_UNITS + stride + BWD_CELL_INPUTS * units) * 4


def bwd_max_batch(ctas: int, units: int) -> int:
    """The most sequences one backward launch takes: a cell (unit,
    sequence) per thread, and the partials in shared memory (H=1024: 51)."""
    b = BWD_THREADS // units
    while bwd_smem_bytes(b, ctas, units) > SMEM_PER_BLOCK:
        b -= 1
    return b


def bwd_plan(B: int, H: int, max_ctas: int) -> BwdPlan:
    """The grid backward's launches (512 < H ≤ 1024): units per CTA =
    ceil(H / min(max_ctas, 128)) (≤ 8), so the grid is one CTA per SM or
    fewer (H=1024 on 132 SMs: 128 CTAs of 8 units; H=513: 103 of 5); the
    batch is split evenly over the fewest launches that fit
    (`bwd_max_batch`). H ≤ 512 is the cluster backward's
    (`bwd_cluster_plan`)."""
    if bwd_route(H) != "grid":
        raise ValueError(f"the K3 grid backward takes {K3_MAX_H} < H <= "
                         f"{BWD_MAX_H}, got {H}")
    if max_ctas < 1:
        raise RuntimeError(f"the card cannot hold one K3 backward CTA "
                           f"(max co-resident CTAs {max_ctas})")
    units = -(-H // min(max_ctas, BWD_MAX_CTAS))
    if units > BWD_MAX_UNITS:
        raise RuntimeError(
            f"the K3 backward kernel needs {-(-H // BWD_MAX_UNITS)} "
            f"co-resident CTAs at H={H}; the card holds {max_ctas}")
    ctas = -(-H // units)
    n_launches = max(1, -(-B // bwd_max_batch(ctas, units)))
    per_launch = max(1, -(-B // n_launches))
    return BwdPlan(B=B, H=H, ctas=ctas, units_per_cta=units,
                   batch_per_launch=per_launch, n_launches=n_launches,
                   smem_bytes=bwd_smem_bytes(per_launch, ctas, units),
                   partial_bytes=2 * ctas * per_launch
                   * bwd_block_floats(ctas, units) * 4)


def max_bwd_ctas(H: int, device: torch.device) -> int:
    """How many backward CTAs for H the card holds at once, at the most
    shared memory a launch uses (cached): SMs × CTAs per SM of the
    instance for ceil(H / min(SMs, 128)) units, from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    key = (torch.cuda.current_device() if device.index is None
           else device.index, H, -2)
    if key not in _MAX_ACTIVE:
        lib = build.load_library("lstm_bwd")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        units = min(BWD_MAX_UNITS, -(-H // min(sms, BWD_MAX_CTAS)))
        ctas = -(-H // units)
        with torch.cuda.device(device):
            n = lib.lstm_bwd_max_ctas(units, bwd_max_batch(ctas, units),
                                      ctas)
        if n < 0:
            build.check(lib, "lstm_bwd", -n)
        _MAX_ACTIVE[key] = n
    return _MAX_ACTIVE[key]


def lstm_scan_backward(pre: torch.Tensor, c_seq: torch.Tensor,
                       dy: torch.Tensor, w_hh: torch.Tensor,
                       c0: tp.Optional[torch.Tensor] = None,
                       dc_last: tp.Optional[torch.Tensor] = None,
                       state_grad: bool = True):
    """The gradient of one LSTM layer's recurrence (the backward kernels).

    pre: `[B, T, 4H]` the forward's pre-activations `xp + [h0; h_{<T-1}]
    W_hhᵀ`; c_seq: `[B, T, H]` its cell states (`lstm_scan(save_c=True)`);
    dy: `[B, T, H]` the gradient of its h outputs; w_hh: `[4H, H]`; c0:
    `[B, H]` its initial c (None: zero state); dc_last: `[B, H]` the
    gradient of its final c (None: zero). All f32, contiguous, on one
    device. Returns (dgates `[B, T, 4H]` — the gradient of xp —, dh0, dc0
    `[B, H]`, both None when not `state_grad`); dW_hh is `dgatesᵀ [h0;
    h_{<T-1}]`, one matmul outside. On CUDA, H ≤ 512 runs one launch of
    the cluster backward (`bwd_cluster_plan`), 512 < H ≤ 1024 the grid
    backward (`bwd_plan`: one launch per batch range, with
    `plan.partial_bytes` of scratch)."""
    check_tensor("pre", pre, ndim=3)
    check_tensor("w_hh", w_hh, ndim=2)
    B, T, H4 = pre.shape
    H = w_hh.shape[1]
    if H4 != 4 * H or tuple(w_hh.shape) != (H4, H):
        raise ValueError(f"shape mismatch: pre {tuple(pre.shape)}, "
                         f"w_hh {tuple(w_hh.shape)} (want [B,T,4H], [4H,H])")
    for name, t in (("c_seq", c_seq), ("dy", dy)):
        check_tensor(name, t, ndim=3)
        if tuple(t.shape) != (B, T, H):
            raise ValueError(f"{name} must be [B, T, H] = [{B}, {T}, {H}], "
                             f"got {tuple(t.shape)}")
    state = [t for t in (c0, dc_last) if t is not None]
    for t in state:
        check_tensor("c0/dc_last", t, ndim=2)
        if tuple(t.shape) != (B, H):
            raise ValueError(f"c0/dc_last must be [B, H] = [{B}, {H}], got "
                             f"{tuple(t.shape)}")
    require_same_device(pre, c_seq, dy, w_hh, *state)
    if pre.device.type == "cpu":
        dgates, dh0, dc0 = lstm_scan_backward_plain(pre, c_seq, dy, w_hh, c0,
                                                    dc_last)
        return (dgates, dh0, dc0) if state_grad else (dgates, None, None)
    cluster = bwd_route(H) == "cluster"
    plan = (bwd_cluster_plan(B, H, max_bwd_clusters(H, pre.device))
            if cluster else bwd_plan(B, H, max_bwd_ctas(H, pre.device)))
    dgates = torch.empty_like(pre)
    dh0 = pre.new_zeros(B, H) if state_grad else None
    dc0 = None
    if state_grad:
        dc0 = pre.new_zeros(B, H) if dc_last is None else dc_last.clone()
    if B == 0 or T == 0:
        return dgates, dh0, dc0
    if cluster:
        _launch_bwd_cluster(plan, pre, c_seq, c0, dy, dc_last, w_hh, dgates,
                            dh0, dc0)
        return dgates, dh0, dc0
    lib = build.load_library("lstm_bwd")
    counters = torch.zeros(plan.n_launches, device=pre.device,
                           dtype=torch.int32)
    part = torch.empty(plan.partial_bytes // 4, device=pre.device,
                       dtype=torch.float32)   # 16-byte aligned

    def ptr(t, b0):
        return None if t is None else t[b0:].data_ptr()

    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        for i, (b0, b1) in enumerate(plan.batch_ranges()):
            rc = lib.lstm_bwd_launch(
                ptr(pre, b0), ptr(c_seq, b0), ptr(c0, b0), ptr(dy, b0),
                ptr(dc_last, b0), w_hh.data_ptr(), ptr(dgates, b0),
                ptr(dh0, b0), ptr(dc0, b0), part.data_ptr(),
                counters[i:].data_ptr(), b1 - b0, T, H, plan.units_per_cta,
                plan.ctas, stream)
            build.check(lib, "lstm_bwd", rc)
            lstm_scan_backward.launches += 1
    return dgates, dh0, dc0


def _launch_bwd_cluster(plan: BwdClusterPlan, pre, c_seq, c0, dy, dc_last,
                        w_hh, dgates, dh0, dc0) -> None:
    """One launch of the cluster backward over the whole batch."""
    lib = build.load_library("lstm_bwd_cluster")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(pre.device):
        rc = lib.lstm_bwd_cluster_launch(
            pre.data_ptr(), c_seq.data_ptr(), ptr(c0), dy.data_ptr(),
            ptr(dc_last), w_hh.data_ptr(), dgates.data_ptr(), ptr(dh0),
            ptr(dc0), plan.B, pre.shape[1], plan.H, plan.cluster,
            plan.units_per_cta, plan.seqs_per_cluster, plan.n_clusters,
            torch.cuda.current_stream(pre.device).cuda_stream)
    build.check(lib, "lstm_bwd_cluster", rc)
    lstm_scan_backward.launches += 1
    lstm_scan_backward.cluster_launches += 1


lstm_scan_backward.launches = 0  # type: ignore[attr-defined]
lstm_scan_backward.cluster_launches = 0  # type: ignore[attr-defined]
