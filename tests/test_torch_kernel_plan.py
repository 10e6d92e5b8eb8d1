"""Launch planning of the hand-written kernels, which stays in Python and so
is checked here on the CPU (the kernels themselves run only on the GPU:
`tests/test_torch_cuda.py`, which also checks that each kernel reports the
layout constants these plans assume).

K1 (`vq_cuda.nearest_plan`) and K2 (`vq_cuda.rvq_plan`): row tiles and
the cluster's split of the bins, each from its kernel's shared memory.
K3: for H ≤ 512 the cluster kernel (`lstm_cuda.lstm_plan`: units per
CTA, the register/shared-memory split of W_hh, the h messages between the
cluster's CTAs, and the batch spread over clusters, one or two sequences
per cluster); for 512 < H ≤ 1024 the grid kernel (`lstm_cuda.grid_plan`:
CTAs, units per CTA, the batch per launch); K3's backward kernels, chosen
by H (`lstm_cuda.bwd_route`): for H ≤ 512 the cluster backward
(`lstm_cuda.bwd_cluster_plan`: the forward's cluster and units, each
CTA's slab of W_hh's columns, the dgates messages, the summation order,
sequences per cluster and waves), for 512 < H ≤ 1024 the grid backward
(`lstm_cuda.bwd_plan`: CTAs, the columns of W_hh each holds, the gate
rows of each thread, the batch per launch). Every plan must fit one
block's shared memory and cover every row, bin, gate row, unit and batch
item exactly once.
"""

import numpy as np
import pytest

from encodec_tpu_torch.kernels import lstm_cuda, vq_cuda
from encodec_tpu_torch.kernels.validate import SMEM_PER_BLOCK

H100_SMS = 132


def _covers_once(ranges, n):
    """Contiguous, non-empty, in order, and exactly [0, n)."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(a < b for a, b in ranges)


@pytest.mark.parametrize("N,bins,D", [
    (750, 1024, 128), (3000, 1024, 128), (751, 1024, 128), (37, 100, 48),
    (750, 1000, 128), (1, 1, 4), (5, 7, 30), (600, 256, 256), (75, 128, 32),
    (10, 1024, 352), (100000, 1024, 128), (225, 65, 128)])
def test_nearest_plan_covers_rows_and_bins_once(N, bins, D):
    plan = vq_cuda.nearest_plan(N, bins, D, H100_SMS)
    _covers_once(plan.bin_ranges(), bins)
    _covers_once(plan.row_ranges(), N)
    assert len(plan.bin_ranges()) == plan.cluster
    assert 1 <= plan.cluster <= vq_cuda.K1_MAX_CLUSTER
    # the launch's own check (vq_nearest_launch)
    assert (plan.cluster - 1) * plan.bins_per_cta < bins <= (
        plan.cluster * plan.bins_per_cta)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    # the split never asks for more than one wave of CTA slots
    per_sm = vq_cuda.SMEM_PER_SM // (plan.smem_bytes + vq_cuda.SMEM_RESERVED)
    assert per_sm >= 1
    assert plan.cluster == 1 or plan.ctas <= H100_SMS * per_sm


def test_nearest_plan_at_main_path_shapes():
    # one RVQ stage of a 10 s request: 24 row tiles, each split over 8
    # CTAs of 128 bins = 192 CTAs on the 132-SM card
    p750 = vq_cuda.nearest_plan(750, 1024, 128, H100_SMS)
    assert (p750.row_tiles, p750.cluster, p750.bins_per_cta) == (24, 8, 128)
    assert p750.ctas == 192
    p1500 = vq_cuda.nearest_plan(1500, 1024, 128, H100_SMS)
    assert (p1500.row_tiles, p1500.cluster, p1500.bins_per_cta) == (47, 5,
                                                                     205)
    p3000 = vq_cuda.nearest_plan(3000, 1024, 128, H100_SMS)
    assert (p3000.row_tiles, p3000.cluster) == (94, 2)
    # the main path, the stream's chunks and parallel.tp's shards stay on
    # the cluster route, with the cluster kernel's layout
    for N in (6, 7, 32, 750, 1500, 3000):
        plan = vq_cuda.nearest_plan(N, 1024, 128, H100_SMS)
        assert (plan.route, plan.rows) == ("cluster", vq_cuda.K1_ROWS)
        assert plan.smem_bytes == vq_cuda.nearest_smem_bytes(128)
    # bins that the split does not divide
    assert vq_cuda.nearest_plan(751, 100, 128, H100_SMS).bin_ranges() == [
        (0, 50), (50, 100)]
    assert vq_cuda.nearest_plan(751, 1000, 128, H100_SMS).bin_ranges()[-1] == (
        875, 1000)


def test_nearest_plan_smem_layout():
    # rows padded to a stride of 4 * odd floats (conflict-free float4 loads)
    for D in (1, 4, 30, 48, 100, 128, 256, 352):
        stride = 4 * ((((D + 3) // 4) + 1) | 1)
        assert stride >= D + 4 and (stride // 4) % 2 == 1
        assert vq_cuda.nearest_smem_bytes(D) == (
            (32 + 2 * 64) * stride + 4 * 32) * 4
    with pytest.raises(ValueError):
        vq_cuda.nearest_plan(10, 1024, 353, H100_SMS)
    with pytest.raises(ValueError):
        vq_cuda.nearest_plan(10, 0, 128, H100_SMS)


# K1's row-block route: the configs' training searches at D=256 (default
# and gan.yaml B=32 x 4 h at hop 300; B=8 x 4 h at hop 50 and 10), the
# first N past each crossover, 100,000 rows at D=128, and ragged rows,
# bins and D
ROWBLOCK_SHAPES = [(15_360, 1024, 256), (23_040, 512, 256),
                   (115_200, 512, 256), (23_040, 256, 256),
                   (100_000, 1024, 128), (4_225, 1024, 128),
                   (2_113, 1024, 256), (5_001, 1000, 128),
                   (20_001, 1000, 250), (9_999, 65, 256), (40_000, 7, 30),
                   (11_520, 1024, 256)]


def _rowblock_cost(plan):
    """Waves of the card's row-block slots times bin tiles per CTA."""
    slots = H100_SMS * vq_cuda.K1R_CTAS_PER_SM
    return (-(-plan.ctas // slots)
            * -(-plan.bins_per_cta // vq_cuda.K1R_TILE_BINS))


@pytest.mark.parametrize("N,bins,D", ROWBLOCK_SHAPES)
def test_rowblock_plan_covers_rows_and_bins_once(N, bins, D):
    plan = vq_cuda.nearest_plan(N, bins, D, H100_SMS)
    assert (plan.route, plan.rows) == ("rowblock", vq_cuda.K1R_ROWS)
    _covers_once(plan.row_ranges(), N)
    _covers_once(plan.bin_ranges(), bins)
    assert plan.row_tiles == -(-N // 128)
    assert 1 <= plan.cluster <= vq_cuda.K1_MAX_CLUSTER
    # the launch's own check (vq_rowblock_launch): no CTA without bins
    assert (plan.cluster - 1) * plan.bins_per_cta < bins <= (
        plan.cluster * plan.bins_per_cta)
    assert plan.smem_bytes == vq_cuda.rowblock_smem_bytes() <= SMEM_PER_BLOCK
    assert vq_cuda.SMEM_PER_SM // (plan.smem_bytes + vq_cuda.SMEM_RESERVED) \
        >= vq_cuda.K1R_CTAS_PER_SM
    # the cluster size is the cheapest in waves x bin tiles, the smallest
    # of those
    for c in range(1, plan.cluster):
        per = -(-bins // c)
        other = vq_cuda.SearchPlan(N, bins, plan.row_tiles, c, per,
                                   plan.smem_bytes, "rowblock", 128)
        assert _rowblock_cost(other) > _rowblock_cost(plan)


def test_rowblock_route_at_the_training_shapes():
    # (row blocks, cluster, bins per CTA): one wave of 120 single CTAs at
    # N=15,360; the 180 blocks at N=23,040 split in two (3 waves of half
    # the bins, not 2 of all of them); 900 blocks at N=115,200 alone
    want = {(15_360, 1024): (120, 1, 1024), (23_040, 512): (180, 2, 256),
            (115_200, 512): (900, 1, 512), (23_040, 256): (180, 2, 128)}
    for (N, bins), got in want.items():
        plan = vq_cuda.nearest_plan(N, bins, 256, H100_SMS)
        assert plan.route == "rowblock"
        assert (plan.row_tiles, plan.cluster, plan.bins_per_cta) == got
    assert vq_cuda.nearest_plan(100_000, 1024, 128,
                                H100_SMS).route == "rowblock"


@pytest.mark.parametrize("D,first", [(128, 4_225), (256, 2_113)])
def test_nearest_plan_switches_route_where_the_split_is_one(D, first):
    # the cluster route while its 32-row tiles leave room for two CTAs
    # each in a wave of slots (2 per SM at D=128, 1 at D=256); from there
    # on, where the split would be C=1, the row-block route
    below = vq_cuda.nearest_plan(first - 1, 1024, D, H100_SMS)
    assert below.route == "cluster" and below.cluster == 2
    assert vq_cuda.nearest_plan(first, 1024, D, H100_SMS).route == "rowblock"
    split = vq_cuda._split_plan("K1", first, 1024, D, H100_SMS,
                                vq_cuda.nearest_smem_bytes(D))
    assert split.cluster == 1
    for N in range(first - 300, first + 300, 37):
        plan = vq_cuda.nearest_plan(N, 1024, D, H100_SMS)
        assert (plan.route == "rowblock") == (N >= first)


def test_rowblock_smem_layout_and_thread_maps():
    # the ring of k-slabs (128 rows + 128 bins, 32 columns padded to 36),
    # |x|^2 and |e|^2 [128] each, best, idx, runner-up [128] each
    ld = vq_cuda.K1R_SLAB + 4
    assert ld % 4 == 0 and (ld // 4) % 2 == 1
    assert vq_cuda.rowblock_smem_bytes() == (
        4 * 256 * ld + 128 + 128 + 3 * 128) * 4 == 150_016
    # thread tid of 256: bin group (warp & 1) * 8 + (lane & 7), row group
    # (warp >> 1) * 4 + (lane >> 3); rows rg + 16 i, bins bg + 16 q
    tid = np.arange(vq_cuda.K1R_THREADS)
    lane, warp = tid & 31, tid >> 5
    bg = (warp & 1) * 8 + (lane & 7)
    rg = (warp >> 1) * 4 + (lane >> 3)
    pairs = {(r + 16 * i, b + 16 * q) for r, b in zip(rg, bg)
             for i in range(8) for q in range(8)}
    assert pairs == {(r, b) for r in range(128) for b in range(128)}
    # each LDS.128 of a warp: 4 consecutive rows, 8 consecutive bins, in
    # distinct 16-byte bank groups of the padded stride
    for w in range(8):
        rows, bins_ = set(rg[warp == w]), set(bg[warp == w])
        assert len({(r * ld // 4) % 8 for r in rows}) == 4
        assert len({(b * ld // 4) % 8 for b in bins_}) == 8
    # the 16-byte copy map: thread tid copies columns 4 (tid & 7) .. +3 of
    # rows (tid >> 3) + 32 v, v < 4, of both the x and the e slab
    chunks = {((t >> 3) + 32 * v, t & 7) for t in tid for v in range(4)}
    assert chunks == {(r, c) for r in range(128) for c in range(8)}
    # the 4-byte map: column lane of rows warp + 8 v, v < 16
    elems = {(w + 8 * v, ln) for w, ln in zip(warp, lane) for v in range(16)}
    assert elems == {(r, c) for r in range(128) for c in range(32)}


def test_k1_route_choice_is_private_and_the_cpu_runs_the_twin():
    import torch

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(300, 16).astype(np.float32))
    e = torch.from_numpy(rng.randn(40, 16).astype(np.float32))
    want = vq_cuda.nearest_codebook_plain(x, e, return_score=True)
    for route in (None, "cluster", "rowblock"):
        got = vq_cuda.nearest_codebook(x, e, True, _route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for route in ("cluster", "rowblock"):
        plan = vq_cuda._route_plan(route, 300, 40, 16, H100_SMS)
        assert plan.route == route
    with pytest.raises(ValueError):
        vq_cuda._route_plan("fallback", 300, 40, 16, H100_SMS)


@pytest.mark.parametrize("N,bins,D", [(100_000, 1024, 353), (100_000, 0, 128),
                                      (100_000, 1024, 0), (-1, 1024, 256),
                                      (100_000, 1024, 4096)])
def test_rowblock_route_refuses_what_the_kernels_cannot_take(N, bins, D):
    with pytest.raises(ValueError):
        vq_cuda.nearest_plan(N, bins, D, H100_SMS)
    with pytest.raises(ValueError):
        vq_cuda._route_plan("rowblock", N, bins, D, H100_SMS)


SHAPES = [(750, 1024, 128), (3000, 1024, 128), (751, 1024, 128), (37, 100, 48),
          (750, 1000, 128), (1, 1, 4), (5, 7, 30), (600, 256, 256),
          (75, 128, 32), (10, 1024, 352), (100000, 1024, 128), (225, 65, 128)]


@pytest.mark.parametrize("N,bins,D", SHAPES)
def test_rvq_plan_covers_rows_and_bins_once(N, bins, D):
    plan = vq_cuda.rvq_plan(N, bins, D, H100_SMS)
    _covers_once(plan.bin_ranges(), bins)
    _covers_once(plan.row_ranges(), N)
    assert len(plan.bin_ranges()) == plan.cluster
    assert 1 <= plan.cluster <= vq_cuda.K1_MAX_CLUSTER
    # the launch's own check (vq_rvq_launch)
    assert (plan.cluster - 1) * plan.bins_per_cta < bins <= (
        plan.cluster * plan.bins_per_cta)
    assert plan.smem_bytes == vq_cuda.rvq_smem_bytes(D) <= SMEM_PER_BLOCK
    # one wave of CTA slots, counted with K2's own shared memory
    per_sm = vq_cuda.SMEM_PER_SM // (plan.smem_bytes + vq_cuda.SMEM_RESERVED)
    assert per_sm >= 1
    assert plan.cluster == 1 or plan.ctas <= H100_SMS * per_sm


def test_rvq_plan_at_main_path_shapes():
    # all 32 stages of a 10 s request: 24 row tiles x 8 CTAs of 128 bins;
    # a 40 s request (or 4 x 10 s): 94 tiles x 2
    p750 = vq_cuda.rvq_plan(750, 1024, 128, H100_SMS)
    assert (p750.row_tiles, p750.cluster, p750.bins_per_cta) == (24, 8, 128)
    assert p750.ctas == 192
    p3000 = vq_cuda.rvq_plan(3000, 1024, 128, H100_SMS)
    assert (p3000.row_tiles, p3000.cluster, p3000.bins_per_cta) == (94, 2, 512)
    # K2's CTA is larger than K1's but holds the same two slots per SM
    assert vq_cuda.rvq_smem_bytes(128) > vq_cuda.nearest_smem_bytes(128)
    assert vq_cuda.rvq_plan(751, 100, 128, H100_SMS).bin_ranges() == [
        (0, 50), (50, 100)]


def test_rvq_plan_smem_layout():
    # the source's layout: residual tile [32][ld] and ring [2][64][ld],
    # then |x|^2 [32], (best, idx) pairs [2][32], merged indices [32]
    for D in (1, 4, 30, 48, 100, 128, 256, 352):
        stride = 4 * ((((D + 3) // 4) + 1) | 1)
        assert stride >= D + 4 and (stride // 4) % 2 == 1
        floats = (32 + 2 * 64) * stride + 32 + 2 * 2 * 32 + 32
        assert vq_cuda.rvq_smem_bytes(D) == floats * 4
        # the (best, idx) pairs are 8-byte aligned
        assert ((32 + 2 * 64) * stride + 32) * 4 % 8 == 0
    assert vq_cuda.rvq_smem_bytes(352) <= SMEM_PER_BLOCK
    assert vq_cuda.rvq_smem_bytes(353) > SMEM_PER_BLOCK


@pytest.mark.parametrize("N,bins,D", [(10, 1024, 353), (10, 0, 128),
                                      (10, 1024, 0), (-1, 1024, 128),
                                      (10, 1024, 4096)])
def test_rvq_plan_refuses_what_the_kernel_cannot_take(N, bins, D):
    with pytest.raises(ValueError):
        vq_cuda.rvq_plan(N, bins, D, H100_SMS)


def test_plans_are_cached_per_shape():
    assert vq_cuda.rvq_plan(750, 1024, 128, H100_SMS) is vq_cuda.rvq_plan(
        750, 1024, 128, H100_SMS)
    assert vq_cuda.nearest_plan(750, 1024, 128, H100_SMS) is (
        vq_cuda.nearest_plan(750, 1024, 128, H100_SMS))


def _k3_rows(plan):
    """The kernel's map from (CTA, warp, row q) to W_hh gate rows: row q of
    a warp is gate q >> 2 of local unit warp*4 + (q & 3)."""
    placed = []
    for r, (u0, u1) in enumerate(plan.unit_ranges()):
        nu = u1 - u0
        for w in range(lstm_cuda.K3_WARPS):
            for q in range(lstm_cuda.K3_ROWS_PER_WARP):
                lu = w * lstm_cuda.K3_UNITS_PER_WARP + (q & 3)
                if lu < nu:
                    where = ("reg" if q < lstm_cuda.k3_reg_rows(
                        plan.seqs_per_cluster) else "smem")
                    placed.append(((q >> 2) * plan.H + u0 + lu, where))
    return placed


@pytest.mark.parametrize("H", [1, 7, 16, 32, 33, 64, 96, 200, 256, 500, 512])
@pytest.mark.parametrize("B,max_active", [(1, 7), (4, 7), (8, 7), (70, 7),
                                          (3, 1)])
def test_lstm_plan_covers_units_rows_and_batch_once(H, B, max_active):
    plan = lstm_cuda.lstm_plan(B, H, max_active)
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster <= lstm_cuda.K3_MAX_CLUSTER
    assert plan.units_per_cta <= lstm_cuda.K3_MAX_UNITS
    _covers_once(plan.unit_ranges(), H)
    # the launch's own check (lstm_scan_launch)
    assert (plan.cluster - 1) * plan.units_per_cta < H <= (
        plan.cluster * plan.units_per_cta)
    # every gate row of W_hh [4H, H] lives in exactly one CTA
    placed = _k3_rows(plan)
    assert sorted(r for r, _ in placed) == list(range(4 * H))
    n_reg = sum(where == "reg" for _, where in placed)
    assert n_reg <= plan.cluster * plan.reg_rows
    # per CTA: 8 warps x 16 rows, split between registers and shared memory
    assert plan.reg_rows + plan.smem_rows == (
        lstm_cuda.K3_WARPS * lstm_cuda.K3_ROWS_PER_WARP)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes >= plan.smem_rows * plan.k_chunks * 128 * 4
    # every batch item on exactly one cluster, at most max_active clusters,
    # one sequence per cluster up to max_active (two only above it)
    items = sorted(b for seq in plan.batch_items() for b in seq)
    assert items == list(range(B))
    assert 1 <= plan.n_clusters <= min(B, max_active)
    assert plan.seqs_per_cluster == 1 or B > max_active
    assert [sum(r, []) for r in plan.rounds()] == plan.batch_items()
    assert all(1 <= len(r) <= plan.seqs_per_cluster
               for rs in plan.rounds() for r in rs)
    assert plan.smem_bytes == lstm_cuda.lstm_smem_bytes(
        H, plan.seqs_per_cluster)


@pytest.mark.parametrize("H", [1, 7, 33, 96, 200, 500, 512])
def test_lstm_h_messages_deliver_every_unit_once(H):
    """The kernel's sends: each warp ships its valid units' h to every CTA
    of the cluster, as one 16-byte store when all four are valid and
    aligned, else one 4-byte store each. Every CTA's barrier expects
    4·H bytes per step: exactly one copy of every unit."""
    plan = lstm_cuda.lstm_plan(1, H, 1)
    sent = []
    for u0, u1 in plan.unit_ranges():
        nu = u1 - u0
        for w in range(lstm_cuda.K3_WARPS):
            warp_u = u0 + w * 4
            warp_nu = max(0, min(4, nu - w * 4))
            vec = warp_nu == 4 and warp_u % 4 == 0
            sent += list(range(warp_u, warp_u + (4 if vec else warp_nu)))
    assert sorted(sent) == list(range(H))


def test_lstm_plan_at_served_shapes():
    # H=512: 16 CTAs (a non-portable cluster) of 32 units; B=1 on one
    # cluster, B=4 on four, B=8 (past the 7 clusters the card holds) on
    # four clusters of two sequences side by side: one wave
    p1 = lstm_cuda.lstm_plan(1, 512, 7)
    assert (p1.cluster, p1.units_per_cta, p1.n_clusters) == (16, 32, 1)
    assert (p1.reg_rows, p1.smem_rows) == (96, 32)
    assert lstm_cuda.lstm_plan(4, 512, 7).n_clusters == 4
    p8 = lstm_cuda.lstm_plan(8, 512, 7)
    assert p8.batch_items()[0] == [0, 4] and p8.rounds()[0] == [[0, 4]]
    assert (p8.seqs_per_cluster, p8.n_clusters, p8.waves) == (2, 4, 1)
    p200 = lstm_cuda.lstm_plan(3, 200, 7)
    assert (p200.cluster, p200.units_per_cta) == (8, 25)


@pytest.mark.parametrize("B,seqs,clusters,waves", [
    (1, 1, 1, 1), (4, 1, 4, 1), (7, 1, 7, 1), (8, 2, 4, 1), (10, 2, 5, 1),
    (14, 2, 7, 1), (15, 1, 7, 3), (16, 1, 7, 3), (21, 1, 7, 3),
    (22, 2, 7, 2), (32, 1, 7, 5)])
def test_lstm_plan_runs_two_sequences_per_cluster_above_the_count(
        B, seqs, clusters, waves):
    """H=512 on the 7 clusters an H100 holds: one sequence per cluster up
    to 7 (the 24 kHz path's B=1, the stream's, B=4: as before), two side by
    side above it where a round of two (1.7 steps of one) saves a wave, so
    the configs' B=8 and the 48 kHz request's B=10 run in one wave, and B =
    15-21 (two rounds of two: 3.4) and 32 (three: 5.1) run three and five
    waves of one; each slot has its own two h buffers and mbarriers, and
    two sequences' accumulators push two more W_hh rows per warp (8 per
    CTA) into shared memory."""
    plan = lstm_cuda.lstm_plan(B, 512, 7)
    assert (plan.seqs_per_cluster, plan.n_clusters, plan.waves) == (
        seqs, clusters, waves)
    smem_rows = 32 if seqs == 1 else 48
    assert (plan.reg_rows, plan.smem_rows) == (128 - smem_rows, smem_rows)
    assert plan.smem_bytes == (smem_rows + 2 * seqs) * 512 * 4 + 2 * seqs * 8


@pytest.mark.parametrize("max_active", [1, 2, 7, 15])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cluster_batch_takes_the_cheaper_of_one_and_two_per_cluster(
        max_active, direction):
    """Two sequences per cluster only above the count, and only where their
    rounds, each a pair step (`K3_PAIR_STEP` steps of one forward,
    `K3_BWD_PAIR_STEP` backward; a round with an idle slot too), cost less
    than ceil(B / count) waves of one."""
    plan_of, step = ((lstm_cuda.lstm_plan, lstm_cuda.K3_PAIR_STEP)
                     if direction == "forward" else
                     (lstm_cuda.bwd_cluster_plan, lstm_cuda.K3_BWD_PAIR_STEP))
    for B in range(1, 8 * max_active + 2):
        plan = plan_of(B, 512, max_active)
        one = -(-B // max_active)
        pairs = min(max_active, -(-B // 2))
        two = -(-(-(-B // pairs)) // 2) * step
        if plan.seqs_per_cluster == 1:
            assert plan.n_clusters == min(B, max_active)
            assert plan.waves == one and (B <= max_active or one <= two)
        else:
            assert B > max_active and two < one
            assert plan.n_clusters == pairs
            assert plan.waves * step == two


def test_lstm_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        lstm_cuda.lstm_plan(1, 513, 7)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_plan(1, 0, 7)
    with pytest.raises(RuntimeError):
        lstm_cuda.lstm_plan(1, 512, 0)
    # the grid kernel: 512 < H <= 1024, and ceil(H / 8) co-resident CTAs
    for H in (512, lstm_cuda.GRID_MAX_H + 1):
        with pytest.raises(ValueError):
            lstm_cuda.grid_plan(1, H, H100_SMS)
    with pytest.raises(RuntimeError):
        lstm_cuda.grid_plan(1, 1024, 127)
    with pytest.raises(RuntimeError):
        lstm_cuda.grid_plan(1, 513, 0)


@pytest.mark.parametrize("H", [1, 256, 512, 513, 640, 1000, 1024, 1025])
def test_k3_kernels_split_h_between_them(H):
    """`lstm_scan` takes the cluster kernel for H <= 512 and the grid kernel
    above it: exactly one plan takes each H up to 1024, none above."""
    takes = []
    for name, plan, n in (("cluster", lstm_cuda.lstm_plan, 7),
                          ("grid", lstm_cuda.grid_plan, H100_SMS)):
        try:
            plan(1, H, n)
            takes.append(name)
        except ValueError:
            pass
    assert takes == (["cluster"] if H <= 512 else
                     ["grid"] if H <= lstm_cuda.GRID_MAX_H else [])


def _grid_rows(plan):
    """The grid kernel's map from (CTA, busy warp, lane row) to W_hh gate
    rows: CTA row q is gate q // U of unit u0 + q % U; each k slice's warps
    hold the same rows, so slice 0's are counted."""
    placed = []
    U = plan.units_per_cta
    for u0, u1 in plan.unit_ranges():
        for w in range(lstm_cuda.GRID_ROW_GROUPS):
            for q in plan.lane_rows(w):
                if q < 4 * U and q % U < u1 - u0:
                    assert plan.busy(w)
                    placed.append((q // U) * plan.H + u0 + q % U)
    return placed


@pytest.mark.parametrize("H", [513, 640, 700, 1000, 1023, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 48, 49, 64, 200])
def test_grid_plan_covers_units_rows_and_batch_once(H, B):
    plan = lstm_cuda.grid_plan(B, H, H100_SMS)
    assert 1 <= plan.units_per_cta <= lstm_cuda.GRID_MAX_UNITS
    assert plan.ctas <= H100_SMS
    _covers_once(plan.unit_ranges(), H)
    # the launch's own check (lstm_grid_launch)
    assert (plan.ctas - 1) * plan.units_per_cta < H <= (
        plan.ctas * plan.units_per_cta)
    # every gate row of W_hh [4H, H] lives in exactly one CTA's registers
    assert sorted(_grid_rows(plan)) == list(range(4 * H))
    # every k < H in exactly one (busy k slice, lane)
    ks = sorted(k for w in range(0, lstm_cuda.GRID_WARPS,
                                 lstm_cuda.GRID_ROW_GROUPS)
                if w // lstm_cuda.GRID_ROW_GROUPS < plan.k_slices
                for lane in range(32) for k in plan.lane_k(w, lane) if k < H)
    assert ks == list(range(H))
    # every sequence in exactly one launch, each launch within the kernel's
    # limits: a cell (unit, sequence) per thread, h in shared memory
    _covers_once(plan.batch_ranges(), B)
    assert len(plan.batch_ranges()) == plan.n_launches
    assert plan.n_launches == -(-B // lstm_cuda.grid_max_batch(H))
    for b0, b1 in plan.batch_ranges():
        assert b1 - b0 <= plan.batch_per_launch
        assert plan.units_per_cta * (b1 - b0) <= lstm_cuda.GRID_THREADS
        assert sum(plan.batch_tiles(b1 - b0)) == b1 - b0
    assert plan.smem_bytes == lstm_cuda.grid_smem_bytes(
        H, plan.batch_per_launch) <= SMEM_PER_BLOCK


def _grid_smem(H, B):
    """h [Bp][HP] and the 4 slices' row sums [4][Bp][40], Bp even."""
    bp = B + B % 2
    return bp * (-(-H // 256) * 256 + 4 * 40) * 4


@pytest.mark.parametrize("H,ctas,units,slices", [
    (513, 129, 4, 3), (640, 128, 5, 3), (1000, 125, 8, 4), (1024, 128, 8, 4)])
def test_grid_plan_at_breathing_shapes(H, ctas, units, slices):
    # H=1024 is the breathing tokenizer's LSTM (params/default.yaml): 128
    # CTAs of 8 units, 32 gate rows each; a night at B=1, a batch at B=32
    for B, launches in ((1, 1), (32, 1), (49, 2 if H > 768 else 1)):
        plan = lstm_cuda.grid_plan(B, H, H100_SMS)
        assert (plan.ctas, plan.units_per_cta, plan.k_slices) == (
            ctas, units, slices)
        assert plan.n_launches == launches
    assert lstm_cuda.grid_plan(1, H, H100_SMS).smem_bytes == _grid_smem(H, 1)
    assert lstm_cuda.grid_plan(32, H, H100_SMS).smem_bytes == _grid_smem(
        H, 32)
    assert lstm_cuda.grid_max_batch(H) == (48 if H > 768 else 62)


def test_grid_smem_layout():
    # h [Bp][HP] and the row sums [4][Bp][40], Bp a multiple of 2
    assert lstm_cuda.grid_smem_bytes(1024, 1) == 2 * (1024 + 160) * 4
    assert lstm_cuda.grid_smem_bytes(1024, 3) == 4 * (1024 + 160) * 4
    assert lstm_cuda.grid_smem_bytes(1024, 32) == 32 * (1024 + 160) * 4
    assert lstm_cuda.grid_smem_bytes(1024, 48) <= SMEM_PER_BLOCK
    assert lstm_cuda.grid_smem_bytes(1024, 50) > SMEM_PER_BLOCK
    assert lstm_cuda.grid_smem_bytes(640, 62) <= SMEM_PER_BLOCK
    assert lstm_cuda.grid_smem_bytes(640, 64) > SMEM_PER_BLOCK
    assert lstm_cuda.GRID_MAX_H == 1024


@pytest.mark.parametrize("H", [513, 640, 1000, 1024])
def test_grid_lanes_hold_every_row_and_k_of_a_cta_once(H):
    """Inside every CTA the 16 warps (4 row groups x 4 k slices) and their
    lanes (8 rows x 8 k each) hold each (valid row, k < H) of the CTA's W_hh
    block exactly once, and only busy warps hold any."""
    plan = lstm_cuda.grid_plan(1, H, H100_SMS)
    U = plan.units_per_cta
    for u0, u1 in {plan.unit_ranges()[0], plan.unit_ranges()[-1]}:
        held = np.zeros((4 * U, H), dtype=np.int64)
        for w in range(lstm_cuda.GRID_WARPS):
            for lane in range(32):
                rows = [q for q in plan.lane_rows(w)
                        if q < 4 * U and q % U < u1 - u0]
                ks = [k for k in plan.lane_k(w, lane) if k < H]
                assert len(plan.lane_rows(w)) == lstm_cuda.GRID_LANE_ROWS
                assert len(plan.lane_k(w, lane)) == lstm_cuda.GRID_LANE_K
                if rows and ks:
                    assert plan.busy(w)
                for q in rows:
                    held[q, ks] += 1
        valid = np.array([q % U < u1 - u0 for q in range(4 * U)])
        assert (held[valid] == 1).all() and (held[~valid] == 0).all()


@pytest.mark.parametrize("n", [1, 2, 3, 32, 48, 49])
def test_grid_batch_tiles(n):
    # tiles of 2 in slot order, a lone last sequence alone: B=1 computes
    # one sequence, not a padded tile
    tiles = lstm_cuda.GridPlan.batch_tiles(n)
    assert sum(tiles) == n
    assert tiles == [2] * (n // 2) + [1] * (n % 2)
    assert lstm_cuda.GRID_BATCH_TILE == 2
    # launches of 10 sequences and more wait on a barrier before one copy
    # of h, smaller ones poll `out`
    assert lstm_cuda.GridPlan.fenced(n) == (n >= 10)


def _fold(acc, lane_bit, half):
    """One butterfly level as the kernel runs it (`fold<HALF, DIST>`): slot
    i adds the partner's slot i + HALF. Sums are kept as sorted pairs,
    since a + b and b + a have the same bits."""
    return [[tuple(sorted((vals[i], acc[lane ^ lane_bit][i + half])))
             for i in range(half)] for lane, vals in enumerate(acc)]


def _pair(acc, lane_bit):
    return [[tuple(sorted((v[0], acc[lane ^ lane_bit][0])))]
            for lane, v in enumerate(acc)]


def _grid_row_sums(bt):
    """The tree of each (sequence, row) sum of a matvec pass of tile `bt`,
    by simulating row_sums: slot r*bt + i of lane l starts as the leaf
    (l, sequence i ^ ((l >> 1) & 1) at bt = 2, row r ^ ((l >> 2) & 7)).
    Returns {(sequence, row): tree} from the lanes that write."""
    acc = [[(lane, (v % bt) ^ ((lane >> 1) & 1 if bt == 2 else 0),
             (v // bt) ^ ((lane >> 2) & 7)) for v in range(8 * bt)]
           for lane in range(32)]
    if bt == 2:
        for bit, half in ((16, 8), (8, 4), (4, 2), (2, 1)):
            acc = _fold(acc, bit, half)
        acc = _pair(acc, 1)
        return {((lane >> 1) & 1, lane >> 2): acc[lane][0]
                for lane in range(0, 32, 2)}
    for bit, half in ((16, 4), (8, 2), (4, 1)):
        acc = _fold(acc, bit, half)
    acc = _pair(_pair(acc, 2), 1)
    return {(0, lane >> 2): acc[lane][0] for lane in range(0, 32, 4)}


def _leaves(tree):
    if isinstance(tree[0], int):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _relabel(tree, seq):
    if isinstance(tree[0], int):
        return (tree[0], seq, tree[2])
    return tuple(sorted(_relabel(t, seq) for t in tree))


def test_grid_butterfly_sums_a_sequence_alike_in_every_tile():
    """The fixed reduction order: a tile of 2 and a tile of 1 sum each
    (sequence, row) over the 32 lanes as the same tree (pairs xor 16, 8,
    4, 2, 1), so a sequence's bits do not depend on its slot or on B; and
    the select-free folds of permuted slots add only one (sequence, row)'s
    partial sums, every lane's exactly once."""
    two, one = _grid_row_sums(2), _grid_row_sums(1)
    assert set(two) == {(i, r) for i in range(2) for r in range(8)}
    assert set(one) == {(0, r) for r in range(8)}
    for (i, r), tree in two.items():
        leaves = _leaves(tree)
        assert sorted(leaves) == [(lane, i, r) for lane in range(32)]
        assert _relabel(tree, 0) == _relabel(one[0, r], 0)
    assert lstm_cuda.BUTTERFLY == (16, 8, 4, 2, 1)


def _bwd_rows(plan):
    """The grid backward's rows: CTA g holds row q = gate q // U of unit
    u0 + q % U for q % U < nu."""
    placed = []
    U = plan.units_per_cta
    for u0, u1 in plan.unit_ranges():
        placed += [(q // U) * plan.H + u0 + q % U for q in range(4 * U)
                   if q % U < u1 - u0]
    return placed


def _check_bwd_cluster_plan(plan, B):
    """The cluster backward's launch: units covered once, as the forward's;
    every (gate block, unit) column of W_hh [4H, H] in exactly one CTA's
    slab, 12 of a warp's 16 in registers, each over every k < H (the lanes'
    float4 slices); every batch item once; shared memory within a block."""
    H, U = plan.H, plan.units_per_cta
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster <= lstm_cuda.K3_MAX_CLUSTER and U <= 32
    _covers_once(plan.unit_ranges(), H)
    assert (plan.cluster - 1) * U < H <= plan.cluster * U
    held = [entry for r in range(plan.cluster) for entry in plan.slab(r)]
    assert sorted((g, u) for g, u, _ in held) == [
        (g, u) for g in range(4) for u in range(H)]
    for r in range(plan.cluster):
        n_reg = sum(where == "reg" for _, _, where in plan.slab(r))
        assert n_reg <= plan.reg_rows
        assert len(plan.slab(r)) == 4 * (plan.unit_ranges()[r][1]
                                         - plan.unit_ranges()[r][0])
    lane_k = sorted(m * 128 + 4 * lane + e for m in range(plan.k_chunks)
                    for lane in range(32) for e in range(4))
    assert lane_k == list(range(plan.k_chunks * 128))
    assert plan.k_chunks * 128 >= H
    assert plan.reg_rows + plan.smem_rows == 8 * 16
    assert plan.smem_bytes == lstm_cuda.bwd_cluster_smem_bytes(
        H, plan.seqs_per_cluster) <= SMEM_PER_BLOCK
    items = sorted(b for seq in plan.batch_items() for b in seq)
    assert items == list(range(B))
    assert [sum(r, []) for r in plan.rounds()] == plan.batch_items()


@pytest.mark.parametrize("H", [1, 7, 32, 256, 512, 513, 1000, 1024])
@pytest.mark.parametrize("B", [1, 2, 3, 32, 64, 65, 200])
def test_bwd_plan_covers_columns_rows_and_batch_once(H, B):
    if lstm_cuda.bwd_route(H) == "cluster":
        plan = lstm_cuda.bwd_cluster_plan(B, H, 7)
        _check_bwd_cluster_plan(plan, B)
        assert plan.n_clusters == min(7, -(-B // plan.seqs_per_cluster))
        return
    plan = lstm_cuda.bwd_plan(B, H, H100_SMS)
    U = plan.units_per_cta
    assert 1 <= U <= lstm_cuda.BWD_MAX_UNITS
    assert plan.ctas <= min(H100_SMS, lstm_cuda.BWD_MAX_CTAS)
    _covers_once(plan.unit_ranges(), H)
    # the launch's own check (lstm_bwd_launch)
    assert (plan.ctas - 1) * U < H <= plan.ctas * U
    # every gate row of W_hh [4H, H] in exactly one CTA, every column at
    # exactly one thread of it
    assert sorted(_bwd_rows(plan)) == list(range(4 * H))
    cols = sorted(k for x in range(lstm_cuda.BWD_THREADS)
                  for k in plan.thread_columns(x))
    assert cols == list(range(H))
    # every sequence in exactly one launch; a cell (unit, sequence) per
    # thread; dgates and the CTA's partials of every sequence in shared
    # memory
    _covers_once(plan.batch_ranges(), B)
    assert len(plan.batch_ranges()) == plan.n_launches == -(
        -B // lstm_cuda.bwd_max_batch(plan.ctas, U))
    for b0, b1 in plan.batch_ranges():
        assert U * (b1 - b0) <= lstm_cuda.BWD_THREADS
        assert sum(plan.batch_tiles(b1 - b0)) == b1 - b0
    assert plan.smem_bytes == lstm_cuda.bwd_smem_bytes(
        plan.batch_per_launch, plan.ctas, U) <= SMEM_PER_BLOCK
    assert plan.partial_bytes == 2 * plan.ctas * plan.batch_per_launch * (
        -(-plan.ctas * U // 4) * 4) * 4


@pytest.mark.parametrize("H,ctas,units,max_batch", [
    (1024, 128, 8, 51), (512, 16, 32, 14), (256, 8, 32, 14),
    (32, 1, 32, 14)])
def test_bwd_plan_at_training_shapes(H, ctas, units, max_batch):
    # H=1024: default.yaml's LSTM (B=32 nights: one grid launch of 128
    # CTAs); 512 and 256: the 24 kHz codec's and hires_tokens.yaml's, 32:
    # the tests' tiny model, on the cluster backward: clusters of `ctas`
    # CTAs, at most 7 clusters of 2 sequences in a wave (max_batch)
    if lstm_cuda.bwd_route(H) == "grid":
        plan = lstm_cuda.bwd_plan(32, H, H100_SMS)
        assert (plan.ctas, plan.units_per_cta, plan.n_launches) == (
            ctas, units, 1)
        assert lstm_cuda.bwd_max_batch(ctas, units) == max_batch
        # dgates of 32 rows and the block of partials (+ the bank pad) per
        # sequence, 8 inputs of the coming step per cell
        sb = -(-ctas * units // 4) * 4
        assert plan.smem_bytes == 32 * (32 + sb + -(-units // 4) * 4
                                        + 8 * units) * 4
        assert lstm_cuda.BWD_MAX_H == 1024
        return
    plan = lstm_cuda.bwd_cluster_plan(max_batch, H, 7)
    assert (plan.cluster, plan.units_per_cta, plan.seqs_per_cluster) == (
        ctas, units, 2)
    assert plan.waves == 1
    # one more: three waves of one, cheaper than two rounds of two
    past = lstm_cuda.bwd_cluster_plan(max_batch + 1, H, 7)
    assert (past.seqs_per_cluster, past.waves) == (1, 3)
    # 48 W_hh columns per CTA in shared memory (6 per warp: two sequences
    # per cluster), and per slot two dgates buffers of 4 gate segments
    # padded to 128 floats
    hp = -(-H // 128) * 128
    assert plan.smem_bytes == (48 + 2 * 2 * 4) * hp * 4 + 2 * 2 * 8


def test_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        lstm_cuda.bwd_plan(1, 1025, H100_SMS)
    with pytest.raises(RuntimeError):
        lstm_cuda.bwd_plan(1, 1024, 100)   # 11 units per CTA: more than 8
    with pytest.raises(RuntimeError):
        lstm_cuda.bwd_cluster_plan(1, 32, 0)
    # each H is one route's: the grid backward takes 512 < H <= 1024, the
    # cluster backward 1 <= H <= 512
    for H in (32, 512):
        with pytest.raises(ValueError):
            lstm_cuda.bwd_plan(1, H, H100_SMS)
    for H in (0, 513, 1025):
        with pytest.raises(ValueError):
            lstm_cuda.bwd_cluster_plan(1, H, 7)


@pytest.mark.parametrize("H", [1, 7, 32, 200, 256, 512, 513, 1024, 1025])
def test_bwd_route_splits_h_between_the_kernels(H):
    """`lstm_scan_backward` takes the cluster backward for H <= 512 and the
    grid backward above it, as `lstm_scan` splits the forward: exactly one
    plan takes each H up to 1024, none above."""
    takes = []
    for name, plan, n in (("cluster", lstm_cuda.bwd_cluster_plan, 7),
                          ("grid", lstm_cuda.bwd_plan, H100_SMS)):
        try:
            plan(1, H, n)
            takes.append(name)
        except ValueError:
            pass
    want = ["cluster"] if H <= 512 else ["grid"] if H <= 1024 else []
    assert takes == want
    if want:
        assert lstm_cuda.bwd_route(H) == want[0]


@pytest.mark.parametrize("H,cluster,units", [(512, 16, 32), (256, 8, 32),
                                             (200, 8, 25), (32, 1, 32)])
@pytest.mark.parametrize("B,seqs,clusters,waves", [
    (1, 1, 1, 1), (4, 1, 4, 1), (7, 1, 7, 1), (8, 2, 4, 1), (14, 2, 7, 1),
    (15, 1, 7, 3), (16, 1, 7, 3), (21, 1, 7, 3), (32, 2, 7, 3)])
def test_bwd_cluster_plan_sequences_and_waves(H, cluster, units, B, seqs,
                                              clusters, waves):
    """The cluster backward on the 7 clusters an H100 holds: the forward's
    cluster and units; one sequence per cluster up to 7, two side by side
    above where that saves time (the configs' B=8 and B up to 14 in one
    wave; 15-21 in three waves of one; 32 in three rounds of two, at 1.56
    steps of one each, against five waves: the forward, at 1.7, takes
    five)."""
    plan = lstm_cuda.bwd_cluster_plan(B, H, 7)
    assert (plan.cluster, plan.units_per_cta) == (cluster, units)
    assert (plan.seqs_per_cluster, plan.n_clusters, plan.waves) == (
        seqs, clusters, waves)
    fwd = lstm_cuda.lstm_plan(B, H, 7)
    assert (fwd.cluster, fwd.units_per_cta) == (cluster, units)
    if B != 32:
        assert (fwd.seqs_per_cluster, fwd.n_clusters, fwd.waves) == (
            seqs, clusters, waves)
    _check_bwd_cluster_plan(plan, B)


def _butterfly_rows():
    """butterfly16 on symbolic partials: lane l starts with the 16 rows'
    partials {(lane, row)}; returns each lane's set after the four folds
    (xor 16, 8, 4, 2) and the pair's sum (xor 1)."""
    acc = [[frozenset({(lane, q)}) for q in range(16)] for lane in range(32)]
    for half in (8, 4, 2, 1):
        new = []
        for lane in range(32):
            up = bool(lane & (2 * half))
            part = lane ^ (2 * half)
            row = []
            for i in range(half):
                keep = acc[lane][i + half] if up else acc[lane][i]
                send = acc[part][i + half] if up else acc[part][i]
                row.append(keep | send)
            new.append(row + acc[lane][half:])
        acc = new
    return [acc[lane][0] | acc[lane ^ 1][0] for lane in range(32)]


@pytest.mark.parametrize("H", [7, 32, 200, 256, 512, 1000, 1024])
def test_bwd_partials_cover_every_source_and_column_once(H):
    """The grid backward (512 < H): one parity of the partials: CTA g's
    partial for (sequence b, column k) has a slot of its own, inside the
    block of k's owner, and the owner finds each of its units' G partials
    there, once each, summed in four chains of sources in source order.
    The cluster backward (H <= 512) sums no partials across CTAs: each CTA
    sends its units' 4 gates of dgates_t to every CTA (16·H bytes per
    barrier, one copy of each), and a unit's dh sums every lane's k slice
    of each of its 4 rows once (the butterfly: lane l holds row l >> 1),
    the gates in order, then dy."""
    B = 3
    if lstm_cuda.bwd_route(H) == "cluster":
        plan = lstm_cuda.bwd_cluster_plan(B, H, 7)
        sent = []
        for u0, u1 in plan.unit_ranges():
            for w in range(8):
                warp_u = u0 + 4 * w
                warp_nu = max(0, min(4, u1 - warp_u))
                vec = warp_nu == 4 and warp_u % 4 == 0
                sent += [(g, u) for g in range(4)
                         for u in range(warp_u, warp_u + (4 if vec
                                                           else warp_nu))]
        assert sorted(sent) == [(g, u) for g in range(4) for u in range(H)]
        assert 4 * len(sent) == 16 * H
        rows = _butterfly_rows()
        for lane in range(32):
            assert rows[lane] == {(x, lane >> 1) for x in range(32)}
        assert plan.sum_order() == ("dy", ((("i", "f"), "g"), "o"))
        return
    plan = lstm_cuda.bwd_plan(B, H, H100_SMS)
    U, G = plan.units_per_cta, plan.ctas
    sb = -(-G * U // 4) * 4
    offsets = np.array([[[plan.partial_offset(b, g, k) for k in range(H)]
                         for g in range(G)] for b in range(B)])
    assert len(np.unique(offsets)) == offsets.size
    assert offsets.max() < plan.partial_bytes // 8
    for b in range(B):
        for k in range(H):
            owner = k // U
            block = (owner * B + b) * sb
            # the owner's contiguous block [source][unit]
            assert list(offsets[b, :, k]) == [block + g * U + k % U
                                              for g in range(G)]
    chains = plan.sum_chains()
    assert len(chains) == 16
    assert sorted(s for c in chains for s in c) == list(range(G))
    assert all(c == sorted(c) for c in chains)
    # the chains' tree is the xor 1, 2, 4, 8 shuffles' tree: lanes j and
    # j ^ d meet at level d
    tree = plan.sum_tree()

    def meet(node, depth=0):
        if isinstance(node, int):
            return {node: []}
        a, b = meet(node[0], depth + 1), meet(node[1], depth + 1)
        out = {}
        for x, path in a.items():
            out[x] = path + [min(b) ^ min(a)]
        for x, path in b.items():
            out[x] = path + [min(b) ^ min(a)]
        return out

    assert all(path == [1, 2, 4, 8] for path in meet(tree).values())
    assert plan.spread() == (B * U <= 32)


@pytest.mark.parametrize("B,H,mib", [(32, 1024, 32), (1, 1024, 1),
                                     (4, 512, 1 / 64), (1, 256, 1 / 128),
                                     (64, 1024, 32)])
def test_bwd_partial_buffer_at_training_shapes(B, H, mib):
    # the grid backward: B=32, H=1024 (default.yaml's batch): 32 MiB of
    # partial sums per launch, two parities of 128 CTAs x 32 x 1024 floats;
    # B=64 runs as two launches of 32 that share it
    if lstm_cuda.bwd_route(H) == "cluster":
        # no scratch on the device: a CTA's two dgates buffers per slot
        # (4H floats each, here one slot) are in its shared memory
        plan = lstm_cuda.bwd_cluster_plan(B, H, 7)
        buffers = 2 * plan.seqs_per_cluster * 4 * plan.k_chunks * 128 * 4
        assert buffers == mib * 2 ** 20
        assert plan.smem_bytes == (plan.smem_rows * plan.k_chunks * 128 * 4
                                   + buffers + 2 * plan.seqs_per_cluster * 8)
        return
    plan = lstm_cuda.bwd_plan(B, H, H100_SMS)
    assert plan.partial_bytes == mib * 2 ** 20
    # a step moves one parity: written once, read once
    assert plan.partial_bytes // 2 == plan.ctas * plan.batch_per_launch * (
        H * 4)
