"""Launch planning of the hand-written kernels, which stays in Python and so
is checked here on the CPU (the kernels themselves run only on the GPU:
`tests/test_torch_cuda.py`, which also checks that each kernel reports the
layout constants these plans assume).

K1 (`vq_cuda.nearest_plan`) and K2 (`vq_cuda.rvq_plan`): row tiles and
the cluster's split of the bins, each from its kernel's shared memory.
K3: for H ≤ 512 the cluster kernel (`lstm_cuda.lstm_plan`: units per
CTA, the register/shared-memory split of W_hh, the h messages between the
cluster's CTAs, and the batch spread over clusters); for 512 < H ≤ 1024
the grid kernel (`lstm_cuda.grid_plan`: CTAs, units per CTA, the batch
per launch); K3's backward kernel (`lstm_cuda.bwd_plan`: CTAs, the
columns of W_hh each holds, the gate rows of each thread, the batch per
launch). Every plan
must fit one block's shared memory and cover every row, bin, gate row,
unit and batch item exactly once.
"""

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
    p3000 = vq_cuda.nearest_plan(3000, 1024, 128, H100_SMS)
    assert (p3000.row_tiles, p3000.cluster) == (94, 2)
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
                    where = "reg" if q < lstm_cuda.K3_REG_ROWS else "smem"
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
    # every batch item on exactly one cluster, at most max_active clusters
    items = sorted(b for seq in plan.batch_items() for b in seq)
    assert items == list(range(B))
    assert 1 <= plan.n_clusters <= min(B, max_active)


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
    # cluster, B=4 on four, B=8 wraps onto the 7 clusters the card holds
    p1 = lstm_cuda.lstm_plan(1, 512, 7)
    assert (p1.cluster, p1.units_per_cta, p1.n_clusters) == (16, 32, 1)
    assert (p1.reg_rows, p1.smem_rows) == (96, 32)
    assert lstm_cuda.lstm_plan(4, 512, 7).n_clusters == 4
    assert lstm_cuda.lstm_plan(8, 512, 7).batch_items()[0] == [0, 7]
    p200 = lstm_cuda.lstm_plan(3, 200, 7)
    assert (p200.cluster, p200.units_per_cta) == (8, 25)


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
    """The grid kernel's map from (CTA, warp, row r) to W_hh gate rows:
    CTA row q = 2·warp + r is gate q // U of unit u0 + q % U."""
    placed = []
    U = plan.units_per_cta
    for u0, u1 in plan.unit_ranges():
        for w in range(lstm_cuda.GRID_WARPS):
            for r in range(lstm_cuda.GRID_ROWS_PER_WARP):
                q = lstm_cuda.GRID_ROWS_PER_WARP * w + r
                if q < 4 * U and q % U < u1 - u0:
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
    # every sequence in exactly one launch, each launch within the kernel's
    # limits: a cell (unit, sequence) per thread, h in shared memory
    _covers_once(plan.batch_ranges(), B)
    assert len(plan.batch_ranges()) == plan.n_launches
    assert plan.n_launches == -(-B // lstm_cuda.grid_max_batch(H))
    for b0, b1 in plan.batch_ranges():
        assert b1 - b0 <= plan.batch_per_launch
        assert plan.units_per_cta * (b1 - b0) <= lstm_cuda.GRID_THREADS
    assert plan.smem_bytes == lstm_cuda.grid_smem_bytes(
        H, plan.batch_per_launch) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("H,ctas,units,smem_b1", [
    (513, 129, 4, 8 * (640 + 32) * 4), (640, 128, 5, 8 * (640 + 32) * 4),
    (1000, 125, 8, 8 * (1024 + 32) * 4), (1024, 128, 8, 8 * (1024 + 32) * 4)])
def test_grid_plan_at_breathing_shapes(H, ctas, units, smem_b1):
    # H=1024 is the breathing tokenizer's LSTM (params/default.yaml): 128
    # CTAs of 8 units, 32 gate rows each; a night at B=1, a batch at B=32
    for B, launches in ((1, 1), (32, 1), (49, 2 if H > 768 else 1)):
        plan = lstm_cuda.grid_plan(B, H, H100_SMS)
        assert (plan.ctas, plan.units_per_cta, plan.k_chunks) == (
            ctas, units, -(-H // 128))
        assert plan.n_launches == launches
    assert lstm_cuda.grid_plan(1, H, H100_SMS).smem_bytes == smem_b1
    assert lstm_cuda.grid_max_batch(H) == (48 if H > 768 else 64)


def test_grid_smem_layout():
    # h [Bp][HP] and the row sums [32][Bp], Bp a multiple of 8
    assert lstm_cuda.grid_smem_bytes(1024, 1) == 8 * (1024 + 32) * 4
    assert lstm_cuda.grid_smem_bytes(1024, 9) == 16 * (1024 + 32) * 4
    assert lstm_cuda.grid_smem_bytes(1024, 48) <= SMEM_PER_BLOCK
    assert lstm_cuda.grid_smem_bytes(1024, 56) > SMEM_PER_BLOCK
    assert lstm_cuda.GRID_MAX_H == 1024


def _bwd_columns(plan):
    """The backward kernel's map: CTA g holds the columns of its units,
    thread x the gate rows j = m·512 + x (m < j_chunks) of each column;
    returns every (gate row, unit) held."""
    held = []
    for u0, u1 in plan.unit_ranges():
        for m in range(plan.j_chunks):
            for x in range(lstm_cuda.BWD_THREADS):
                j = m * lstm_cuda.BWD_JCHUNK + x
                if j < 4 * plan.H:
                    held.extend((j, u) for u in range(u0, u1))
    return held


@pytest.mark.parametrize("H", [1, 7, 32, 256, 512, 513, 1000, 1024])
@pytest.mark.parametrize("B", [1, 2, 3, 32, 64, 65, 200])
def test_bwd_plan_covers_columns_rows_and_batch_once(H, B):
    plan = lstm_cuda.bwd_plan(B, H, H100_SMS)
    assert 1 <= plan.units_per_cta <= lstm_cuda.BWD_MAX_UNITS
    assert plan.ctas <= H100_SMS
    _covers_once(plan.unit_ranges(), H)
    # the launch's own check (lstm_bwd_launch)
    assert (plan.ctas - 1) * plan.units_per_cta < H <= (
        plan.ctas * plan.units_per_cta)
    assert plan.j_chunks <= 8 and plan.j_chunks * lstm_cuda.BWD_JCHUNK >= 4 * H
    if H <= 64:   # every element of W_hh [4H, H] held exactly once
        held = _bwd_columns(plan)
        assert sorted(held) == [(j, u) for j in range(4 * H)
                                for u in range(H)]
    # every sequence in exactly one launch; a cell (unit, sequence) per
    # thread; the warps' sums of every pair of sequences in shared memory
    _covers_once(plan.batch_ranges(), B)
    assert len(plan.batch_ranges()) == plan.n_launches == -(
        -B // lstm_cuda.BWD_MAX_BATCH)
    for b0, b1 in plan.batch_ranges():
        assert plan.units_per_cta * (b1 - b0) <= lstm_cuda.BWD_THREADS
    assert plan.smem_bytes == lstm_cuda.bwd_smem_bytes(
        plan.batch_per_launch) <= 48 * 1024


@pytest.mark.parametrize("H,ctas,units,j_chunks", [
    (1024, 128, 8, 8), (512, 128, 4, 4), (256, 128, 2, 2), (32, 32, 1, 1)])
def test_bwd_plan_at_training_shapes(H, ctas, units, j_chunks):
    # H=1024: default.yaml's LSTM (B=32 nights: one launch); 512 and 256:
    # the 24 kHz codec's and hires_tokens.yaml's; 32: the tests' tiny model
    plan = lstm_cuda.bwd_plan(32, H, H100_SMS)
    assert (plan.ctas, plan.units_per_cta, plan.j_chunks,
            plan.n_launches) == (ctas, units, j_chunks, 1)
    assert lstm_cuda.bwd_smem_bytes(32) == 16 * 16 * 16 * 4
    assert lstm_cuda.BWD_MAX_H == 1024 and lstm_cuda.BWD_MAX_BATCH == 64


def test_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        lstm_cuda.bwd_plan(1, 1025, H100_SMS)
    with pytest.raises(RuntimeError):
        lstm_cuda.bwd_plan(1, 1024, 100)   # 11 units per CTA: more than 8
    with pytest.raises(RuntimeError):
        lstm_cuda.bwd_plan(1, 32, 0)
