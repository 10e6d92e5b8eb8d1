"""Kernel checks that need the GPU: each hand-written CUDA kernel against its
plain PyTorch twin on the card, at the 24 kHz and 48 kHz main-path shapes
(a 10 s 48 kHz request: K1 and K2 at N=1500 rows, n_q up to 16; K3 at
B=10, T=150 for the ten full segments and B=1, T=15 or 1 for the tail),
the stream's (K2 at N=6 and 7; K3 from a carried state, bit-equal to one
launch over the whole sequence) and the breathing tokenizer's (K3's grid
kernel at H=1024: a 4 h night is T=480, a training batch B=32), and the
lmv=3 integer LM's CDF rows on the card against the CPU's, the range
decoder with the LM's head fused in against its twin, and the decode's
CUDA graph against the CPU and the card's eager runner. Training:
K3's saving forward (the same `out` bits as the plain launch), K3's
backward kernels (the cluster backward for H <= 512, the grid backward
above) against their plain twin and against autograd through the plain
recurrence, each sequence's bits independent of its slot and of B (two
sequences per cluster from B=8 at H <= 512, in both directions), and one
generator step of a tiny breathing model on the
kernels against the same step on the plain twins; the GAN phase: a GAN
generator step and a discriminator step (chunked and whole-signal) on the
kernels against the plain twins, the chunked discriminator against the
whole-signal forward, and a spectral-norm generator step. The float LM:
a training step on the card against the CPU's, and the batch path against
the streaming cell. The reduced-precision modes: a bf16 GAN and
discriminator step against the float32 steps, the TF32 flags scoped to
a model call at 'high', and K1, K2 and K3 launched at 'fast' and held to
the plain twins. The published configs' training shapes: K1 at D=256 with
256 and 512 bins (N=23,040 and 115,200: B=8 nights at hop 50 and 10),
K1's row-block route (which those shapes take) bit for bit against the
cluster route, with duplicates across its bin tiles and CTAs, K2
at their eval encodes (512 bins x 10 and 8 stages, 256 x 8) and at
default.yaml's training batch (N=15,360, 1024 bins x 8), and K3's
saving forward and backward at H=512 over a 4 h night at hop 10
(T=14,400).

This file imports no JAX (the GPU machine has none). On a machine without
a CUDA device every test skips. Run on the H100 with:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from encodec_tpu_torch.kernels import (build, lstm_cuda, lstm_scan,
                                       lstm_scan_backward,
                                       lstm_scan_backward_plain,
                                       lstm_scan_plain, nearest_codebook,
                                       nearest_codebook_plain, rvq_encode_fused,
                                       rvq_encode_fused_plain, vq_cuda)
from encodec_tpu_torch.quant.rvq import RVQConfig, RVQState, rvq_encode_margins

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest "
                    "tests/test_torch_cuda.py on the H100)")
    from encodec_tpu_torch.device import set_fp32_policy
    set_fp32_policy()
    build.build_all()
    return torch.device("cuda")


def _rand(shape, seed, dev, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _books(shape, seed, dev):
    """Uniform books at the kmeans_init=False scale (kaiming uniform)."""
    bound = float(np.sqrt(3.0) * np.sqrt(2.0 / shape[-1]))
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-bound, bound, shape)
                            .astype(np.float32)).to(dev)


def plain_stage_margins(x, embed, n_q, shared):
    """Per-stage codes and margins of the plain chain: [n_q, N] each."""
    residual, codes, margins = x, [], []
    for k in range(n_q):
        book = embed[0 if shared else k]
        idx, m = nearest_codebook_plain(residual, book)
        codes.append(idx)
        margins.append(m)
        residual = residual - book[idx.long()]
    return torch.stack(codes), torch.stack(margins)


@pytest.mark.parametrize("N,D,bins", [(3000, 128, 1024), (1500, 128, 1024),
                                      (600, 128, 1024),
                                      (75, 128, 256), (1024, 256, 512),
                                      (37, 48, 100), (751, 128, 1024),
                                      (750, 128, 1000), (37, 128, 100),
                                      (5, 30, 7)])
def test_nearest_kernel_matches_plain(dev, N, D, bins):
    # latent-scale rows against kmeans_init=False books: distances O(10),
    # the regime of the 24 kHz main path
    x = _rand((N, D), 0, dev, scale=0.3)
    e = _books((bins, D), 1, dev)
    idx, margin = nearest_codebook(x, e)
    ref_idx, ref_margin = nearest_codebook_plain(x, e)
    torch.cuda.synchronize()
    # indices must agree wherever the plain margin is not a near-tie (the
    # kernel's FFMA dot sums in another order than cuBLAS: ~1e-6 absolute)
    safe = ref_margin >= 1e-5
    assert torch.equal(idx[safe], ref_idx[safe])
    assert torch.allclose(margin, ref_margin, atol=1e-4, rtol=0)


@pytest.mark.parametrize("N,D,bins", [(750, 128, 1024), (750, 128, 512),
                                      (3000, 256, 1024), (37, 48, 100)])
def test_nearest_kernel_score(dev, N, D, bins):
    """K1's optional winner score (the codebook-sharded search merges shards
    on it): the index and margin are those of the call without it, bit for
    bit, and the score is the twin's within the margin's bound, the
    negated distance of the returned row."""
    x = _rand((N, D), 2, dev, scale=0.3)
    e = _books((bins, D), 3, dev)
    idx, margin = nearest_codebook(x, e)
    idx2, margin2, score = nearest_codebook(x, e, return_score=True)
    _, _, ref_score = nearest_codebook_plain(x, e, return_score=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx2) and torch.equal(margin, margin2)
    assert torch.allclose(score, ref_score, atol=1e-4, rtol=0)
    own = vq_cuda.distances(x, e).gather(1, idx.long()[:, None])[:, 0]
    assert torch.allclose(score, own, atol=1e-4, rtol=0)


def test_nearest_kernel_duplicate_rows_pick_lowest(dev):
    x = torch.ones(8, 128, device=dev)
    e = torch.cat([torch.ones(4, 128), torch.zeros(4, 128)]).to(dev)
    idx, margin = nearest_codebook(x, e)
    assert idx.tolist() == [0] * 8
    assert margin.tolist() == [0.0] * 8


@pytest.mark.parametrize("bins,dups", [(1024, (900, 5, 700)),
                                       (1000, (999, 130, 126)),
                                       (100, (60, 10, 49))])
def test_nearest_kernel_duplicates_across_ctas(dev, bins, dups):
    # the nearest row appears at several bins that fall in different CTAs'
    # bin ranges of the cluster split: the lowest index wins, margin 0
    plan = vq_cuda.nearest_plan(
        751, bins, 128, torch.cuda.get_device_properties(dev).multi_processor_count)
    owners = {j // plan.bins_per_cta for j in dups}
    assert len(owners) > 1, (plan, dups)
    e = _books((bins, 128), 6, dev)
    for j in dups[1:]:
        e[j] = e[dups[0]]
    x = (e[dups[0]][None] + _rand((751, 128), 7, dev, scale=1e-3)).contiguous()
    idx, margin = nearest_codebook(x, e)
    torch.cuda.synchronize()
    assert idx.tolist() == [min(dups)] * 751
    assert margin.tolist() == [0.0] * 751


def test_kernel_layouts_match_the_plans(dev):
    vq = build.load_library("vq_search")
    assert vq.vq_nearest_rows_per_cta() == vq_cuda.K1_ROWS
    assert vq.vq_nearest_tile_bins() == vq_cuda.K1_TILE_BINS
    assert vq.vq_nearest_threads() == vq_cuda.K1_THREADS
    assert vq.vq_nearest_max_cluster() == vq_cuda.K1_MAX_CLUSTER
    for D in (7, 48, 128, 256, 352):
        assert vq.vq_nearest_smem_bytes(D) == vq_cuda.nearest_smem_bytes(D)
    assert vq.vq_rvq_rows_per_cta() == vq_cuda.K1_ROWS
    assert vq.vq_rvq_tile_bins() == vq_cuda.K1_TILE_BINS
    assert vq.vq_rvq_threads() == vq_cuda.K1_THREADS
    assert vq.vq_rvq_max_cluster() == vq_cuda.K1_MAX_CLUSTER
    for D in (1, 7, 30, 48, 128, 256, 352):
        assert vq.vq_rvq_smem_bytes(D) == vq_cuda.rvq_smem_bytes(D)
    assert vq.vq_rowblock_rows_per_cta() == vq_cuda.K1R_ROWS
    assert vq.vq_rowblock_tile_bins() == vq_cuda.K1R_TILE_BINS
    assert vq.vq_rowblock_slab() == vq_cuda.K1R_SLAB
    assert vq.vq_rowblock_stages() == vq_cuda.K1R_STAGES
    assert vq.vq_rowblock_threads() == vq_cuda.K1R_THREADS
    assert vq.vq_rowblock_smem_bytes() == vq_cuda.rowblock_smem_bytes()
    # the row-block plan's slots: resident CTAs per SM as the card counts
    # them (registers and shared memory), and no spills
    import ctypes
    b, r, loc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert vq.vq_rowblock_attributes(ctypes.byref(b), ctypes.byref(r),
                                     ctypes.byref(loc)) == 0
    assert b.value == vq_cuda.K1R_CTAS_PER_SM, (b.value, r.value)
    assert loc.value == 0, (r.value, loc.value)
    # the plan's waves count sm_count / C clusters: exact for C <= 2 (the
    # training shapes' sizes); larger clusters pack less well
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert vq.vq_rowblock_resident(1) == sms * vq_cuda.K1R_CTAS_PER_SM
    assert vq.vq_rowblock_resident(2) == sms * vq_cuda.K1R_CTAS_PER_SM // 2
    ls = build.load_library("lstm_scan")
    assert ls.lstm_scan_units_per_cta_max() == lstm_cuda.K3_MAX_UNITS
    assert ls.lstm_scan_max_cluster() == lstm_cuda.K3_MAX_CLUSTER
    for seqs in (1, 2):
        assert ls.lstm_scan_reg_rows(seqs) == lstm_cuda.k3_reg_rows(seqs)
    assert ls.lstm_scan_threads() == lstm_cuda.K3_THREADS
    assert ls.lstm_scan_max_seqs() == lstm_cuda.K3_MAX_SEQS
    for H in (1, 32, 200, 512):
        for seqs in (1, 2):
            assert ls.lstm_scan_smem_bytes(H, seqs) == (
                lstm_cuda.lstm_smem_bytes(H, seqs))
        assert ls.lstm_scan_smem_bytes(H, 3) == -1
        # the kernel of two sequences per cluster spills no more than the
        # one of one sequence, in every state variant
        for state in (0, 1, 2):
            local = []
            for seqs in (1, 2):
                regs, loc = ctypes.c_int(), ctypes.c_int()
                build.check(ls, "lstm_scan", ls.lstm_scan_attributes(
                    H, state, seqs, ctypes.addressof(regs),
                    ctypes.addressof(loc)))
                assert regs.value <= 255
                local.append(loc.value)
            assert local[1] <= local[0], (H, state, local)
    # the served shape's cluster (16 CTAs) must be schedulable
    assert lstm_cuda.max_active_clusters(512, dev) >= 1


# the fused kernel's edge shapes: rows that do not fill a tile (751, 37),
# the main path's split (750: 8 CTAs of 128 bins) and a 2-CTA split (3000),
# bins that the split does not divide (1000, 100), D not a multiple of 4,
# one stage, all 32, and one shared book; and the 48 kHz main path's shape
# (1500 rows, 16 stages)
RVQ_SHAPES = [(750, 128, 1024, 8, False), (750, 128, 1024, 32, False),
              (750, 128, 1024, 8, True), (751, 128, 1000, 32, False),
              (3000, 128, 1024, 32, False), (3000, 128, 1024, 8, True),
              (37, 30, 100, 8, False), (37, 128, 256, 1, False),
              (751, 30, 1000, 8, True), (37, 128, 100, 32, True),
              (3000, 30, 256, 1, False), (5, 30, 7, 32, False),
              (1500, 128, 1024, 16, False),
              # a streamed chunk's frames (6 or 7 per 80 ms chunk)
              (6, 128, 1024, 8, False), (6, 128, 1024, 32, False),
              (7, 128, 1024, 8, False), (7, 128, 1024, 32, False),
              # the published configs' eval encode, B=8 4 h nights at D=256
              # on one shared book: l2_weightnorm (hop 10), multires_disc,
              # bins512_commit and disc256_bins256 (hop 50)
              (115_200, 256, 512, 10, True), (23_040, 256, 512, 10, True),
              (23_040, 256, 512, 8, True), (23_040, 256, 256, 8, True),
              # default.yaml's training batch (B=32 x 4 h at hop 300),
              # whose K1 chain runs K1's row-block route
              (15_360, 256, 1024, 8, True)]


def _rvq_inputs(dev, N, D, bins, n_q, shared, seed):
    e = _books((1 if shared else n_q, bins, D), seed, dev)
    x = _rand((N, D), seed + 1, dev, scale=0.3)
    return x, e


@pytest.mark.parametrize("N,D,bins,n_q,shared", RVQ_SHAPES)
def test_fused_rvq_kernel_matches_plain(dev, N, D, bins, n_q, shared):
    x, e = _rvq_inputs(dev, N, D, bins, n_q, shared, 2)
    codes = rvq_encode_fused(x, e, n_q, shared)
    ref = rvq_encode_fused_plain(x, e, n_q, shared)
    torch.cuda.synchronize()
    _, margins = plain_stage_margins(x, e, n_q, shared)
    diff = codes != ref
    first = torch.where(diff.any(0), diff.int().argmax(0), -1)
    bad = [(k, n) for n, k in enumerate(first.tolist())
           if k >= 0 and margins[k, n] >= 1e-4]
    assert not bad, bad[:10]


def _k1_chain(x, e, n_q, shared):
    """`rvq_encode_margins` (K1 per stage, torch f32 update) on [1, N, D]."""
    N, D = x.shape
    cfg = RVQConfig(dimension=D, n_q=n_q, bins=e.shape[1],
                    shared_codebook=shared)
    state = RVQState(embed=e, embed_avg=e, cluster_size=e[..., 0],
                     inited=True)
    codes, _ = rvq_encode_margins(state, x[None], cfg, n_q)
    return codes.reshape(n_q, N)


@pytest.mark.parametrize("N,D,bins,n_q,shared", RVQ_SHAPES)
def test_fused_rvq_kernel_equals_k1_chain_exactly(dev, N, D, bins, n_q,
                                                  shared):
    # the same IEEE operations in the same order: equal at every position,
    # near-ties included
    x, e = _rvq_inputs(dev, N, D, bins, n_q, shared, 12)
    codes = rvq_encode_fused(x, e, n_q, shared)
    chain = _k1_chain(x, e, n_q, shared)
    torch.cuda.synchronize()
    assert torch.equal(codes, chain), int((codes != chain).sum())


@pytest.mark.parametrize("bins,dups", [(1024, (900, 5, 700)),
                                       (1000, (999, 130, 126)),
                                       (100, (60, 10, 49))])
def test_fused_rvq_kernel_duplicates_across_ctas_in_a_later_stage(
        dev, bins, dups):
    # stages 0-2 use books 1000x smaller than stage 3's, so the residual
    # reaching stage 3 is x up to 1e-3; x sits next to row dups[0] of book
    # 3, which is duplicated at bins in different CTAs' ranges
    N, D, n_q, k = 751, 128, 4, 3
    plan = vq_cuda.rvq_plan(
        N, bins, D, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert len({j // plan.bins_per_cta for j in dups}) > 1, (plan, dups)
    e = _books((n_q, bins, D), 16, dev)
    e[:k] *= 1e-3
    for j in dups[1:]:
        e[k, j] = e[k, dups[0]]
    x = (e[k, dups[0]][None] + _rand((N, D), 17, dev, scale=1e-4)).contiguous()
    codes = rvq_encode_fused(x, e, n_q)
    chain = _k1_chain(x, e, n_q, False)
    torch.cuda.synchronize()
    assert codes[k].tolist() == [min(dups)] * N
    assert torch.equal(codes, chain)


def test_fused_rvq_kernel_empty_and_refused_shapes(dev):
    e = _books((2, 64, 16), 18, dev)
    before = rvq_encode_fused.launches
    assert rvq_encode_fused(_rand((10, 16), 19, dev), e, 0).shape == (0, 10)
    assert rvq_encode_fused(_rand((0, 16), 19, dev), e, 2).shape == (2, 0)
    assert rvq_encode_fused.launches == before
    with pytest.raises(ValueError):
        rvq_encode_fused(_rand((10, 353), 19, dev),
                         torch.zeros(1, 64, 353, device=dev), 1)


@pytest.mark.parametrize("B,T,H", [(4, 750, 512), (2, 37, 32), (1, 5, 64),
                                   (70, 9, 512), (3, 11, 200), (1, 1, 512),
                                   (1, 750, 512), (8, 750, 512), (2, 20, 7),
                                   (10, 150, 512), (1, 15, 512)])
def test_lstm_scan_kernel_matches_plain(dev, B, T, H):
    xp = _rand((B, T, 4 * H), 4, dev)
    bound = 1.0 / np.sqrt(H)
    w = torch.from_numpy(np.random.RandomState(5).uniform(
        -bound, bound, (4 * H, H)).astype(np.float32)).to(dev)
    got = lstm_scan(xp, w)
    ref = lstm_scan_plain(xp, w)
    torch.cuda.synchronize()
    # 750 recurrent steps sum in another order than cuBLAS
    assert (got - ref).abs().max().item() <= 1e-4


def test_lstm_scan_kernel_batch_above_cluster_count(dev):
    # more sequences than clusters in flight: each cluster runs two side
    # by side
    H, T = 512, 40
    B = lstm_cuda.max_active_clusters(H, dev) + 3
    plan = lstm_cuda.lstm_plan(B, H, B - 3)
    assert plan.n_clusters < B and plan.seqs_per_cluster == 2
    xp = _rand((B, T, 4 * H), 8, dev)
    bound = 1.0 / np.sqrt(H)
    w = torch.from_numpy(np.random.RandomState(9).uniform(
        -bound, bound, (4 * H, H)).astype(np.float32)).to(dev)
    got = lstm_scan(xp, w)
    ref = lstm_scan_plain(xp, w)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4


def _lstm_inputs(dev, B, T, H, seed):
    """Gate inputs, W_hh and a state with distinct rows per sequence."""
    bound = 1.0 / np.sqrt(H)
    w = torch.from_numpy(np.random.RandomState(seed).uniform(
        -bound, bound, (4 * H, H)).astype(np.float32)).to(dev)
    xp = _rand((B, T, 4 * H), seed + 1, dev)
    h0 = torch.tanh(_rand((B, H), seed + 2, dev))
    c0 = _rand((B, H), seed + 3, dev)
    return xp, w, h0, c0


@pytest.mark.parametrize("B,T", [(1, 6), (1, 7), (1, 750), (10, 150),
                                 (2, 20)])
def test_lstm_scan_kernel_from_state_matches_plain(dev, B, T):
    # B=10: more sequences than clusters in flight, so a second wave's
    # step 0 reads its own h0 row, not the previous sequence's last h
    H = 512 if B != 2 else 200
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 20)
    before = lstm_scan.stateful_launches
    out, hT, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    ref, ref_h, ref_c = lstm_scan_plain(xp, w, h0, c0, return_state=True)
    torch.cuda.synchronize()
    assert lstm_scan.stateful_launches == before + 1
    assert torch.equal(hT, out[:, -1])
    for got, want in ((out, ref), (hT, ref_h), (cT, ref_c)):
        assert (got - want).abs().max().item() <= 1e-4


def _chunks(T, first):
    sizes = [first] if first else []
    while sum(sizes) < T:
        sizes.append(min(first - 1 if first else 1, T - sum(sizes)))
    return sizes


@pytest.mark.parametrize("B,T,first", [(1, 750, 7), (10, 150, 7), (1, 40, 0),
                                       (10, 12, 0)])
def test_lstm_scan_kernel_chunks_bit_equal_to_one_launch(dev, B, T, first):
    """One launch over T steps equals launches over a split of T (7 then
    6s, as a stream's chunks; or single steps) with (h, c) carried."""
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, 512, 30)
    whole, hT, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    outs, h, c, t = [], h0, c0, 0
    for n in _chunks(T, first):
        out, h, c = lstm_scan(xp[:, t:t + n].contiguous(), w, h.contiguous(),
                              c, return_state=True)
        outs.append(out)
        t += n
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1), whole)
    assert torch.equal(h, hT) and torch.equal(c, cT)


def test_lstm_scan_kernel_zero_state_equals_stateless(dev):
    xp, w, _, _ = _lstm_inputs(dev, 3, 50, 512, 40)
    zero = torch.zeros(3, 512, device=dev)
    plain_launch = lstm_scan(xp, w)
    out, _, cT = lstm_scan(xp, w, zero, zero, return_state=True)
    out2, _, cT2 = lstm_scan(xp, w, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_launch) and torch.equal(out2, plain_launch)
    assert torch.equal(cT, cT2)


def test_lstm_scan_kernel_refuses_large_hidden(dev):
    H = lstm_cuda.GRID_MAX_H + 1
    xp = torch.zeros(1, 2, 4 * H, device=dev)
    before = lstm_scan.launches
    with pytest.raises(ValueError):
        lstm_scan(xp, torch.zeros(4 * H, H, device=dev))
    assert lstm_scan.launches == before


# K3 above H=512: the grid kernel. A 4 h night of the breathing model is
# T=480 steps at B=1, its training batch B=32; B=3, T=37 and H=1000 leave
# ragged units, batch tiles and k slices; B=49 at H=1024 runs as two
# launches (48 sequences fit one CTA's shared memory).
GRID_SHAPES = [(1, 480, 1024), (32, 480, 1024), (1, 1, 1024), (3, 37, 1024),
               (3, 37, 1000), (2, 20, 513), (5, 9, 640), (49, 12, 1024)]


@pytest.mark.parametrize("B,T,H", GRID_SHAPES)
def test_lstm_grid_kernel_matches_plain(dev, B, T, H):
    xp, w, _, _ = _lstm_inputs(dev, B, T, H, 50)
    plan = lstm_cuda.grid_plan(B, H, lstm_cuda.max_grid_ctas(H, dev))
    before = (lstm_scan.launches, lstm_scan.grid_launches)
    got = lstm_scan(xp, w)
    ref = lstm_scan_plain(xp, w)
    torch.cuda.synchronize()
    assert (lstm_scan.launches, lstm_scan.grid_launches) == (
        before[0] + plan.n_launches, before[1] + plan.n_launches)
    # up to 480 recurrent steps sum in another order than cuBLAS
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,T,H", [(1, 64, 1024), (32, 64, 1024),
                                   (3, 37, 1000), (1, 480, 1024)])
def test_lstm_grid_kernel_from_state_matches_plain(dev, B, T, H):
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 60)
    before = lstm_scan.stateful_launches
    out, hT, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    ref, ref_h, ref_c = lstm_scan_plain(xp, w, h0, c0, return_state=True)
    torch.cuda.synchronize()
    assert lstm_scan.stateful_launches == before + 1
    assert torch.equal(hT, out[:, -1])
    for got, want in ((out, ref), (hT, ref_h), (cT, ref_c)):
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,T,H,first", [(1, 480, 1024, 64), (32, 130, 1024, 64),
                                         (3, 40, 1000, 0), (49, 20, 1024, 7)])
def test_lstm_grid_kernel_chunks_bit_equal_to_one_launch(dev, B, T, H, first):
    """One launch over T steps equals launches over a split of T (64-step
    chunks, as the extractor streams a night; 7 then 6s; single steps)
    with (h, c) carried."""
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 70)
    whole, hT, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    sizes = ([first] * (T // first) + [T % first] if first == 64
             else _chunks(T, first))
    outs, h, c, t = [], h0, c0, 0
    for n in (n for n in sizes if n):
        out, h, c = lstm_scan(xp[:, t:t + n].contiguous(), w, h.contiguous(),
                              c, return_state=True)
        outs.append(out)
        t += n
    torch.cuda.synchronize()
    assert t == T
    assert torch.equal(torch.cat(outs, dim=1), whole)
    assert torch.equal(h, hT) and torch.equal(c, cT)


@pytest.mark.parametrize("H", [1024, 1000])
def test_lstm_grid_kernel_zero_state_equals_stateless(dev, H):
    xp, w, _, _ = _lstm_inputs(dev, 3, 50, H, 80)
    zero = torch.zeros(3, H, device=dev)
    plain_launch = lstm_scan(xp, w)
    out, _, cT = lstm_scan(xp, w, zero, zero, return_state=True)
    out2, _, cT2 = lstm_scan(xp, w, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_launch) and torch.equal(out2, plain_launch)
    assert torch.equal(cT, cT2)


def test_lstm_grid_kernel_layout_matches_the_plan(dev):
    import ctypes
    lib = build.load_library("lstm_grid")
    assert lib.lstm_grid_threads() == lstm_cuda.GRID_THREADS
    assert lib.lstm_grid_max_units() == lstm_cuda.GRID_MAX_UNITS
    assert lib.lstm_grid_lane_rows() == lstm_cuda.GRID_LANE_ROWS
    assert lib.lstm_grid_lane_k() == lstm_cuda.GRID_LANE_K
    assert lib.lstm_grid_batch_tile() == lstm_cuda.GRID_BATCH_TILE
    assert lib.lstm_grid_max_batch() == lstm_cuda.GRID_MAX_BATCH
    assert lib.lstm_grid_max_h() == lstm_cuda.GRID_MAX_H
    for B in range(1, 65):
        assert bool(lib.lstm_grid_fenced(B)) == lstm_cuda.GridPlan.fenced(B)
    for H in (513, 640, 1000, 1024):
        for B in (1, 2, 3, 8, 9, lstm_cuda.grid_max_batch(H)):
            assert lib.lstm_grid_smem_bytes(H, B) == lstm_cuda.grid_smem_bytes(
                H, B)
        assert lib.lstm_grid_smem_bytes(H, lstm_cuda.grid_max_batch(H) + 2) == -1
        # one CTA per SM, and the plan's grid fits what the card holds
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n = lstm_cuda.max_grid_ctas(H, dev)
        assert n >= sms
        assert lstm_cuda.grid_plan(32, H, n).ctas <= n
    # W_hh stays in registers: no spill in any instantiation
    for save in (0, 1):
        for fenced in (0, 1):
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(lib, "lstm_grid", lib.lstm_grid_attributes(
                save, fenced, ctypes.addressof(regs), ctypes.addressof(local)))
            assert local.value == 0 and regs.value <= 128


@pytest.mark.parametrize("H", [200, 512, 1000, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 11, 14, 22, 32, 49])
def test_lstm_grid_kernel_batch_slot_bits(dev, B, H):
    """A sequence's bits do not depend on its slot or on B: row b of a
    B-sequence launch (two launches at B=49 on the grid kernel; on the
    cluster kernel, H <= 512, two sequences per cluster at B = 8, 11, 14,
    22 and 49 on an H100 (11: one cluster of one; 22 and 49: a last round
    with an idle slot), waves of one at 32) equals the launch of sequence b
    alone, from zero state and from a state, saving or not."""
    T = 40
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 85)
    whole, _, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    zero = lstm_scan(xp, w)
    saved, c_seq = lstm_scan(xp, w, h0, c0, save_c=True)
    assert torch.equal(saved, whole)
    for b in range(B):
        one = slice(b, b + 1)
        out1, _, c1 = lstm_scan(xp[one], w, h0[one], c0[one],
                                return_state=True)
        assert torch.equal(out1, whole[one]) and torch.equal(c1, cT[one])
        assert torch.equal(lstm_scan(xp[one], w), zero[one])
        assert torch.equal(lstm_scan(xp[one], w, h0[one], c0[one],
                                     save_c=True)[1], c_seq[one])


@pytest.mark.parametrize("n_q,W,S", [(32, 262, 2), (16, 525, 11)])
def test_integer_lm_rows_on_the_card_equal_the_cpu(dev, n_q, W, S):
    """The lmv=3 integer LM at the published widths (dim 200, 8 heads, 5
    layers, card 1024; the 24 kHz and 48 kHz windows): a teacher-forced
    chunk, a chunk split and the steps after it give the CPU's rows bit
    for bit (float64 contractions of integers are exact on the card)."""
    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.models.lm import LMConfig, LMModel, init_lm

    cfg = LMConfig(n_q=n_q, card=1024, past_context=W)
    params = init_lm(torch.Generator().manual_seed(5), cfg)
    ilms = [IntLMModel.from_lm(LMModel(cfg, params, device=d))
            for d in (dev, "cpu")]
    shifted = torch.from_numpy(np.random.RandomState(6).randint(
        0, 1025, (S, n_q, 40)))
    rows = []
    for ilm in ilms:
        x = shifted.to(ilm.device)
        with torch.inference_mode():
            full, state = ilm.chunk_forward(x[:, :, :32], ilm.init_stream(S))
            a, s2 = ilm.chunk_forward(x[:, :, :13], ilm.init_stream(S))
            b, _ = ilm.chunk_forward(x[:, :, 13:32], s2)
            steps = []
            for t in range(32, 40):
                r, state = ilm.step(x[:, :, t], state)
                steps.append(r)
        rows.append([full.cpu(), torch.cat([a, b], 1).cpu(),
                     torch.stack(steps, 1).cpu()])
    for got, want in zip(rows[0], rows[1]):
        assert torch.equal(got, want)
    assert torch.equal(rows[0][0], rows[0][1])


# -- training: K3's saving forward and its backward kernel ------------------

@pytest.mark.parametrize("B,T,H,stateful", [(2, 37, 32, False),
                                            (4, 50, 512, True),
                                            (3, 40, 256, False),
                                            (3, 40, 1024, False),
                                            (32, 30, 1024, True),
                                            (50, 9, 1024, False)])
def test_lstm_scan_save_keeps_the_plain_launch_bits(dev, B, T, H, stateful):
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 90)
    st = (h0, c0) if stateful else (None, None)
    before = lstm_scan.save_launches
    out, c_seq = lstm_scan(xp, w, *st, save_c=True)
    ref, _, cT = lstm_scan(xp, w, *st, return_state=True)
    plain_out, plain_c = lstm_scan_plain(xp, w, *st, save_c=True)
    torch.cuda.synchronize()
    assert lstm_scan.save_launches > before
    assert torch.equal(out, ref) and torch.equal(c_seq[:, -1], cT)
    assert (c_seq - plain_c).abs().max().item() <= 1e-4
    assert (out - plain_out).abs().max().item() <= 1e-4


def _bwd_inputs(dev, B, T, H, seed, stateful):
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, seed)
    if not stateful:
        h0 = c0 = None
    out, c_seq = lstm_scan_plain(xp, w, h0, c0, save_c=True)
    first = torch.zeros(B, 1, H, device=dev) if h0 is None else h0[:, None]
    pre = xp + torch.cat([first, out[:, :-1]], 1) @ w.t()
    dy = _rand((B, T, H), seed + 7, dev)
    dc_last = _rand((B, H), seed + 8, dev, 0.5)
    return xp, w, h0, c0, pre.contiguous(), c_seq, dy, dc_last


def _bwd_launches(dev, B, H):
    """Launches of one backward call: one of the cluster backward (H <=
    512), one per batch range of the grid backward."""
    if lstm_cuda.bwd_route(H) == "cluster":
        return 1
    return lstm_cuda.bwd_plan(B, H, lstm_cuda.max_bwd_ctas(H, dev)).n_launches


@pytest.mark.parametrize("B,T,H,stateful", [(2, 37, 32, False),
                                            (4, 50, 512, True),
                                            (1, 30, 1024, False),
                                            (32, 25, 1024, True),
                                            (65, 9, 256, True),
                                            (3, 1, 1000, False),
                                            (2, 12, 7, True)])
def test_lstm_backward_kernel_matches_twin(dev, B, T, H, stateful):
    _, w, _, c0, pre, c_seq, dy, dc_last = _bwd_inputs(dev, B, T, H, 95,
                                                       stateful)
    before = lstm_scan_backward.launches
    got = lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last)
    want = lstm_scan_backward_plain(pre, c_seq, dy, w, c0, dc_last)
    torch.cuda.synchronize()
    assert lstm_scan_backward.launches == before + _bwd_launches(dev, B, H)
    for g, r in zip(got, want):
        # T recurrent products summed in another order than cuBLAS
        assert (g - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())
    # without the state's gradient: the same dgates bits, no dh0/dc0
    d2, dh0, dc0 = lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last,
                                      state_grad=False)
    assert dh0 is None and dc0 is None and torch.equal(d2, got[0])


@pytest.mark.parametrize("B,T,H", [(2, 37, 32), (4, 40, 512), (3, 30, 1024)])
def test_lstm_layer_gradient_on_the_card_matches_autograd_of_the_twin(
        dev, B, T, H):
    from encodec_tpu_torch.ops.lstm import LstmLayer
    xp, w, h0, c0 = _lstm_inputs(dev, B, T, H, 97)
    dy = _rand((B, T, H), 98, dev)
    leaves = [t.clone().requires_grad_(True) for t in (xp, w, h0, c0)]
    before = (lstm_scan.save_launches, lstm_scan_backward.launches)
    out, _ = LstmLayer.apply(*leaves, False)
    got = torch.autograd.grad(out, leaves, dy)
    assert (lstm_scan.save_launches > before[0]
            and lstm_scan_backward.launches > before[1])
    ref_leaves = [t.clone().requires_grad_(True) for t in (xp, w, h0, c0)]
    ref = lstm_scan_plain(*ref_leaves)
    want = torch.autograd.grad(ref, ref_leaves, dy)
    torch.cuda.synchronize()
    for name, g, r, tol in zip(("dxp", "dW_hh", "dh0", "dc0"), got, want,
                               (1e-4, 1e-3, 1e-4, 1e-4)):
        err = (g - r).abs().max().item() / r.abs().max().item()
        assert err <= tol, (name, err)


def test_lstm_scan_refuses_inputs_that_need_a_gradient(dev):
    xp, w, _, _ = _lstm_inputs(dev, 1, 4, 32, 99)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        lstm_scan(xp, w.requires_grad_(True))
    with torch.no_grad():
        lstm_scan(xp, w)


def test_lstm_backward_kernel_layout_matches_the_plan(dev):
    import ctypes
    lib = build.load_library("lstm_bwd")
    assert lib.lstm_bwd_threads() == lstm_cuda.BWD_THREADS
    assert lib.lstm_bwd_max_units() == lstm_cuda.BWD_MAX_UNITS
    assert lib.lstm_bwd_min_units() == lstm_cuda.BWD_MIN_UNITS
    assert lib.lstm_bwd_cols() == lstm_cuda.BWD_COLS
    assert lib.lstm_bwd_batch_tile() == lstm_cuda.BWD_BATCH_TILE
    assert lib.lstm_bwd_max_h() == lstm_cuda.BWD_MAX_H
    assert lib.lstm_bwd_max_ctas_limit() == lstm_cuda.BWD_MAX_CTAS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for H in (513, 640, 1000, 1024):
        n = lstm_cuda.max_bwd_ctas(H, dev)
        assert n >= sms
        plan = lstm_cuda.bwd_plan(32, H, n)
        assert plan.ctas <= n
        U, G = plan.units_per_cta, plan.ctas
        for B in (1, 2, 3, 32, lstm_cuda.bwd_max_batch(G, U)):
            assert lib.lstm_bwd_smem_bytes(B, G, U) == lstm_cuda.bwd_smem_bytes(
                B, G, U)
        assert lib.lstm_bwd_smem_bytes(lstm_cuda.bwd_max_batch(G, U) + 1, G,
                                       U) == -1
    # W_hh stays in registers: no spill for any units per CTA the plan
    # takes (512 < H: at least 5); fewer are not built
    for U in range(lstm_cuda.BWD_MIN_UNITS, lstm_cuda.BWD_MAX_UNITS + 1):
        regs, local = ctypes.c_int(), ctypes.c_int()
        build.check(lib, "lstm_bwd", lib.lstm_bwd_attributes(
            U, ctypes.addressof(regs), ctypes.addressof(local)))
        assert local.value == 0 and regs.value <= 128
    assert lib.lstm_bwd_attributes(lstm_cuda.BWD_MIN_UNITS - 1,
                                   ctypes.addressof(regs),
                                   ctypes.addressof(local)) != 0


@pytest.mark.parametrize("H", [32, 200, 256, 512])
@pytest.mark.parametrize("B", [1, 4, 8, 15])
@pytest.mark.parametrize("T", [1, 2, 750])
@pytest.mark.parametrize("stateful", [False, True])
def test_lstm_cluster_backward_matches_twin(dev, H, B, T, stateful):
    """The cluster backward (H <= 512) against its twin: one sequence per
    cluster (B <= 7 on an H100), two side by side in one wave (B=8) and in
    two (B=15); T=1 runs no recurrent product, T=2 one."""
    _, w, _, c0, pre, c_seq, dy, dc_last = _bwd_inputs(dev, B, T, H,
                                                       130 + T, stateful)
    before = (lstm_scan_backward.launches,
              lstm_scan_backward.cluster_launches)
    got = lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last)
    want = lstm_scan_backward_plain(pre, c_seq, dy, w, c0, dc_last)
    torch.cuda.synchronize()
    assert (lstm_scan_backward.launches,
            lstm_scan_backward.cluster_launches) == (before[0] + 1,
                                                     before[1] + 1)
    for g, r in zip(got, want):
        # T recurrent products summed in another order than cuBLAS
        assert (g - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())
    d2, dh0, dc0 = lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last,
                                      state_grad=False)
    assert dh0 is None and dc0 is None and torch.equal(d2, got[0])


def test_lstm_cluster_backward_layout_matches_the_plan(dev):
    import ctypes
    lib = build.load_library("lstm_bwd_cluster")
    assert lib.lstm_bwd_cluster_units_per_cta_max() == lstm_cuda.K3_MAX_UNITS
    assert lib.lstm_bwd_cluster_max_cluster() == lstm_cuda.K3_MAX_CLUSTER
    for seqs in (1, 2):
        assert lib.lstm_bwd_cluster_reg_rows(seqs) == lstm_cuda.k3_reg_rows(
            seqs)
    assert lib.lstm_bwd_cluster_threads() == lstm_cuda.K3_THREADS
    assert lib.lstm_bwd_cluster_max_seqs() == lstm_cuda.K3_MAX_SEQS
    for H in (1, 32, 200, 256, 512):
        for seqs in (1, 2):
            assert lib.lstm_bwd_cluster_smem_bytes(H, seqs) == (
                lstm_cuda.bwd_cluster_smem_bytes(H, seqs))
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(lib, "lstm_bwd_cluster",
                        lib.lstm_bwd_cluster_attributes(
                            H, seqs, ctypes.addressof(regs),
                            ctypes.addressof(local)))
            assert regs.value <= 255
        assert lib.lstm_bwd_cluster_smem_bytes(H, 3) == -1
        # B up to twice the clusters the card holds runs in one wave (at
        # H=512 as many clusters as the forward's: 7 on an H100; at small H
        # the forward fits two CTAs per SM, the backward one)
        n = lstm_cuda.max_bwd_clusters(H, dev)
        assert n >= 1
        if H == 512:
            assert n == lstm_cuda.max_active_clusters(H, dev)
        plan = lstm_cuda.bwd_cluster_plan(2 * n, H, n)
        assert (plan.n_clusters, plan.seqs_per_cluster, plan.waves) == (
            n, 2, 1)
    assert lib.lstm_bwd_cluster_smem_bytes(513, 1) == -1


@pytest.mark.parametrize("H", [200, 512, 1000, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 11, 14, 22, 32, 49])
def test_lstm_backward_kernel_batch_slot_bits(dev, B, H):
    """A sequence's gradient bits do not depend on its slot or on B: row b
    of a B-sequence backward equals the backward of sequence b alone
    (dgates, dh0, dc0); at H=512 on an H100 B = 8, 11 and 14 run two
    sequences per cluster in one wave (11: one cluster of one), 22, 32
    and 49 in rounds of two, some clusters' last with an idle slot."""
    _, w, _, c0, pre, c_seq, dy, dc_last = _bwd_inputs(dev, B, 30, H, 96,
                                                       True)
    whole = lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last)
    for b in range(B):
        one = slice(b, b + 1)
        alone = lstm_scan_backward(pre[one], c_seq[one], dy[one], w, c0[one],
                                   dc_last[one])
        for g, r in zip(alone, whole):
            assert torch.equal(g, r[one])


def test_gen_step_on_the_kernels_matches_the_plain_twins(dev):
    """One generator step of a tiny breathing model (H=32 LSTM, 8 stages
    of a shared book, B=2) from the same state on the kernels and on the
    plain twins: codes, loss, gradients and the new state; every leaf,
    the encoder's convs before the LSTM included, gets a gradient."""
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.models import build_model
    from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                         make_train_steps)
    from encodec_tpu_torch.train.optim import tree_leaves

    model = build_model([0.08], sample_rate=10, channels=1, causal=True,
                        model_norm="layer_norm", name="breathing_model",
                        ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                        decoder_final_norm="none", shared_codebook=True,
                        kmeans_init=False, seed=3, device=dev)
    fl = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
    t = np.arange(600) / 10.0
    x = torch.from_numpy((np.sin(2 * np.pi * 0.3 * t)[None, :, None]
                          + 0.05 * np.random.RandomState(0).randn(2, 600, 1))
                         .astype(np.float32)).to(dev)
    w = LossWeights.make(lr=1e-3, freq=0.25, l2=0.01, commit=0.25,
                         codebook=1.0)
    state = create_train_state(model, seed=0)
    kernels.reset_launch_counts()
    gen = make_train_steps(model.cfg, freq_loss_kwargs=fl)[0]
    s_k, m_k = gen(state, x, w, keep_grads=True)
    counts = kernels.launch_counts()
    assert counts["nearest_codebook"] == 8 and counts["lstm_scan"] == 4
    assert lstm_scan.save_launches == 4 and counts["lstm_scan_backward"] == 4
    gen_p = make_train_steps(model.cfg, freq_loss_kwargs=fl, plain=True)[0]
    s_p, m_p = gen_p(state, x, w, keep_grads=True)
    torch.cuda.synchronize()
    assert abs(m_k["loss"].item() - m_p["loss"].item()) <= 1e-4 * abs(
        m_p["loss"].item())
    for g, r in zip(tree_leaves(m_k["grads"]), tree_leaves(m_p["grads"])):
        assert bool(torch.isfinite(g).all()) and g.abs().max().item() > 0
        assert (g - r).abs().max().item() <= 1e-3 * r.abs().max().item()
    for a, b in zip(s_k.qstate[:3], s_p.qstate[:3]):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


def _tiny_gan(dev, norm="layer_norm", chunk=7):
    from encodec_tpu_torch.models import MSSTFTConfig, build_model

    model = build_model([0.08], sample_rate=10, channels=1, causal=True,
                        model_norm=norm, name="breathing_model",
                        ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                        decoder_final_norm="none", shared_codebook=True,
                        kmeans_init=False, seed=3, device=dev)
    disc = MSSTFTConfig(filters=2, n_ffts=(64, 32), hop_lengths=(16, 8),
                        win_lengths=(64, 32), time_chunk=chunk)
    t = np.arange(600) / 10.0
    x = torch.from_numpy((np.sin(2 * np.pi * 0.3 * t)[None, :, None]
                          + 0.05 * np.random.RandomState(0).randn(2, 600, 1))
                         .astype(np.float32)).to(dev)
    return model, disc, x


@pytest.mark.parametrize("chunk", [7, None])
def test_gan_and_disc_steps_on_the_kernels_match_the_plain_twins(dev, chunk):
    """A GAN generator step and a discriminator step of a tiny breathing
    model (tiny discriminator, chunked or whole-signal) from the same state
    on the kernels and on the plain twins: codes at every position, losses
    within 1e-4, gradient leaves within 5e-3 of their own and the whole
    gradient's largest |value| (the feature-matching loss's L1 kinks flip
    signs under rounding: tests/test_torch_gan.py); the launches."""
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                         make_train_steps)
    from encodec_tpu_torch.train.optim import tree_leaves

    model, disc, x = _tiny_gan(dev, chunk=chunk)
    fl = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
    w = LossWeights.make(lr=1e-3, freq=0.25, l2=0.01, commit=0.25,
                         codebook=1.0, disc_lr=1e-3)
    state = create_train_state(model, disc, seed=0)
    gen, dstep = make_train_steps(model.cfg, disc, freq_loss_kwargs=fl)[:2]
    gen_p, dstep_p = make_train_steps(model.cfg, disc, freq_loss_kwargs=fl,
                                      plain=True)[:2]
    kernels.reset_launch_counts()
    saved = lstm_scan.save_launches
    s_k, m_k = gen(state, x, w, use_gan=True, keep_grads=True)
    counts = kernels.launch_counts()
    assert counts["nearest_codebook"] == 8 and counts["lstm_scan"] == 4
    assert lstm_scan.save_launches - saved == 4
    assert counts["lstm_scan_backward"] == 4
    d_k, dm_k = dstep(state, x, w, keep_grads=True)
    counts = kernels.launch_counts()
    assert counts["nearest_codebook"] == 16 and counts["lstm_scan"] == 8
    assert lstm_scan.save_launches - saved == 4
    s_p, m_p = gen_p(state, x, w, use_gan=True, keep_grads=True)
    d_p, dm_p = dstep_p(state, x, w, keep_grads=True)
    torch.cuda.synchronize()
    assert torch.equal(m_k["codes"], m_p["codes"])
    for k in ("loss", "loss_gen", "loss_feat"):
        assert abs(m_k[k].item() - m_p[k].item()) <= 1e-4 * abs(m_p[k].item())
    for k in ("loss_disc", "logits_real", "logits_fake"):
        assert abs(dm_k[k].item() - dm_p[k].item()) <= 1e-4 * abs(
            dm_p[k].item())
    for got, ref, rel in ((m_k["grads"], m_p["grads"], 5e-3),
                          (dm_k["grads"], dm_p["grads"], 1e-4)):
        top = max(r.abs().max().item() for r in tree_leaves(ref))
        for g, r in zip(tree_leaves(got), tree_leaves(ref)):
            assert bool(torch.isfinite(g).all())
            assert (g - r).abs().max().item() <= rel * (
                r.abs().max().item() + top)
    assert d_k.qstate is state.qstate and d_k.params is state.params


def test_chunked_discriminator_matches_the_whole_signal_on_the_card(dev):
    """The chunked GAN sums (chunk 37 over 370 and 741 frames: ragged
    tails) against the whole-signal forward, relative 1e-5."""
    from encodec_tpu_torch.models import msstftd

    cfg = msstftd.MSSTFTConfig(filters=8, n_ffts=(64, 32),
                               hop_lengths=(16, 8), win_lengths=(64, 32))
    params = msstftd.init_msstftd(torch.Generator().manual_seed(1), cfg, dev)
    x = _rand((2, 6000, 1), 1, dev)
    x_hat = x + _rand((2, 6000, 1), 2, dev, 0.3)
    with torch.no_grad():
        for i, sub in enumerate(params["discs"]):
            sums = msstftd.msstftd_gan_sums_chunked(sub, x, x_hat, cfg, i,
                                                    chunk=37)
            lr, fr = msstftd.msstftd_sub_forward(sub, x, cfg, i)
            lf, ff = msstftd.msstftd_sub_forward(sub, x_hat, cfg, i)
            assert lr.shape[2] % 37 and int(sums["n_logit"]) == lr.numel()
            whole = {"lg_real": (1 - lr).square().sum(), "sum_real": lr.sum(),
                     "lg_fake": (1 - lf).square().sum(),
                     "sq_fake": lf.square().sum(), "sum_fake": lf.sum(),
                     "feat_diff": torch.stack([(a - b).abs().sum()
                                               for a, b in zip(fr, ff)]),
                     "feat_real": torch.stack([a.abs().sum() for a in fr])}
            for k, v in whole.items():
                assert float(((sums[k] - v).abs() / v.abs()).max()) <= 1e-5, k


def test_spectral_norm_gen_step_on_the_kernels(dev):
    """`model_norm="spectral_norm"`: one step on the kernels against the
    plain twins (loss within 1e-4; u and v refreshed alike within 1e-5)."""
    from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                         make_train_steps)

    def vectors(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("u_sn", "v_sn"):
                    yield path + k, v
                else:
                    yield from vectors(v, f"{path}{k}/")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from vectors(v, f"{path}{i}/")

    model, _, x = _tiny_gan(dev, norm="spectral_norm")
    fl = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
    w = LossWeights.make(lr=1e-3, freq=0.25)
    state = create_train_state(model, seed=0)
    s_k, m_k = make_train_steps(model.cfg, freq_loss_kwargs=fl)[0](
        state, x, w)
    s_p, m_p = make_train_steps(model.cfg, freq_loss_kwargs=fl,
                                plain=True)[0](state, x, w)
    assert abs(m_k["loss"].item() - m_p["loss"].item()) <= 1e-4 * abs(
        m_p["loss"].item())
    got, ref = dict(vectors(s_k.params)), dict(vectors(s_p.params))
    before = dict(vectors(state.params))
    assert len(got) == len(ref) > 20
    for k, a in got.items():
        assert not torch.equal(a, before[k]), k
        assert (a - ref[k]).abs().max().item() <= 1e-5, k


def _small_lm(dev_or_cpu, seed=0):
    from encodec_tpu_torch.models.lm import LMConfig, init_lm
    cfg = LMConfig(n_q=4, card=64, dim=32, num_heads=2, num_layers=2,
                   past_context=12)
    return cfg, init_lm(torch.Generator().manual_seed(seed), cfg,
                        device=dev_or_cpu)


def test_lm_train_step_on_the_card_matches_the_cpu(dev):
    """One LM training step (the float LM's autograd and the optax-equal
    Adam) on the card against the same step on the CPU: the loss within
    1e-5 relative, every parameter within 0.2·lr (Adam scales a small
    gradient entry's float32 noise up to a fraction of lr)."""
    from encodec_tpu_torch.train.lm_train import (create_lm_train_state,
                                                  make_lm_train_step)
    from encodec_tpu_torch.train.optim import tree_leaves

    cfg, params = _small_lm("cpu")
    codes = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.card, (3, cfg.n_q, 40)))
    opt, state = create_lm_train_state(params, lr=3e-4)
    step = make_lm_train_step(cfg, opt)
    p_cpu, _, m_cpu = step(params, state, codes)
    g_params = _small_lm(dev)[1]
    _, g_state = create_lm_train_state(g_params, lr=3e-4)
    p_gpu, s_gpu, m_gpu = step(g_params, g_state, codes.to(dev))
    assert int(s_gpu.count) == 1
    assert abs(m_gpu["nll"].item() - m_cpu["nll"].item()) <= 1e-5 * abs(
        m_cpu["nll"].item())
    for a, b in zip(tree_leaves(p_gpu), tree_leaves(p_cpu)):
        assert a.is_cuda and (a.cpu() - b).abs().max().item() <= 0.2 * 3e-4


def test_lm_forward_batch_matches_scan_on_the_card(dev):
    """The batch path against the streaming cell (past the window's wrap,
    T=30 > W=12) and the reference-signature call, on the card: the
    probabilities within 1e-5."""
    from encodec_tpu_torch.models.lm import LMModel

    cfg, params = _small_lm("cpu", seed=2)
    lm = LMModel(cfg, params, device=dev)
    idx = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.card + 1, (2, cfg.n_q, 30)))
    batch = lm.forward_batch(idx)
    assert batch.is_cuda and tuple(batch.shape) == (2, cfg.card, cfg.n_q, 30)
    assert (lm.scan(idx) - batch).abs().max().item() <= 1e-5
    probas, state, offset = lm(idx[:, :, :17])
    rest, _, offset = lm(idx[:, :, 17:], state, offset)
    assert offset == 30
    assert (torch.cat([probas, rest], -1) - batch).abs().max().item() <= 1e-5


# -- the range decoder of lmv=3, the LM's CDF head fused in (csrc/ac_decode.cu)

def _ac_lanes(S, K, card, T, seed, spread=(4000, 60000)):
    """S host-coded streams of T steps x K symbols under the CDF rows of a
    seeded random head: its product `acc` [T, K, S, card] (integers, as
    float64), bias [K, card] int32, exponent e0 = 4 and the exp2 table;
    lane s's logits spread over `spread[s % 2]` (60000: extreme skew,
    nearly every row one symbol). Returns (acc, head_b, e0, lut, the
    streams, symbols [T, S, K])."""
    import io

    from encodec_tpu_torch.models import ilm
    from encodec_tpu_torch.stream.ac import ArithmeticCoder

    rng = np.random.RandomState(seed)
    e0 = 4
    acc = np.stack([rng.randint(-spread[s % 2] << e0, (spread[s % 2] << e0)
                                + 1, (T, K, card)) for s in range(S)], 2)
    head_b = rng.randint(-2000, 2001, (K, card)).astype(np.int32)
    lut = torch.from_numpy(ilm.exp2_table().astype(np.int64))
    acc = acc.astype(np.float64)
    rows = np.stack([ilm._head_tail(torch.from_numpy(a),
                                    torch.from_numpy(head_b), e0, lut).numpy()
                     for a in acc])                          # [T, S, K, card]
    syms = np.zeros((T, S, K), np.int64)
    datas = []
    for s in range(S):
        fo = io.BytesIO()
        coder = ArithmeticCoder(fo)
        for t in range(T):
            for k in range(K):
                p = np.diff(np.concatenate([[0], rows[t, s, k]]))
                syms[t, s, k] = rng.choice(card, p=p / p.sum())
                coder.push(int(syms[t, s, k]), rows[t, s, k])
        coder.flush()
        datas.append(fo.getvalue())
    return acc, head_b, e0, lut, datas, syms


def _ac_both(dev, acc, head_b, e0, lut, datas, ts):
    """`ac_head_pull` on the card and its twin on the CPU, step by step
    from the same inputs, the step read from a device counter: state,
    codes, feed, ok and eof equal after every step. Returns the card's
    (codes [T, S, K], ok, eof)."""
    from encodec_tpu_torch.kernels import ac_head_pull
    from encodec_tpu_torch.stream import device_ac

    T, K, S, _ = acc.shape
    L = max(1, max(len(d) for d in datas))
    buf = np.zeros((S, L), np.uint8)
    for s, d in enumerate(datas):
        buf[s, :len(d)] = np.frombuffer(d, np.uint8)
    sides = {}
    for side, where in (("card", dev), ("plain", torch.device("cpu"))):
        sides[side] = dict(
            state=device_ac.init_state(S, where),
            head_b=torch.from_numpy(head_b).to(where), lut=lut.to(where),
            data=torch.from_numpy(buf).to(where),
            nbits=torch.tensor([8 * len(d) for d in datas], device=where),
            ts=torch.tensor(ts, device=where),
            t=torch.zeros(1, dtype=torch.int64, device=where),
            codes=torch.zeros((T, S, K), dtype=torch.int64, device=where),
            feed=torch.zeros((S, K), dtype=torch.int64, device=where),
            ok=torch.ones(S, dtype=torch.bool, device=where),
            eof=torch.zeros(S, dtype=torch.bool, device=where))
    names = ("state", "codes", "feed", "ok", "eof")
    for t in range(T):
        for b in sides.values():
            ac_head_pull(b["state"], torch.from_numpy(acc[t]).to(
                b["data"].device), b["head_b"], e0, b["lut"], b["data"],
                b["nbits"], b["ts"], b["t"], b["codes"], b["feed"], b["ok"],
                b["eof"])
            b["t"] += 1
        for n in names:
            assert torch.equal(sides["card"][n].cpu(), sides["plain"][n]), (
                t, n)
    g = sides["card"]
    return g["codes"].cpu().numpy(), g["ok"].cpu(), g["eof"].cpu()


@pytest.mark.parametrize("S,K", [(1, 1), (1, 32), (11, 1), (11, 16),
                                 (2, 32), (11, 32)])
@pytest.mark.parametrize("card", [16, 1024])
def test_ac_head_pull_kernel_matches_plain(dev, S, K, card):
    """Every state field, symbol, feed and flag equal to the twin's after
    every step, at the requests' shapes (S=2, K=32; S=11, K=16) and around
    them; the symbols are the coded ones. With S=11 three lanes end early
    (inactive lanes write zeros and keep their state)."""
    T = 6
    acc, head_b, e0, lut, datas, syms = _ac_lanes(S, K, card, T,
                                                  seed=S * 100 + K + card)
    ts = [T - (s % 3) for s in range(S)]
    codes, ok, eof = _ac_both(dev, acc, head_b, e0, lut, datas, ts)
    assert bool(ok.all()) and not bool(eof.any())
    for s, n in enumerate(ts):
        assert np.array_equal(codes[:n, s], syms[:n, s])
        assert not codes[n:, s].any()


def test_ac_head_pull_kernel_flags_bad_streams_as_plain(dev):
    """A cut stream (eof), flipped bytes and a stream of 0xFF bytes (past
    every interval at its first pull: a head's rows never reach 2^24),
    beside an intact lane."""
    T, K, card = 8, 16, 1024
    acc, head_b, e0, lut, datas, syms = _ac_lanes(5, K, card, T, seed=9)
    bad = list(datas)
    bad[1] = datas[1][:len(datas[1]) // 2]
    for s in (2, 3):
        b = bytearray(datas[s])
        b[(s - 1) * len(b) // 5] ^= 0xFF
        bad[s] = bytes(b)
    bad[4] = b"\xff" * len(datas[4])
    codes, ok, eof = _ac_both(dev, acc, head_b, e0, lut, bad, [T] * 5)
    assert bool(ok[0]) and not bool(eof[0])
    assert np.array_equal(codes[:, 0], syms[:, 0])
    assert bool(eof[1])
    assert not bool(ok[4])


def test_ac_head_pull_counts_one_launch_per_call_and_plans(dev):
    """One counted launch per call; the plan's threads and shared memory
    are the source's; the plan refuses more than 227 KB, and a launch just
    under it (K=54, card 1024: 232,372 B) runs and equals the twin."""
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.kernels import ac_cuda

    acc, head_b, e0, lut, datas, _ = _ac_lanes(2, 3, 16, 4, seed=3)
    before = kernels.ac_head_pull.launches
    _ac_both(dev, acc, head_b, e0, lut, datas, [4, 2])
    assert kernels.ac_head_pull.launches == before + 4
    lib = build.load_library("ac_decode")
    assert lib.ac_head_pull_threads() == ac_cuda.AC_THREADS
    assert lib.ac_head_pull_cluster() == ac_cuda.AC_CLUSTER
    assert lib.ac_head_pull_max_card() == ac_cuda.AC_MAX_CARD
    for K, card in ((1, 16), (16, 1024), (32, 1024), (54, 1024)):
        assert (lib.ac_head_pull_smem_bytes(K)
                == ac_cuda.ac_plan(K, card)["smem"])
    with pytest.raises(ValueError, match="227 KB"):
        ac_cuda.ac_plan(55, 1024)
    acc, head_b, e0, lut, datas, syms = _ac_lanes(1, 54, 1024, 2, seed=4)
    codes, ok, _ = _ac_both(dev, acc, head_b, e0, lut, datas, [2])
    assert bool(ok.all()) and np.array_equal(codes, syms)


def test_decode_lockstep_on_the_card_equals_the_cpu(dev):
    """The integer LM's lockstep decode on the card (a CUDA graph of the
    step, replayed; one `ac_head_pull` launch counted per step, replays
    included) against the CPU route: codes equal at every position, ragged
    lanes; the card's eager runner gives the same codes, and the host range
    decoder over the card's own rows gives them too; a cut stream raises
    EOFError."""
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.models import ilm as ilm_mod
    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.models.lm import LMModel
    from encodec_tpu_torch.stream.ac import encode_bounds, make_decoder

    cfg, params = _small_lm("cpu", seed=4)
    cpu = IntLMModel.from_lm(LMModel(cfg, params, device="cpu"))
    gpu = IntLMModel.from_lm(LMModel(cfg, params, device=dev))
    rng = np.random.RandomState(5)
    Ts = [21, 9, 30]
    codes = [rng.randint(0, cfg.card, (cfg.n_q, T)) for T in Ts]
    datas = [encode_bounds(lo, hi)
             for lo, hi in cpu.codec_symbol_bounds_batched(codes)]
    for _ in range(2):              # a capture, then replays only
        before = kernels.ac_head_pull.launches
        got = gpu.decode_lockstep(datas, cfg.n_q, Ts)
        assert kernels.ac_head_pull.launches == before + max(Ts)
        np.testing.assert_array_equal(got, cpu.decode_lockstep(datas,
                                                               cfg.n_q, Ts))
    for s, T in enumerate(Ts):
        np.testing.assert_array_equal(got[s, :, :T], codes[s])
    # the card's eager runner, and the host decoder over its rows
    S, K = len(Ts), cfg.n_q
    with torch.inference_mode():
        runner = ilm_mod._DecodeGraph(gpu, S, K, 64 * 1024, 32)
        runner.reset(datas, Ts)
        rows = []
        for _ in range(max(Ts)):
            runner.step()
            rows.append(ilm_mod._head_tail(
                runner.acc, gpu.iparams["head_b"][:K], gpu.exps[0],
                gpu.iparams["lut"]["exp2"]).cpu().numpy())
        eager = runner.codes[:max(Ts)].cpu().numpy()        # [T, S, K]
    assert runner.graph is None
    np.testing.assert_array_equal(np.moveaxis(eager, 0, -1), got)
    for s, T in enumerate(Ts):
        dec = make_decoder(datas[s])
        host = np.array([[dec.pull(rows[t][s, k]) for k in range(K)]
                         for t in range(T)]).T
        np.testing.assert_array_equal(host, codes[s])
    with pytest.raises(EOFError):
        gpu.decode_lockstep([datas[0][:len(datas[0]) // 2]], cfg.n_q, Ts[:1])


def test_nccl_collectives_carry_cpu_tensors_through_the_card(dev, tmp_path):
    """On an NCCL group (world 1 here) a CPU tensor is copied to the card
    for the collective and its result comes back on the host, as eval's
    gathered dataset ids do; a CUDA tensor stays on the card; the
    preemption vote and the replicated-metrics check run."""
    import torch.distributed as dist

    from encodec_tpu_torch import parallel
    from encodec_tpu_torch.parallel import comm

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1)
        group = mesh.get_group("data")
        assert comm.transport(group) == "device"
        ids = torch.arange(5, dtype=torch.int64)
        for got in (comm.all_gather(ids, group),
                    comm.all_reduce(ids, "sum", group),
                    comm.broadcast(ids, 0, group)):
            assert got.device.type == "cpu"
            assert torch.equal(got, ids)
        x = torch.randn(3, 4, device=dev)
        got = comm.all_reduce(x, "mean", group)
        assert got.device == x.device and torch.equal(got, x)
        assert comm.any_rank(True, group) and not comm.any_rank(False,
                                                                group)
        comm.DataParallel(group).check_replicated(
            {"loss": x.sum(), "acc": torch.tensor(0.5)})
    finally:
        dist.destroy_process_group()


def test_bf16_steps_on_the_card_match_its_float32_steps(dev):
    """bf16 training compute on the card: a GAN generator step and a
    discriminator step of the tiny model (weight norm; the chunked route)
    from one state, within the CPU tests' bounds of the float32 steps
    (`tests/test_torch_precision.py`: the GAN terms and the
    discriminator's loss rtol 0.1), masters and Adam float32, and K1, K3's
    saving forward and its backward launched."""
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                         make_train_steps)
    from encodec_tpu_torch.train.optim import tree_leaves

    model, disc, x = _tiny_gan(dev, norm="weight_norm")
    fl = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
    w = LossWeights.make(lr=1e-3, disc_lr=1e-3, freq=0.25, commit=0.25)
    state = create_train_state(model, disc, seed=0)
    gen16, disc16, _, _ = make_train_steps(model.cfg, disc,
                                           freq_loss_kwargs=fl,
                                           compute_dtype=torch.bfloat16)
    gen32, disc32, _, _ = make_train_steps(model.cfg, disc,
                                           freq_loss_kwargs=fl)
    kernels.reset_launch_counts()
    s16, m16 = gen16(state, x, w, use_gan=True)
    d16, dm16 = disc16(state, x, w)
    counts = kernels.launch_counts()
    assert counts["nearest_codebook"] > 0 and counts["lstm_scan"] > 0
    assert lstm_scan.save_launches > 0 and counts["lstm_scan_backward"] > 0
    _, m32 = gen32(state, x, w, use_gan=True)
    _, dm32 = disc32(state, x, w)
    for k in ("loss_gen", "loss_feat"):
        assert abs(m16[k].item() - m32[k].item()) <= 0.1 * abs(m32[k].item())
    assert abs(dm16["loss_disc"].item() - dm32["loss_disc"].item()) <= \
        0.1 * abs(dm32["loss_disc"].item())
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in tree_leaves((s16.params, s16.opt_state.mu,
                                     d16.disc_params, d16.disc_opt_state.nu)))


def _small24(dev):
    from encodec_tpu_torch.models import build_model

    model = build_model([1.5, 6.0], sample_rate=24000, channels=1,
                        causal=True, model_norm="weight_norm",
                        name="encodec_24khz", ratios=[8, 5, 4, 2],
                        bins=1024, dimension=16, n_filters=4,
                        kmeans_init=False, device=dev)
    model.set_target_bandwidth(6.0)
    x = torch.from_numpy((0.3 * np.random.RandomState(1).randn(1, 1, 9600))
                         .astype(np.float32)).to(dev)
    return model, x


def test_high_mode_scopes_the_tf32_flags_on_the_card(dev, monkeypatch):
    """'high' turns TF32 on inside the model's call only: the encoder sees
    both flags on, and after the call (an exception included) they are
    back to float32."""
    import encodec_tpu_torch.models.model as mmod

    model, x = _small24(dev)
    seen = []
    enc = mmod.seanet_encoder

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return enc(*a, **k)

    monkeypatch.setattr(mmod, "seanet_encoder", spy)
    model.set_precision("high")
    try:
        model.encode(x)
        assert seen == [(True, True)]
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            model.encode(x[0])
        assert not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
    finally:
        model.set_precision("highest")


def test_fast_mode_launches_k1_k2_k3_and_holds_to_the_twins(dev,
                                                            monkeypatch):
    """'fast' (bf16 conv trunks) on the card: `encode` launches K2 and
    K3, `encode_guarded` K1 at every stage; each kernel is held to its
    plain twin on the very inputs the path gave it (its first call, the
    trunks' bf16 outputs cast to float32): K1's rows and K2's codes equal
    where the twins' margins are at least 1e-3, K1's margins within 1e-3,
    K3's outputs within 1e-4. (The path's codes are not held to the twins'
    path: in bf16, K3's float32 rounding gap to its twin can move a trunk
    output by a whole bf16 step, which the 1e-3 tie flags do not cover.)"""
    import importlib

    from encodec_tpu_torch import kernels

    # by path: the packages export functions of the same names
    lmod = importlib.import_module("encodec_tpu_torch.ops.lstm")
    qmod = importlib.import_module("encodec_tpu_torch.quant.rvq")
    seen = {}
    for mod, name in ((qmod, "nearest_codebook"), (qmod, "rvq_encode_fused"),
                      (lmod, "lstm_scan")):
        def spy(*a, _orig=getattr(mod, name), _name=name, **k):
            seen.setdefault(_name, ([t.detach().clone()
                                     if torch.is_tensor(t) else t
                                     for t in a], k))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    model, x = _small24(dev)
    model.set_precision("fast")
    try:
        kernels.reset_launch_counts()
        model.encode(x)
        model.encode_guarded(x)
        counts = kernels.launch_counts()
    finally:
        model.set_precision("highest")
    assert counts["rvq_encode_fused"] == 1
    assert counts["lstm_scan"] == 4
    assert counts["nearest_codebook"] == model.n_q_active
    a, k = seen["nearest_codebook"]
    idx, m = nearest_codebook(*a, **k)
    idx_p, m_p = nearest_codebook_plain(*a, **k)
    untied = (m >= 1e-3) & (m_p >= 1e-3)
    assert untied.any() and torch.equal(idx[untied], idx_p[untied])
    assert float((m - m_p).abs().max()) <= 1e-3
    (xr, embed, n_q, *rest), k = seen["rvq_encode_fused"]
    shared = bool(rest[0]) if rest else k.get("shared", False)
    codes = rvq_encode_fused(xr, embed, n_q, shared)
    residual, want, margins = xr, [], []
    for q in range(n_q):
        book = embed[0 if shared else q]
        i_p, m_q = nearest_codebook_plain(residual, book)
        want.append(i_p)
        margins.append(m_q)
        residual = residual - book[i_p.long()]
    untied = (torch.stack(margins) >= 1e-3).all(0)
    assert untied.any()
    assert torch.equal(codes[:, untied], torch.stack(want)[:, untied])
    a, k = seen["lstm_scan"]
    assert a[0].dtype == torch.float32
    got, ref = lstm_scan(*a, **k), lstm_scan_plain(*a, **k)
    if torch.is_tensor(got):
        got, ref = (got,), (ref,)
    assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) <= 1e-4


# -- the published configs' training shapes (encodec_tpu_torch/params) ------

@pytest.mark.parametrize("N,bins", [(23_040, 256), (23_040, 512),
                                    (115_200, 512)])
def test_nearest_kernel_at_the_configs_training_shapes(dev, N, bins):
    """K1 at D=256 as a training step of B=8 4 h nights runs it:
    disc256_bins256 and multires_disc / bins512_commit (hop 50, T=2,880 per
    night) and l2_weightnorm (hop 10, T=14,400)."""
    x = _rand((N, 256), 5, dev, scale=0.3)
    e = _books((bins, 256), 6, dev)
    idx, margin = nearest_codebook(x, e)
    ref_idx, ref_margin = nearest_codebook_plain(x, e)
    torch.cuda.synchronize()
    safe = ref_margin >= 1e-5
    assert torch.equal(idx[safe], ref_idx[safe])
    assert torch.allclose(margin, ref_margin, atol=1e-4, rtol=0)


# K1's row-block route (the plan's choice past the cluster split's C=1):
# the four training searches at D=256, the first N past the crossover at
# D=128, rows that do not fill a block, bins=1000 and 65, and D=250 (the
# 4-byte copy path)
ROWBLOCK_SHAPES = [(15_360, 256, 1024), (23_040, 256, 512),
                   (115_200, 256, 512), (23_040, 256, 256),
                   (4_225, 128, 1024), (20_001, 256, 1000),
                   (5_001, 250, 1000), (9_999, 256, 65)]


@pytest.mark.parametrize("N,D,bins", ROWBLOCK_SHAPES)
def test_rowblock_route_equals_the_cluster_route_bit_for_bit(dev, N, D,
                                                             bins):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert vq_cuda.nearest_plan(N, bins, D, sms).route == "rowblock"
    x = _rand((N, D), 30, dev, scale=0.3)
    e = _books((bins, D), 31, dev)
    before = (nearest_codebook.launches, nearest_codebook.rowblock_launches)
    got = nearest_codebook(x, e, return_score=True)
    assert (nearest_codebook.launches, nearest_codebook.rowblock_launches) \
        == (before[0] + 1, before[1] + 1)
    want = nearest_codebook(x, e, return_score=True, _route="cluster")
    assert nearest_codebook.rowblock_launches == before[1] + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), int((g != w).sum())
    # and without the score output, the same index and margin
    idx, margin = nearest_codebook(x, e)
    assert torch.equal(idx, got[0]) and torch.equal(margin, got[1])


@pytest.mark.parametrize("N,bins,dups", [(23_040, 512, (400, 3, 130, 260)),
                                         (15_360, 1024, (900, 5, 700, 129))])
def test_rowblock_route_duplicates_across_tiles_and_ctas(dev, N, bins, dups):
    # the nearest row at bins in different 128-bin tiles and (at 512 bins,
    # C=2) different CTAs of the cluster: the lowest index, margin 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = vq_cuda.nearest_plan(N, bins, 256, sms)
    assert plan.route == "rowblock"
    assert len({j // 128 for j in dups}) == len(dups)
    e = _books((bins, 256), 32, dev)
    for j in dups[1:]:
        e[j] = e[dups[0]]
    x = (e[dups[0]][None] + _rand((N, 256), 33, dev, scale=1e-3)).contiguous()
    idx, margin, score = nearest_codebook(x, e, return_score=True)
    torch.cuda.synchronize()
    assert idx.tolist() == [min(dups)] * N
    assert margin.tolist() == [0.0] * N
    want = nearest_codebook(x, e, return_score=True, _route="cluster")
    assert torch.equal(score, want[2])


def test_lstm_saving_forward_and_backward_over_a_4h_night_at_h512(dev):
    """K3's saving forward and its backward kernel at H=512 over T=14,400
    steps (l2_weightnorm: hop 10 on a 4 h night), B=2, against the twins."""
    B, T, H = 2, 14_400, 512
    xp, w, _, _ = _lstm_inputs(dev, B, T, H, 99)
    out, c_seq = lstm_scan(xp, w, save_c=True)
    plain_out, plain_c = lstm_scan_plain(xp, w, save_c=True)
    torch.cuda.synchronize()
    assert (out - plain_out).abs().max().item() <= 1e-4
    assert (c_seq - plain_c).abs().max().item() <= 1e-4
    pre = (xp + torch.cat([torch.zeros(B, 1, H, device=dev),
                           plain_out[:, :-1]], 1) @ w.t()).contiguous()
    dy = _rand((B, T, H), 100, dev)
    got = lstm_scan_backward(pre, plain_c, dy, w)
    want = lstm_scan_backward_plain(pre, plain_c, dy, w)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert (g - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())
