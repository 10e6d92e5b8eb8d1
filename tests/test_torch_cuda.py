"""Kernel checks that need the GPU: each hand-written CUDA kernel against its
plain PyTorch twin on the card, at the 24 kHz and 48 kHz main-path shapes
(a 10 s 48 kHz request: K1 and K2 at N=1500 rows, n_q up to 16; K3 at
B=10, T=150 for the ten full segments and B=1, T=15 or 1 for the tail),
the stream's (K2 at N=6 and 7; K3 from a carried state, bit-equal to one
launch over the whole sequence) and the breathing tokenizer's (K3's grid
kernel at H=1024: a 4 h night is T=480, a training batch B=32), and the
lmv=3 integer LM's CDF rows on the card against the CPU's.

This file imports no JAX (the GPU machine has none). On a machine without
a CUDA device every test skips. Run on the H100 with:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from encodec_tpu_torch.kernels import (build, lstm_cuda, lstm_scan,
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
    ls = build.load_library("lstm_scan")
    assert ls.lstm_scan_units_per_cta_max() == lstm_cuda.K3_MAX_UNITS
    assert ls.lstm_scan_max_cluster() == lstm_cuda.K3_MAX_CLUSTER
    assert ls.lstm_scan_reg_rows() == lstm_cuda.K3_REG_ROWS
    assert ls.lstm_scan_threads() == lstm_cuda.K3_THREADS
    for H in (1, 32, 200, 512):
        assert ls.lstm_scan_smem_bytes(H) == lstm_cuda.lstm_smem_bytes(H)
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
              (7, 128, 1024, 8, False), (7, 128, 1024, 32, False)]


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
    # more sequences than clusters in flight: each cluster runs several
    H, T = 512, 40
    B = lstm_cuda.max_active_clusters(H, dev) + 3
    assert lstm_cuda.lstm_plan(B, H, B - 3).n_clusters < B
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
    lib = build.load_library("lstm_grid")
    assert lib.lstm_grid_threads() == lstm_cuda.GRID_THREADS
    assert lib.lstm_grid_max_units() == lstm_cuda.GRID_MAX_UNITS
    assert lib.lstm_grid_batch_tile() == lstm_cuda.GRID_BATCH_TILE
    assert lib.lstm_grid_max_batch() == lstm_cuda.GRID_MAX_BATCH
    assert lib.lstm_grid_max_h() == lstm_cuda.GRID_MAX_H
    for H in (513, 640, 1000, 1024):
        for B in (1, 8, 9, lstm_cuda.grid_max_batch(H)):
            assert lib.lstm_grid_smem_bytes(H, B) == lstm_cuda.grid_smem_bytes(
                H, B)
        assert lib.lstm_grid_smem_bytes(H, lstm_cuda.grid_max_batch(H) + 8) == -1
        # one CTA per SM, and the plan's grid fits what the card holds
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n = lstm_cuda.max_grid_ctas(H, dev)
        assert n >= sms
        assert lstm_cuda.grid_plan(32, H, n).ctas <= n


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
