"""Kernel checks that need the GPU: each hand-written CUDA kernel against its
plain PyTorch twin on the card, at the 24 kHz main-path shapes.

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


@pytest.mark.parametrize("N,D,bins", [(3000, 128, 1024), (600, 128, 1024),
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
    ls = build.load_library("lstm_scan")
    assert ls.lstm_scan_units_per_cta_max() == lstm_cuda.K3_MAX_UNITS
    assert ls.lstm_scan_max_cluster() == lstm_cuda.K3_MAX_CLUSTER
    assert ls.lstm_scan_reg_rows() == lstm_cuda.K3_REG_ROWS
    assert ls.lstm_scan_threads() == lstm_cuda.K3_THREADS
    for H in (1, 32, 200, 512):
        assert ls.lstm_scan_smem_bytes(H) == lstm_cuda.lstm_smem_bytes(H)
    # the served shape's cluster (16 CTAs) must be schedulable
    assert lstm_cuda.max_active_clusters(512, dev) >= 1


@pytest.mark.parametrize("n_q,shared", [(8, False), (32, False), (8, True)])
def test_fused_rvq_kernel_matches_plain(dev, n_q, shared):
    N, D, bins = 750, 128, 1024
    e = _books((1 if shared else n_q, bins, D), 2, dev)
    x = _rand((N, D), 3, dev, scale=0.3)
    codes = rvq_encode_fused(x, e, n_q, shared)
    ref = rvq_encode_fused_plain(x, e, n_q, shared)
    torch.cuda.synchronize()
    _, margins = plain_stage_margins(x, e, n_q, shared)
    diff = codes != ref
    first = torch.where(diff.any(0), diff.int().argmax(0), -1)
    bad = [(k, n) for n, k in enumerate(first.tolist())
           if k >= 0 and margins[k, n] >= 1e-4]
    assert not bad, bad[:10]


@pytest.mark.parametrize("B,T,H", [(4, 750, 512), (2, 37, 32), (1, 5, 64),
                                   (70, 9, 512), (3, 11, 200), (1, 1, 512),
                                   (1, 750, 512), (8, 750, 512), (2, 20, 7)])
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


def test_lstm_scan_kernel_refuses_large_hidden(dev):
    xp = torch.zeros(1, 2, 4 * 520, device=dev)
    with pytest.raises(ValueError):
        lstm_scan(xp, torch.zeros(4 * 520, 520, device=dev))
