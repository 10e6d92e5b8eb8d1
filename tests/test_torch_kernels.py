"""Parity of the kernels' plain twins (what the wrappers run for CPU tensors)
with the JAX package's Pallas kernels, run in interpret mode on the CPU the
way `tests/test_pallas.py` runs them. The CUDA kernels themselves are held
against these twins on the GPU by `tests/test_torch_cuda.py` and
`chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu import ops as jops
from encodec_tpu.kernels.lstm_pallas import lstm_pallas, lstm_scan_pallas
from encodec_tpu.kernels.vq_pallas import (nearest_codebook_pallas,
                                           rvq_encode_pallas)
from encodec_tpu.quant import RVQConfig, init_rvq
from encodec_tpu.quant.rvq import rvq_encode_margins as jax_rvq_encode_margins
from encodec_tpu_torch import kernels, ops as tops
from encodec_tpu_torch.models.zoo import lstm_params_from_state


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def f64_stage_margins(x, books, n_q, shared):
    """Per-stage top-2 gaps of the float64 RVQ chain along the reference
    codes: [n_q, N]. A float32 implementation may pick either row where
    this gap is below its rounding (~1e-5 at these magnitudes)."""
    r = x.astype(np.float64)
    out = []
    for k in range(n_q):
        e = books[0 if shared else k].astype(np.float64)
        d = ((r[:, None, :] - e[None]) ** 2).sum(-1)
        part = np.partition(d, 1, axis=1)
        out.append(part[:, 1] - part[:, 0])
        r = r - e[d.argmin(1)]
    return np.stack(out)


def assert_codes_match(got, want, x, books, shared, tol=1e-5):
    """Codes equal everywhere except rows whose first differing stage is a
    float32 near-tie in float64 (gap < tol); such rows must be rare."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if not diff.any():
        return
    gaps = f64_stage_margins(x, books, got.shape[0], shared)
    rows = np.nonzero(diff.any(0))[0]
    first = diff[:, rows].argmax(0)
    assert (gaps[first, rows] < tol).all(), (rows, gaps[first, rows])
    assert rows.size <= max(1, got.shape[1] // 100)


@pytest.mark.parametrize("N,D,bins", [(600, 128, 1024), (75, 128, 256),
                                      (1024, 256, 512)])
def test_nearest_twin_matches_pallas(N, D, bins):
    x, e = _randn(N, N, D), _randn(bins, bins, D)
    want = nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(e), tile_n=256,
                                   interpret=True)
    idx, margin = kernels.nearest_codebook(_t(x), _t(e))
    assert idx.dtype == torch.int32 and margin.shape == (N,)
    assert_codes_match(idx.numpy()[None], np.asarray(want)[None], x, e[None],
                       shared=True)


def test_nearest_twin_duplicate_rows_tie_to_lowest():
    x = torch.ones(8, 128)
    e = torch.cat([torch.ones(4, 128), torch.zeros(4, 128)])
    idx, margin = kernels.nearest_codebook(x, e)
    assert idx.tolist() == [0] * 8
    assert margin.tolist() == [0.0] * 8


def test_nearest_twin_margin_matches_rvq_encode_margins_stage0():
    cfg = RVQConfig(dimension=32, n_q=2, bins=128, kmeans_init=False)
    state = init_rvq(jax.random.PRNGKey(4), cfg)
    x = _randn(5, 2, 40, 32, scale=0.3)
    codes, margins = jax_rvq_encode_margins(state, jnp.asarray(x), cfg, n_q=1)
    idx, margin = kernels.nearest_codebook(
        _t(x.reshape(-1, 32)), _t(np.asarray(state.embed[0])))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(codes).reshape(-1))
    # distances are O(1-10): float32 rounding of the two frameworks' dots
    np.testing.assert_allclose(margin.numpy(), np.asarray(margins).reshape(-1),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_fused_rvq_twin_matches_pallas(shared):
    cfg = RVQConfig(dimension=128, n_q=4, bins=256, kmeans_init=False,
                    shared_codebook=shared)
    state = init_rvq(jax.random.PRNGKey(0), cfg)
    x = _randn(1, 100, 128, scale=0.3)
    books = np.asarray(state.embed)
    want = rvq_encode_pallas(jnp.asarray(x), state.embed, n_q=4,
                             shared=shared, tile_n=64, interpret=True)
    got = kernels.rvq_encode_fused(_t(x), _t(books), 4, shared)
    assert got.shape == (4, 100) and got.dtype == torch.int32
    assert_codes_match(got.numpy(), want, x, books, shared)


def _lstm_pair(seed, dim, layers):
    from encodec_tpu.models.torch_zoo import _lstm_to_torch
    p = jops.init_lstm(jax.random.PRNGKey(seed), dim, num_layers=layers)
    state = {}
    _lstm_to_torch(p, "l.", state)
    return p, lstm_params_from_state(state, "l.", layers)


@pytest.mark.parametrize("B,T,H,layers", [(4, 50, 64, 2), (2, 37, 32, 1)])
def test_lstm_twin_matches_pallas(B, T, H, layers):
    """The full-sequence SLSTM (K3 per layer) against `lstm_pallas`, incl.
    an odd T that is not a multiple of the Pallas chunk. rtol/atol 1e-5 as
    in the JAX kernel tests: the frameworks sum the recurrent dot in
    different orders."""
    pj, pt = _lstm_pair(B + T, H, layers)
    x = _randn(T, B, T, H)
    want = lstm_pallas(pj, jnp.asarray(x), skip=True, chunk=16, interpret=True,
                       precision=jax.lax.Precision.HIGHEST)
    got = tops.lstm(pt, _t(x), skip=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lstm_scan_twin_matches_pallas_scan():
    H = 16
    xp = _randn(1, 3, 21, 4 * H)
    w_hh = _randn(2, 4 * H, H, scale=0.25)
    want = lstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh.T), chunk=8,
                            interpret=True)
    got = kernels.lstm_scan(_t(xp), _t(w_hh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "shape"])
def test_wrappers_validate_arguments(bad):
    x, e = torch.randn(10, 8), torch.randn(16, 8)
    xp, w = torch.randn(2, 5, 16), torch.randn(16, 4)
    if bad == "dtype":
        cases = [(kernels.nearest_codebook, (x.double(), e)),
                 (kernels.rvq_encode_fused, (x, e[None].half(), 1)),
                 (kernels.lstm_scan, (xp, w.double()))]
    elif bad == "noncontig":
        cases = [(kernels.nearest_codebook, (torch.randn(8, 10).t(), e)),
                 (kernels.rvq_encode_fused, (x, torch.randn(1, 8, 16).transpose(1, 2), 1)),
                 (kernels.lstm_scan, (torch.randn(2, 16, 5).transpose(1, 2), w))]
    else:
        cases = [(kernels.nearest_codebook, (x, torch.randn(16, 9))),
                 (kernels.rvq_encode_fused, (x, e[None], 2)),
                 (kernels.lstm_scan, (xp, torch.randn(16, 5)))]
    for fn, args in cases:
        with pytest.raises((TypeError, ValueError)):
            fn(*args)
