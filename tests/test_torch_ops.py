"""Parity of the port's L0 ops (`encodec_tpu_torch.ops`) with the JAX package.

The same numpy inputs go through the JAX op and its port; parameters are
made by the JAX initializers and carried across in the reference torch
layout (the exporters `torch_state_from_params` uses) and read by the
port's loader. Everything runs on the CPU (`device="cpu"`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu import ops as jops
from encodec_tpu.models.torch_zoo import (_conv1d_to_torch, _convtr_to_torch,
                                          _lstm_to_torch)
from encodec_tpu_torch import ops as tops
from encodec_tpu_torch.models.zoo import (conv_params_from_state,
                                          lstm_params_from_state)

# Float tolerance for conv/LSTM outputs: XLA and oneDNN sum the same
# products in different orders (~1e-7 relative per op at these sizes).
RTOL = ATOL = 1e-5


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("mode", ["reflect", "zero", "replicate"])
@pytest.mark.parametrize("length,paddings", [(20, (6, 2)), (20, (0, 3)),
                                             (3, (5, 2)), (2, (1, 4))])
def test_pad1d_matches_jax(mode, length, paddings):
    """Includes the short-input reflect case (length <= pad)."""
    x = _randn(0, 2, length, 3)
    want = np.asarray(jops.pad1d(jnp.asarray(x), paddings, mode=mode))
    got = tops.pad1d(_t(x), paddings, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    back = tops.unpad1d(_t(want), paddings).numpy()
    np.testing.assert_array_equal(back, x)


def test_extra_padding_matches_jax():
    for length in (1, 7, 100, 2401):
        for k, s in ((7, 1), (4, 2), (16, 8), (10, 5)):
            assert tops.get_extra_padding_for_conv1d(length, k, s, k - s) == \
                jops.get_extra_padding_for_conv1d(length, k, s, k - s)


# (kernel, stride, dilation) of every conv in the 24 kHz model: init/final
# k=7, resblock k=3 and k=1 (+ shortcut k=1), downsampling k=2r s=r.
CONV_CASES_24K = [(7, 1, 1), (3, 1, 1), (1, 1, 1), (4, 2, 1), (8, 4, 1),
                  (10, 5, 1), (16, 8, 1)]


@pytest.mark.parametrize("kernel,stride,dilation", CONV_CASES_24K)
@pytest.mark.parametrize("causal", [True, False])
def test_sconv1d_weight_norm_matches_jax(kernel, stride, dilation, causal):
    cin, cout, T = 6, 8, 53
    p = jops.init_sconv1d(jax.random.PRNGKey(kernel * 10 + stride), cin, cout,
                          kernel, norm="weight_norm")
    state = {}
    _conv1d_to_torch(p, "m.", state)
    tp_ = conv_params_from_state(state, "m.", norm="weight_norm")
    x = _randn(1, 2, T, cin)
    kw = dict(kernel_size=kernel, stride=stride, dilation=dilation,
              causal=causal, norm="weight_norm", pad_mode="reflect")
    want = np.asarray(jops.sconv1d(p, jnp.asarray(x), **kw,
                                   precision=jax.lax.Precision.HIGHEST))
    got = tops.sconv1d(tp_, _t(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel,stride", [(4, 2), (8, 4), (10, 5), (16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_sconv_transpose1d_weight_norm_matches_jax(kernel, stride, causal):
    """Weight norm of a transposed conv is per-Cin (torch dim 0)."""
    cin, cout, T = 8, 4, 11
    p = jops.init_sconv_transpose1d(jax.random.PRNGKey(kernel), cin, cout,
                                    kernel, norm="weight_norm")
    state = {}
    _convtr_to_torch(p, "m.", state)
    tp_ = conv_params_from_state(state, "m.", norm="weight_norm",
                                 kind="convtr")
    x = _randn(2, 2, T, cin)
    kw = dict(kernel_size=kernel, stride=stride, causal=causal,
              norm="weight_norm")
    want = np.asarray(jops.sconv_transpose1d(
        p, jnp.asarray(x), **kw, precision=jax.lax.Precision.HIGHEST))
    got = tops.sconv_transpose1d(tp_, _t(x), **kw).numpy()
    assert got.shape == want.shape == (2, T * stride, cout)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["layer_norm", "time_group_norm"])
def test_norms_match_jax(norm):
    x = _randn(3, 2, 17, 5, scale=2.0)
    scale, bias = _randn(4, 5), _randn(5, 5)
    fj = getattr(jops, norm)
    ft = getattr(tops, norm)
    want = np.asarray(fj(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = ft(_t(x), _t(scale), _t(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _lstm_pair(seed, dim, layers):
    p = jops.init_lstm(jax.random.PRNGKey(seed), dim, num_layers=layers)
    state = {}
    _lstm_to_torch(p, "l.", state)
    return p, lstm_params_from_state(state, "l.", layers)


@pytest.mark.parametrize("skip", [True, False])
def test_lstm_zero_state_matches_jax(skip):
    pj, pt = _lstm_pair(0, 16, 2)
    x = _randn(6, 3, 29, 16)
    want = np.asarray(jops.lstm(pj, jnp.asarray(x), skip=skip,
                                precision=jax.lax.Precision.HIGHEST))
    got = tops.lstm(pt, _t(x), skip=skip).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lstm_with_state_and_return_state_matches_jax():
    pj, pt = _lstm_pair(1, 12, 2)
    x = _randn(7, 2, 15, 12)
    h0, c0 = _randn(8, 2, 2, 12, scale=0.5), _randn(9, 2, 2, 12, scale=0.5)
    yj, (hj, cj) = jops.lstm(pj, jnp.asarray(x), skip=True,
                             state=(jnp.asarray(h0), jnp.asarray(c0)),
                             return_state=True,
                             precision=jax.lax.Precision.HIGHEST)
    yt, (ht, ct) = tops.lstm(pt, _t(x), skip=True, state=(_t(h0), _t(c0)),
                             return_state=True)
    for got, want in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    # return_state from zero state: same outputs as the kernel path
    y0, _ = tops.lstm(pt, _t(x), return_state=True)
    np.testing.assert_allclose(y0.numpy(), tops.lstm(pt, _t(x)).numpy(),
                               rtol=0, atol=1e-6)


def test_lstm_step_matches_jax():
    pj, pt = _lstm_pair(2, 10, 2)
    x = _randn(10, 3, 10)
    h, c = _randn(11, 2, 3, 10, scale=0.5), _randn(12, 2, 3, 10, scale=0.5)
    yj, (hj, cj) = jops.lstm_step(pj, jnp.asarray(x),
                                  (jnp.asarray(h), jnp.asarray(c)),
                                  precision=jax.lax.Precision.HIGHEST)
    yt, (ht, ct) = tops.lstm_step(pt, _t(x), (_t(h), _t(c)))
    for got, want in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_weight_norm_fold_matches_jax():
    p = jops.init_sconv1d(jax.random.PRNGKey(3), 4, 6, 3, norm="weight_norm")
    state = {}
    _conv1d_to_torch(p, "m.", state)
    tp_ = conv_params_from_state(state, "m.", norm="weight_norm")
    want = np.asarray(jops.fold_weight_norm(p)["w"]).transpose(2, 1, 0)
    got = tops.fold_weight_norm(tp_)["w"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
