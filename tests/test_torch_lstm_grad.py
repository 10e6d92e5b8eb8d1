"""K3's gradient on the CPU: the port against the JAX package.

- The plain backward twin (`lstm_scan_backward_plain`, the reverse
  recurrence the backward kernel runs) against `jax.vjp` of
  `encodec_tpu/ops/lstm.py::_layer` (the `lax.scan` JAX's trainer
  differentiates), from zero and from a given state, with a gradient on
  the final c as well;
- `ops.lstm`'s autograd route (`LstmLayer` with the plain twins, the
  route training takes on the CPU) against `jax.vjp` of JAX's stacked
  `ops.lstm`, for every parameter, the input and the state;
- the saving forward (`save_c=True`) against the plain recurrence.

Inputs are seeded numpy arrays. Tolerance: rtol 1e-5 with an absolute
floor of 1e-5 of the largest |value| (a 12-step chain summed in another
order by XLA and oneDNN; values near zero have no relative precision).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)

from encodec_tpu.ops.lstm import _layer as jax_layer
from encodec_tpu.ops.lstm import lstm as jax_lstm
from encodec_tpu_torch.kernels import (lstm_scan, lstm_scan_backward,
                                       lstm_scan_backward_plain,
                                       lstm_scan_plain)
from encodec_tpu_torch.ops import lstm as port_lstm


def _close(got, want, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


def _u(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


@pytest.mark.parametrize("stateful", [False, True])
def test_plain_backward_twin_matches_jax_vjp(stateful):
    """W_ih = I and zero biases make `_layer`'s projection the identity, so
    its VJP with respect to x is d xp, the twin's dgates."""
    B, T, H = 3, 12, 16
    rng = np.random.RandomState(11)
    w_hh = _u(rng, (4 * H, H), 1.0 / np.sqrt(H))
    xp = rng.randn(B, T, 4 * H).astype(np.float32)
    if stateful:
        h0 = np.tanh(rng.randn(B, H)).astype(np.float32)
        c0 = rng.randn(B, H).astype(np.float32)
    else:
        h0 = c0 = np.zeros((B, H), np.float32)
    dy = rng.randn(B, T, H).astype(np.float32)
    dcT = (0.5 * rng.randn(B, H)).astype(np.float32)
    layer = {"w_ih": np.eye(4 * H, dtype=np.float32), "w_hh": w_hh,
             "b_ih": np.zeros(4 * H, np.float32),
             "b_hh": np.zeros(4 * H, np.float32)}

    def f(x, w, h, c):
        return jax_layer(dict(layer, w_hh=w), x, h, c)

    _, vjp = jax.vjp(f, xp, w_hh, h0, c0)
    dx, dw, dh0, dc0 = vjp((dy, np.zeros((B, H), np.float32), dcT))

    t = {k: torch.from_numpy(v) for k, v in
         dict(xp=xp, w=w_hh, h0=h0, c0=c0, dy=dy, dcT=dcT).items()}
    st = (t["h0"], t["c0"]) if stateful else (None, None)
    out, c_seq = lstm_scan_plain(t["xp"], t["w"], *st, save_c=True)
    first = t["h0"][:, None] if stateful else torch.zeros(B, 1, H)
    h_prev = torch.cat([first, out[:, :-1]], 1)
    pre = t["xp"] + h_prev @ t["w"].t()
    dgates, g_h0, g_c0 = lstm_scan_backward_plain(pre, c_seq, t["dy"], t["w"],
                                                  st[1], t["dcT"])
    _close(dgates, dx, "dxp")
    _close(dgates.reshape(-1, 4 * H).t() @ h_prev.reshape(-1, H), dw, "dW_hh")
    _close(g_h0, dh0, "dh0")
    _close(g_c0, dc0, "dc0")
    # on CPU tensors the wrapper is the twin
    wrapped = lstm_scan_backward(pre, c_seq, t["dy"], t["w"], st[1], t["dcT"])
    for a, b in zip(wrapped, (dgates, g_h0, g_c0)):
        assert torch.equal(a, b)
    assert lstm_scan_backward(pre, c_seq, t["dy"], t["w"], st[1], t["dcT"],
                              state_grad=False)[1:] == (None, None)


@pytest.mark.parametrize("stateful", [False, True])
def test_lstm_autograd_route_matches_jax_vjp(stateful):
    B, T, C = 2, 10, 12
    rng = np.random.RandomState(12)
    bound = 1.0 / np.sqrt(C)
    layers = [{k: _u(rng, s, bound) for k, s in
               (("w_ih", (4 * C, C)), ("w_hh", (4 * C, C)), ("b_ih", (4 * C,)),
                ("b_hh", (4 * C,)))} for _ in range(2)]
    x = rng.randn(B, T, C).astype(np.float32)
    h0 = np.tanh(rng.randn(2, B, C)).astype(np.float32)
    c0 = rng.randn(2, B, C).astype(np.float32)
    dy = rng.randn(B, T, C).astype(np.float32)
    dh = rng.randn(2, B, C).astype(np.float32)
    dc = rng.randn(2, B, C).astype(np.float32)

    def f(params, x, h, c):
        st = (h, c) if stateful else None
        return jax_lstm(params, x, state=st, return_state=True)

    _, vjp = jax.vjp(f, {"layers": layers}, x, h0, c0)
    jp, jx, jh, jc = vjp((dy, (dh, dc)))

    params = {"layers": [{k: torch.from_numpy(v).requires_grad_(True)
                          for k, v in layer.items()} for layer in layers]}
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(h0).requires_grad_(True)
    tc = torch.from_numpy(c0).requires_grad_(True)
    y, (hT, cT) = port_lstm(params, tx, state=(th, tc) if stateful else None,
                            return_state=True)
    leaves = [tx] + [p[k] for p in params["layers"] for k in sorted(p)]
    if stateful:
        leaves += [th, tc]
    grads = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (hT * torch.from_numpy(dh)).sum()
        + (cT * torch.from_numpy(dc)).sum(), leaves)
    want = [jx] + [jp["layers"][i][k] for i in range(2)
                   for k in sorted(layers[i])]
    if stateful:
        want += [jh, jc]
    for g, w in zip(grads, want):
        _close(g, w)


def test_saving_forward_matches_the_recurrence():
    B, T, H = 2, 9, 8
    rng = np.random.RandomState(13)
    xp = torch.from_numpy(rng.randn(B, T, 4 * H).astype(np.float32))
    w = torch.from_numpy(_u(rng, (4 * H, H), 0.3))
    out, c_seq = lstm_scan(xp, w, save_c=True)
    ref, hT, cT = lstm_scan_plain(xp, w, return_state=True)
    assert torch.equal(out, ref) and torch.equal(c_seq[:, -1], cT)
    with pytest.raises(ValueError, match="save_c"):
        lstm_scan(xp, w, return_state=True, save_c=True)
