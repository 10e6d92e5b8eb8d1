"""The port's DAC-style RVQ (`encodec_tpu_torch/quant/dac_vq.py`) against
JAX's (`encodec_tpu/quant/dac_vq.py`) on the same numpy weights: the five
cases of `tests/test_dac_vq.py` (weight-norm folding, the eval forward,
`from_codes` and `from_latents`, quantizer dropout with straight-through,
snake), and the port's own `torch.Generator` draws. Values within rtol
and atol 1e-5, codes equal."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.quant import dac_vq as jdac
from encodec_tpu_torch.quant import dac_vq as tdac

TOL = dict(rtol=1e-5, atol=1e-5)


def _torch_params(jparams) -> dict:
    """JAX's tree (`v` as [in, out]) in the port's layout (`v` [out, in])."""
    def wn(p):
        return {"v": torch.from_numpy(np.asarray(p["v"]).T.copy()),
                "g": torch.from_numpy(np.array(p["g"])),
                "b": torch.from_numpy(np.array(p["b"]))}
    return {"stages": [{"in_proj": wn(s["in_proj"]),
                        "out_proj": wn(s["out_proj"]),
                        "codebook": torch.from_numpy(np.array(
                            s["codebook"]))}
                       for s in jparams["stages"]]}


def _pair(cfg, seed):
    jparams = jdac.init_dac_rvq(jax.random.PRNGKey(seed), cfg)
    return jparams, _torch_params(jparams)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a), np.asarray(b), **TOL)


def test_wn_linear_parity():
    """The folded weight `g·v/‖v‖` and the projection equal JAX's, and
    torch's own weight norm of a 1x1 conv on the reference layout."""
    rng = np.random.RandomState(0)
    v = rng.randn(3, 6).astype(np.float32)          # [out, in]
    g = rng.rand(3).astype(np.float32) + 0.5
    b = rng.randn(3).astype(np.float32)
    x = rng.randn(2, 5, 6).astype(np.float32)
    got = tdac._wn_linear({"v": torch.from_numpy(v), "g": torch.from_numpy(g),
                           "b": torch.from_numpy(b)}, torch.from_numpy(x))
    want = jdac._wn_linear({"v": jnp.asarray(v.T), "g": jnp.asarray(g),
                            "b": jnp.asarray(b)}, jnp.asarray(x))
    _close(got, want)
    conv = torch.nn.utils.parametrizations.weight_norm(
        torch.nn.Conv1d(6, 3, 1))
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(
            torch.from_numpy(g)[:, None, None])
        conv.parametrizations.weight.original1.copy_(
            torch.from_numpy(v)[:, :, None])
        conv.bias.copy_(torch.from_numpy(b))
        ref = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    _close(got, ref)


def test_dac_rvq_eval_parity():
    cfg_kw = dict(input_dim=16, n_codebooks=4, codebook_size=32,
                  codebook_dim=8)
    jparams, tparams = _pair(jdac.DacRVQConfig(**cfg_kw), 1)
    x = _x(1, (2, 9, 16))
    want = jdac.dac_rvq_forward(jparams, jnp.asarray(x),
                                jdac.DacRVQConfig(**cfg_kw), training=False)
    got = tdac.dac_rvq_forward(tparams, torch.from_numpy(x),
                               tdac.DacRVQConfig(**cfg_kw), training=False)
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    for k in ("z", "latents", "commitment_loss", "codebook_loss"):
        _close(got[k], want[k])
    # fewer quantizers at eval
    want3 = jdac.dac_rvq_forward(jparams, jnp.asarray(x),
                                 jdac.DacRVQConfig(**cfg_kw), n_quantizers=2)
    got3 = tdac.dac_rvq_forward(tparams, torch.from_numpy(x),
                                tdac.DacRVQConfig(**cfg_kw), n_quantizers=2)
    np.testing.assert_array_equal(got3["codes"].numpy(),
                                  np.asarray(want3["codes"]))
    _close(got3["z"], want3["z"])


def test_dac_from_codes_and_latents_parity():
    cfg_kw = dict(input_dim=16, n_codebooks=3, codebook_size=32,
                  codebook_dim=(8, 4, 6))
    jcfg, tcfg = jdac.DacRVQConfig(**cfg_kw), tdac.DacRVQConfig(**cfg_kw)
    jparams, tparams = _pair(jcfg, 2)
    x = _x(2, (2, 7, 16))
    out = jdac.dac_rvq_forward(jparams, jnp.asarray(x), jcfg)
    codes = np.array(out["codes"])
    jz, jp, _ = jdac.dac_from_codes(jparams, jnp.asarray(codes))
    tz, tp_, tc = tdac.dac_from_codes(tparams, torch.from_numpy(codes))
    _close(tz, jz)
    _close(tp_, jp)
    assert tc.shape == codes.shape
    lat = np.array(out["latents"])
    for width in (lat.shape[-1], 12):    # all stages, and the first two
        jz2, jp2, jc2 = jdac.dac_from_latents(jparams, jnp.asarray(
            lat[..., :width]), jcfg)
        tz2, tp2, tc2 = tdac.dac_from_latents(tparams, torch.from_numpy(
            lat[..., :width]), tcfg)
        np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
        _close(tz2, jz2)
        _close(tp2, jp2)


def test_quantizer_dropout_and_straight_through():
    """Training with dropout on JAX's own draws: the same outputs; the
    gradient reaches the input through the straight-through estimator;
    the codebook loss reaches no codebook in training (the fork's order)
    and does at eval, as in JAX."""
    cfg_kw = dict(input_dim=8, n_codebooks=3, codebook_size=16,
                  codebook_dim=4, quantizer_dropout=0.5)
    jcfg, tcfg = jdac.DacRVQConfig(**cfg_kw), tdac.DacRVQConfig(**cfg_kw)
    jparams, tparams = _pair(jcfg, 0)
    x = _x(3, (4, 6, 8))
    key = jax.random.PRNGKey(2)
    want = jdac.dac_rvq_forward(jparams, jnp.asarray(x), jcfg, training=True,
                                rng=key)
    draws = torch.from_numpy(np.asarray(
        jax.random.randint(key, (4,), 1, 4)).astype(np.int64))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tdac.dac_rvq_forward(tparams, xt, tcfg, training=True,
                               draws=draws)
    assert got["codes"].shape == (4, 3, 6)
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    for k in ("z", "latents", "commitment_loss", "codebook_loss"):
        _close(got[k], want[k])

    g, = torch.autograd.grad(got["z"].sum(), xt)
    jg = jax.grad(lambda v: jnp.sum(jdac.dac_rvq_forward(
        jparams, v, jcfg, training=True, rng=key)["z"]))(jnp.asarray(x))
    assert float(g.abs().sum()) > 0
    _close(g, jg)

    for training, nonzero in ((True, False), (False, True)):
        books = [s["codebook"].clone().requires_grad_(True)
                 for s in tparams["stages"]]
        p = {"stages": [dict(s, codebook=c)
                        for s, c in zip(tparams["stages"], books)]}
        out = tdac.dac_rvq_forward(p, torch.from_numpy(x).requires_grad_(
            True), tcfg, training=training, draws=draws)
        gc, = torch.autograd.grad(out["codebook_loss"].mean(), books[0],
                                  allow_unused=True)
        total = 0.0 if gc is None else float(gc.abs().sum())
        assert (total > 0) == nonzero, training


def test_snake_parity():
    x = np.linspace(-3, 3, 50, dtype=np.float32)
    for alpha in (1.0, 0.5):
        _close(tdac.snake(torch.from_numpy(x), alpha),
               jdac.snake(jnp.asarray(x), alpha))


def test_generator_draws_and_init():
    """Dropout drawn from a `torch.Generator`: the draws are
    `torch.randint(1, N + 1, (B,))` from it, so a seeded generator gives
    the forward of those draws passed explicitly; only the first
    floor(B·dropout) items drop stages. Without a
    generator or draws, dropout raises. `init_dac_rvq` is seeded: the same
    generator seed gives the same parameters, in the port's layout."""
    cfg = tdac.DacRVQConfig(input_dim=8, n_codebooks=4, codebook_size=16,
                            codebook_dim=4, quantizer_dropout=0.5)
    params = tdac.init_dac_rvq(torch.Generator().manual_seed(0), cfg)
    again = tdac.init_dac_rvq(torch.Generator().manual_seed(0), cfg)
    for a, b in zip(params["stages"], again["stages"]):
        assert torch.equal(a["codebook"], b["codebook"])
        assert torch.equal(a["in_proj"]["v"], b["in_proj"]["v"])
    s0 = params["stages"][0]
    assert s0["in_proj"]["v"].shape == (4, 8)
    assert s0["out_proj"]["v"].shape == (8, 4)
    torch.testing.assert_close(s0["in_proj"]["g"],
                               s0["in_proj"]["v"].norm(dim=1))
    x = torch.from_numpy(_x(4, (8, 5, 8)))
    got = tdac.dac_rvq_forward(params, x, cfg, training=True,
                               generator=torch.Generator().manual_seed(7))
    draws = torch.randint(1, 5, (8,), generator=torch.Generator(
    ).manual_seed(7))
    want = tdac.dac_rvq_forward(params, x, cfg, training=True, draws=draws)
    assert torch.equal(got["z"], want["z"])
    full = tdac.dac_rvq_forward(params, x, cfg, training=True,
                                draws=torch.full((8,), 5))
    kept = [int(d) >= 5 for d in draws[:4]] + [True] * 4
    for b in range(8):
        assert torch.equal(got["z"][b], full["z"][b]) or not kept[b]
    assert not all(kept)
    try:
        tdac.dac_rvq_forward(params, x, cfg, training=True)
    except ValueError as e:
        assert "generator" in str(e)
    else:
        raise AssertionError("dropout without draws did not raise")
