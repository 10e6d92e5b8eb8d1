"""The float LM network of the port against the JAX package's, on the CPU.

The LMs are small (dim 16 or 32, 2 heads, 2 layers, card 32-64, windows of
8-20 steps), drawn by the JAX package's `init_lm` and carried across with
`zoo.lm_params_from_jax`; the indices come from a numpy seed. Tolerance:
both sides compute in float32 with their own summation orders, so
probabilities agree within 1e-5 absolute and logits within 1e-4 (relative
and absolute), the tolerances of the JAX package's own parity tests
against the reference (`tests/test_lm.py`). Within the port, a step's row
equals the batch path's within the same 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.models import lm as jlm
from encodec_tpu_torch.models import lm as tlm
from encodec_tpu_torch.models.zoo import lm_params_from_jax

PROB_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed=0, **kw):
    cfg = dict(n_q=4, card=32, dim=16, num_heads=2, num_layers=2,
               past_context=8)
    cfg.update(kw)
    jcfg, tcfg = jlm.LMConfig(**cfg), tlm.LMConfig(**cfg)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp_ = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, jp, tcfg, tp_


def _indices(seed, B, K, T, card):
    return np.random.RandomState(seed).randint(0, card + 1, (B, K, T))


def test_building_blocks_equal_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    p = {"scale": rng.randn(16).astype(np.float32),
         "bias": rng.randn(16).astype(np.float32)}
    want = np.asarray(jlm._layer_norm(jnp.asarray(x), p))
    got = tlm._layer_norm(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # near position 1000 one float32 ulp of the phase is 6.1e-5, so cos
    # and sin there agree to 1e-4; below 64 to 1e-5
    for start, atol in ((0.0, 1e-5), (1000.0, 1e-4)):
        pos = np.arange(64, dtype=np.float32) + start
        for dim in (16, 200):
            np.testing.assert_allclose(
                tlm.sin_embedding(torch.from_numpy(pos), dim).numpy(),
                np.asarray(jlm.sin_embedding(jnp.asarray(pos), dim)),
                rtol=0, atol=atol)


@pytest.mark.parametrize("K,offset", [(4, 0), (2, 0), (4, 37)],
                         ids=["all_books", "fewer_books", "offset"])
def test_forward_batch_equals_jax(K, offset):
    jcfg, jp, tcfg, tp_ = _pair(seed=1)
    idx = _indices(2, 2, K, 14, tcfg.card)
    for logits in (False, True):
        want = np.asarray(jlm.lm_forward_batch(
            jp, jnp.asarray(idx), jcfg, offset=offset, return_logits=logits))
        got = tlm.lm_forward_batch(tp_, torch.from_numpy(idx), tcfg,
                                   offset=offset, return_logits=logits)
        assert tuple(got.shape) == (2, tcfg.card, K, 14)
        np.testing.assert_allclose(got.numpy(), want,
                                   **(LOGIT_TOL if logits else PROB_TOL))


def test_step_rows_equal_forward_batch_past_the_wrap():
    """T = 20 steps through a window of 8: the zero entry leaves the
    window and the ring wraps; every step's row equals the batch path's
    and JAX's step, and the carried state equals JAX's."""
    jcfg, jp, tcfg, tp_ = _pair(seed=3)
    idx = _indices(4, 2, 4, 20, tcfg.card)
    batch = tlm.lm_forward_batch(tp_, torch.from_numpy(idx), tcfg)
    jstate = jlm.init_lm_stream(jcfg, batch=2)
    tstate = tlm.init_lm_stream(tcfg, batch=2, device="cpu")
    for t in range(20):
        jprob, jstate = jlm.lm_step(jp, jnp.asarray(idx[:, :, t]), jstate,
                                    jcfg)
        tprob, tstate = tlm.lm_step(tp_, torch.from_numpy(idx[:, :, t]),
                                    tstate, tcfg)
        np.testing.assert_allclose(tprob.numpy(), batch[..., t].numpy(),
                                   **PROB_TOL, err_msg=f"t={t}")
        np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob),
                                   **PROB_TOL, err_msg=f"t={t}")
    assert (tstate.length, tstate.offset) == (int(jstate.length),
                                              int(jstate.offset)) == (9, 20)
    np.testing.assert_allclose(tstate.cache.numpy(), np.asarray(jstate.cache),
                               rtol=1e-4, atol=1e-5)


def test_scan_chunks_carried_equal_one_scan():
    jcfg, jp, tcfg, tp_ = _pair(seed=5, card=64, dim=32, past_context=12)
    idx = torch.from_numpy(_indices(6, 1, 4, 23, tcfg.card))
    whole = tlm.lm_scan(tp_, idx, tcfg)
    state = tlm.init_lm_stream(tcfg, batch=1, device="cpu")
    first, state = tlm.lm_scan_chunk(tp_, idx[:, :, :9], state, tcfg)
    second, state = tlm.lm_scan_chunk(tp_, idx[:, :, 9:], state, tcfg)
    torch.testing.assert_close(torch.cat([first, second], dim=-1), whole,
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jlm.lm_scan(jp, jnp.asarray(idx.numpy()),
                                              jcfg)), **PROB_TOL)
    np.testing.assert_allclose(
        whole.numpy(), tlm.lm_forward_batch(tp_, idx, tcfg).numpy(),
        **PROB_TOL)


def test_model_call_and_entry_points_equal_jax():
    """`LMModel.__call__` threaded over three calls (the reference
    signature), `forward_batch`, `scan` and `step` against JAX's."""
    jcfg, jp, tcfg, tp_ = _pair(seed=7, past_context=6)
    jm = jlm.LMModel(jcfg, jp)
    tm = tlm.LMModel(tcfg, tp_, device="cpu")
    assert (tm.card, tm.n_q) == (jm.card, jm.n_q)
    idx = _indices(8, 1, 4, 15, tcfg.card)
    jstates = tstates = None
    joff = toff = 0
    for sl in (slice(0, 5), slice(5, 6), slice(6, 15)):
        jp_, jstates, joff = jm(jnp.asarray(idx[:, :, sl]), jstates, joff)
        tp2, tstates, toff = tm(idx[:, :, sl], tstates, toff)
        assert toff == joff
        np.testing.assert_allclose(tp2.numpy(), np.asarray(jp_), **PROB_TOL)
    np.testing.assert_allclose(tm.forward_batch(idx).numpy(),
                               np.asarray(jm.forward_batch(jnp.asarray(idx))),
                               **PROB_TOL)
    np.testing.assert_allclose(tm.scan(idx).numpy(),
                               np.asarray(jm.scan(jnp.asarray(idx))),
                               **PROB_TOL)
    prob, state = tm.step(idx[:, :, 0], tm.init_stream(1))
    jprob, _ = jm.step(jnp.asarray(idx[:, :, 0]), jm.init_stream(1))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **PROB_TOL)
    assert (state.length, state.offset) == (2, 1)


def test_model_entry_points_default_to_cuda(monkeypatch):
    _, _, tcfg, tp_ = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.LMModel(tcfg, tp_)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_stream(tcfg)
