"""Training the breathing tokenizer: the port against the JAX package on
the CPU.

The tiny model is `tests/test_train.py`'s (ratios [5, 2, 1], 4 filters,
dimension 16, 32 bins, one shared book) at 8 stages (0.08 kbps, as
`params/default.yaml` has 8), B=2; weights from the JAX package's init
(`kmeans_init=False`) carried across with `params_from_jax`, inputs seeded
numpy arrays. JAX's and torch's random streams differ, so:
- the step tests start with every cluster size at 50, above
  `threshold_ema_dead_code`: no code expires and no draw is used;
- the k-means and expiry tests feed JAX's draws
  (`jax.random.permutation`) to the port.

Tolerances: the RVQ, STFT and losses to rtol 1e-5 (codes equal); one Adam
step against optax to 1e-6 absolute; `gen_step`: loss and metrics to 1e-5
relative, `freq_acc` within one frame per item (an argmax: a near-tie may
move it); every gradient leaf within 1e-4 of its own largest |value| plus
1e-4 of the whole gradient's (2e-4 for Adam's second moments, squares);
params within 2e-5 where JAX's gradient is above that noise (there Adam's
first step is -lr·sign(g)), else within 2·lr (a sign inside the noise may
differ); the codebook state within 1e-4; three steps in a row: losses to
1e-4 relative and the codebooks within 1e-3 (the sign choices above
compound). The gradient bound is not 1e-4 of each leaf alone: measured
against a float64 evaluation of the same step, JAX's own float32
gradients are off by 2e-4 to 1.7e-3 of a leaf's largest |value| (four
batch seeds): the tiny 4-channel layer-norm trunk with random weights
amplifies rounding, in every loss term alike, and most in leaves whose
gradient is a small sum of large cancelling terms. A wrong term moves a
leaf by far more than 1e-4 of the largest gradient.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp
import optax

from encodec_tpu.losses.gan import disc_loss as jax_disc_loss
from encodec_tpu.losses.gan import total_loss as jax_total_loss
from encodec_tpu.losses.spectrogram import (
    reconstruction_loss as jax_reconstruction_loss)
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.model import forward_train as jax_forward_train
from encodec_tpu.ops.stft import stft as jax_stft
from encodec_tpu.quant import rvq as jrvq
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import load_checkpoint as jax_load_checkpoint
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu.train import save_checkpoint as jax_save_checkpoint
from encodec_tpu.train.steps import _make_optimizer
from encodec_tpu.train.trainer import model_from_config as jax_model_from_config
from encodec_tpu_torch.losses import disc_loss, reconstruction_loss, total_loss
from encodec_tpu_torch.models import build_model, params_from_jax
from encodec_tpu_torch.models.zoo import _find_adam
from encodec_tpu_torch.ops import stft
from encodec_tpu_torch.quant import rvq
from encodec_tpu_torch.train import (ConfigNamespace, LossWeights, Trainer,
                                     adam_update, create_train_state,
                                     init_adam, load_checkpoint,
                                     make_train_steps, save_checkpoint)
from encodec_tpu_torch.train import __main__ as train_entry
from encodec_tpu_torch.train.__main__ import main as train_main
from encodec_tpu_torch.train.optim import tree_leaves
from encodec_tpu_torch.train.trainer import state_to_device

TINY = dict(sample_rate=10, channels=1, causal=True, model_norm="layer_norm",
            name="breathing_model", ratios=[5, 2, 1], bins=32, dimension=16,
            n_filters=4, decoder_final_norm="none", shared_codebook=True,
            kmeans_init=False)
FL = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
FL_FULL = dict(dict(alpha=0.01, bandwidth=None, sampling_rate=10, n_fft=512),
               **FL)
WEIGHTS = dict(lr=1e-3, freq=0.25, l2=0.01, commit=0.25, codebook=1.0)
# the tiny experiment of tests/test_torch_breathing.py, with a dataset
CONFIG = {
    "common": {"log_interval": 1, "max_epoch": 3, "seed": 0,
               "gradient_clipping": True},
    "checkpoint": {"save_every": 1},
    "optimization": {"lr": 1e-3, "disc_lr": 1e-3},
    "loss": {"weight_l1": 1.0, "weight_l2": 0.01, "weight_commit": 0.25,
             "weight_freq": 0.25, "weight_g": 0.0, "weight_feat": 0.0,
             "alpha": 0.01, "bandwidth": None, "n_fft": 64, "win_length": 64,
             "hop_length": 16, "commit_start_epoch": 0},
    "lr_scheduler": {"warmup_epoch": 1},
    "model": {"ratios": [5, 2, 1], "bins": 32, "dimension": 16,
              "target_bandwidths": [0.08], "train_discriminator": False,
              "train_discriminator_start_epoch": 9,
              "train_discriminator_prob": 0.0, "disc_hop_lengths": [16],
              "disc_win_lengths": [64], "disc_n_ffts": [64],
              "filters": 4, "audio_normalize": False, "causal": True,
              "norm": "layer_norm", "segment": "None",
              "name": "my_encodec", "sample_rate": 10, "channels": 1},
    "dataset": {"root": None, "batch_size": 2, "num_workers": 0,
                "max_length": 600, "debug": False, "cv": 0,
                "datasets": {"synth": 1.0}, "thorax": 1.0,
                "abdominal": 0.0},
    "distributed": {"data_parallel": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=0, B=2, T=600):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 10.0
    sig = np.sin(2 * np.pi * 0.3 * t)[None, :, None] + 0.05 * rng.randn(B, T, 1)
    return sig.astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _close_tree(got, want, rel):
    """Each leaf within `rel` of the largest |value| of JAX's leaf."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys() and g
    for k in g:
        a = np.asarray(g[k].detach() if isinstance(g[k], torch.Tensor)
                       else g[k])
        b = np.asarray(w[k])
        assert a.shape == b.shape, k
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert err <= rel, (k, err)


def _close_grads(got, want, rel=1e-4):
    """Each leaf within `rel` of its own largest |value| (JAX's) plus `rel`
    of the largest |value| over all leaves."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys() and g
    top = max(float(np.abs(np.asarray(v)).max()) for v in w.values())
    for k in g:
        a, b = np.asarray(g[k].detach()), np.asarray(w[k])
        err = float(np.abs(a - b).max())
        assert err <= rel * (float(np.abs(b).max()) + top), (k, err)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The tiny model in both packages, with equal weights and every
    cluster size at 50 (nothing expires), and fresh train states."""
    jm = jax_build_model([0.08], seed=3, **TINY)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    jstate, _, _ = jax_create_train_state(jm, seed=0)
    tstate = create_train_state(tm, seed=0)
    jsteps = jax_make_train_steps(jm.cfg, freq_loss_kwargs=FL)
    tsteps = make_train_steps(tm.cfg, freq_loss_kwargs=FL)
    return dict(jm=jm, tm=tm, jstate=jstate, tstate=tstate, jgen=jsteps[0],
                jeval=jsteps[2], tgen=tsteps[0], teval=tsteps[2],
                tmp=tmp_path_factory.mktemp("pair"))


def _port_tree(tree, pair):
    """A JAX parameter-shaped tree in the port's layout."""
    return params_from_jax(_np(tree), tuple(_np(pair["jm"].qstate)),
                           pair["tm"].cfg)[0]


def _jax_grads(pair, x):
    jm, js = pair["jm"], pair["jstate"]
    w = JaxLossWeights.make(**WEIGHTS)
    _, step_rng = jax.random.split(js.rng)

    def loss_fn(params):
        x_hat, _, commit, _ = jax_forward_train(
            params, js.qstate, x, jm.cfg, jm.cfg.rvq.n_q, step_rng,
            training=True)
        freq = jax_reconstruction_loss(x[..., 0], x_hat[..., 0], **FL_FULL)
        lg = jax_total_loss(None, None, None, x, x_hat)
        cm = jnp.mean(commit)
        return (lg["l_1"] * w.l1 + freq["total_loss"] * w.freq
                + lg["l_2"] * w.l2 + cm * w.commit + cm * w.codebook)

    return jax.grad(loss_fn)(js.params)


# -- the RVQ's training half ----------------------------------------------

def _rvq_cfgs(shared):
    kw = dict(dimension=16, n_q=4, bins=32, kmeans_init=False,
              kmeans_iters=10, shared_codebook=shared)
    return jrvq.RVQConfig(**kw), rvq.RVQConfig(**kw)


def _books(seed, n, bins=32, dim=16, cluster=50.0):
    rng = np.random.RandomState(seed)
    e = rng.uniform(-0.5, 0.5, (n, bins, dim)).astype(np.float32)
    cs = np.full((n, bins), cluster, np.float32)
    return e, (e * 3.0).astype(np.float32), cs


@pytest.mark.parametrize("cluster", [50.0, 0.5])
def test_stage_train_matches_jax(cluster):
    """One stage: the EMA update and, with small clusters, the expiry of
    every code, fed JAX's replacement draw."""
    jcfg, tcfg = _rvq_cfgs(True)
    e, ea, cs = _books(1, 1, cluster=cluster)
    x = np.random.RandomState(2).randn(120, 16).astype(np.float32) * 0.4
    key = jax.random.PRNGKey(7)
    q, idx, commit, (e2, ea2, cs2) = jrvq._stage_train(
        jcfg, jnp.asarray(x), e[0], ea[0], cs[0], key)
    draw = torch.from_numpy(np.array(jax.random.permutation(key, 120)[:32]))
    tq, tidx, tcommit, (te2, tea2, tcs2) = rvq._stage_train(
        tcfg, torch.from_numpy(x), *(torch.from_numpy(a[0]) for a in
                                     (e, ea, cs)), sample_idx=draw)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    for got, want in ((tq, q), (tcommit, commit), (te2, e2), (tea2, ea2),
                      (tcs2, cs2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    if cluster < 2.0:
        assert bool((np.asarray(cs2) < 2.0).all())   # every code expired


def test_kmeans_matches_jax_given_its_draws():
    x = np.random.RandomState(3).randn(200, 16).astype(np.float32)
    key = jax.random.PRNGKey(4)
    means, counts = jrvq._kmeans(key, jnp.asarray(x), 32, 10)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 200)))
    tmeans, tcounts = rvq._kmeans(torch.from_numpy(x), 32, 10,
                                  init_idx=perm[:32])
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    np.testing.assert_allclose(tmeans.numpy(), np.asarray(means), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shared,n_q,kmeans", [(True, 4, False),
                                               (False, 2, False),
                                               (True, 4, True)])
def test_rvq_forward_matches_jax(shared, n_q, kmeans):
    """The whole training RVQ: straight-through quantized latents, codes,
    commit losses and the new state; books past n_q keep their state; with
    `kmeans`, the lazy k-means init on the first batch's residuals, and
    expiry, both fed JAX's draws."""
    jcfg, tcfg = _rvq_cfgs(shared)
    if kmeans:
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "kmeans_init": True})
        tcfg = tcfg.__class__(**{**tcfg.__dict__, "kmeans_init": True})
    n = jcfg.num_books
    e, ea, cs = _books(5, n)
    if kmeans:
        e = ea = np.zeros_like(e)
        cs = np.zeros_like(cs)
    x = np.random.RandomState(6).randn(2, 60, 16).astype(np.float32) * 0.5
    rng = jax.random.PRNGKey(8)
    jstate = jrvq.RVQState(jnp.asarray(e), jnp.asarray(ea), jnp.asarray(cs),
                           jnp.asarray(not kmeans))
    q, codes, commit, new = jrvq.rvq_forward(jstate, jnp.asarray(x), jcfg,
                                             n_q=n_q, training=True, rng=rng)
    # JAX's draws: k-means seeds per book, then expiry replacements per stage
    init_key, rng2 = jax.random.split(rng)
    init_idx = [torch.from_numpy(np.array(
        jax.random.permutation(k, 120)[:32]))
        for k in jax.random.split(init_key, n)]
    sample_idx = [torch.from_numpy(np.array(
        jax.random.permutation(k, 120)[:32]))
        for k in jax.random.split(rng2, n_q)]
    tstate = rvq.RVQState(*(torch.from_numpy(a) for a in (e, ea, cs)),
                          inited=not kmeans)
    tq, tcodes, tcommit, tnew = rvq.rvq_forward(
        tstate, torch.from_numpy(x), tcfg, n_q=n_q, init_idx=init_idx,
        sample_idx=sample_idx)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tcommit.numpy(), np.asarray(commit), rtol=1e-5)
    for got, want in zip(tnew[:3], new[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert tnew.inited and bool(new.inited)
    if not shared:   # books past n_q keep their state
        for got, want in zip(tnew[:3], (e, ea, cs)):
            np.testing.assert_array_equal(got[n_q:].numpy(), want[n_q:])


def test_rvq_forward_straight_through_gradient():
    """The gradient passes the quantizer unchanged, plus the commit
    loss's pull toward the code."""
    _, tcfg = _rvq_cfgs(True)
    e, ea, cs = _books(9, 1)
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 8, 16)
                         .astype(np.float32)).requires_grad_(True)
    state = rvq.RVQState(*(torch.from_numpy(a) for a in (e, ea, cs)),
                         inited=True)
    q, _, commit, _ = rvq.rvq_forward(state, x, tcfg, n_q=1)
    g, = torch.autograd.grad(q.sum(), x)
    assert torch.equal(g, torch.ones_like(x))
    g, = torch.autograd.grad(commit.sum(), x)
    q, *_ = rvq.rvq_forward(state, x, tcfg, n_q=1)
    torch.testing.assert_close(g, 2 * (x - q).detach() / x.numel())


# -- STFT and losses --------------------------------------------------------

def test_stft_matches_jax():
    x = np.random.RandomState(11).randn(2, 600).astype(np.float32)
    want = np.asarray(jax_stft(jnp.asarray(x), 64, 16, 48))
    got = stft(torch.from_numpy(x), 64, 16, 48).numpy()
    assert got.shape == want.shape == (2, 33, 34)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.real, want.real, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got.imag, want.imag, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("bandwidth", [None, 1.0])
def test_reconstruction_loss_matches_jax(bandwidth):
    x = _batch(12)[..., 0]
    x_hat = x + 0.1 * np.random.RandomState(13).randn(*x.shape).astype(
        np.float32)
    kw = dict(alpha=0.01, bandwidth=bandwidth, sampling_rate=10, n_fft=64,
              win_length=64, hop_length=16)
    want = jax_reconstruction_loss(jnp.asarray(x), jnp.asarray(x_hat), **kw)
    got = reconstruction_loss(torch.from_numpy(x), torch.from_numpy(x_hat),
                              **kw)
    for k in ("total_loss", "l1_loss", "l2_loss"):
        assert _rel(got[k], want[k]) <= 1e-5, k
    frames = want["S_x"].shape[-1]
    assert abs(float(got["acc"]) - float(want["acc"])) <= 1.0 / frames
    np.testing.assert_allclose(got["S_x"].numpy(), np.asarray(want["S_x"]),
                               rtol=1e-5, atol=1e-5)


def test_total_and_disc_loss_match_jax():
    rng = np.random.RandomState(14)
    x, y = (rng.randn(2, 50, 1).astype(np.float32) for _ in range(2))
    fr = [[rng.randn(2, 3, 7).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    ff = [[rng.randn(2, 3, 7).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    lf = [rng.randn(2, 1, 7).astype(np.float32) for _ in range(2)]
    lr = [rng.randn(2, 1, 7).astype(np.float32) for _ in range(2)]
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    for fmaps in (False, True):
        args = (fr, lf, ff) if fmaps else (None, None, None)
        want = jax_total_loss(*args, x, y)
        got = total_loss(*(t(a) if a is not None else None for a in args),
                         torch.from_numpy(x), torch.from_numpy(y))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5)
    assert _rel(disc_loss(t(lr), t(lf)), jax_disc_loss(lr, lf)) <= 1e-5


# -- the optimizer ----------------------------------------------------------

def test_adam_with_clip_matches_optax():
    """Three steps of `adam_update` against JAX's optimizer (optax's
    inject_hyperparams(chain(clip_by_global_norm(0.1), adam(lr, 0.8,
    0.9)))): the first two with the clip firing (global norm > 0.1), the
    third below it."""
    rng = np.random.RandomState(15)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]}
    opt = _make_optimizer(0.1)
    jstate = opt.init(params)
    jparams = params
    tparams = jax.tree.map(torch.from_numpy, params)
    tstate = init_adam(tparams)
    for step, scale in enumerate((1.0, 0.3, 0.001)):
        grads = jax.tree.map(lambda p: (rng.randn(*p.shape) * scale)
                             .astype(np.float32), params)
        norm = float(optax.global_norm(grads))
        assert (norm > 0.1) == (step < 2)
        jstate.hyperparams["learning_rate"] = jnp.asarray(2e-3, jnp.float32)
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate, tnorm = adam_update(
            jax.tree.map(torch.from_numpy, grads), tstate, tparams, 2e-3)
        assert abs(float(tnorm) - norm) <= 1e-6 * norm
        adam = _find_adam(jstate)
        assert int(tstate.count) == int(adam.count) == step + 1
        for got, want in ((tparams, jparams), (tstate.mu, adam.mu),
                          (tstate.nu, adam.nu)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=1e-6)


# -- the steps --------------------------------------------------------------

def test_gen_step_matches_jax(pair):
    x = _batch(0)
    js, jm_ = pair["jgen"](pair["jstate"], jnp.asarray(x),
                           JaxLossWeights.make(**WEIGHTS), use_gan=False)
    ts, tm_ = pair["tgen"](pair["tstate"], torch.from_numpy(x),
                           LossWeights.make(**WEIGHTS), keep_grads=True)
    for k in ("loss", "loss_l1", "loss_l2", "loss_freq", "loss_freq_l1",
              "loss_freq_l2", "loss_commit", "grad_norm"):
        assert _rel(tm_[k], jm_[k]) <= 1e-5, k
    frames = 600 // 16 - 2   # the loss spectrogram's frames per item
    assert abs(float(tm_["freq_acc"]) - float(jm_["freq_acc"])) <= 1 / frames
    # every gradient leaf, the encoder's convs before the LSTM included
    jgrads = _port_tree(_jax_grads(pair, jnp.asarray(x)), pair)
    _close_grads(tm_["grads"], jgrads)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tm_["grads"]))
    # the state after the step: params, Adam moments, codebooks, the count
    got, want = dict(_leaves(ts.params)), dict(
        _leaves(_port_tree(js.params, pair)))
    grads = {k: np.abs(v.numpy()) for k, v in _leaves(jgrads)}
    top = max(float(g.max()) for g in grads.values())
    for k in got:
        g = grads[k]
        noise = 1e-4 * (float(g.max()) + top)
        err = np.abs(got[k].numpy() - want[k].numpy())
        assert float(err[g > noise].max(initial=0)) <= 2e-5, k
        assert float(err.max()) <= 2 * WEIGHTS["lr"], k
    adam = _find_adam(js.opt_state)
    assert int(ts.opt_state.count) == int(adam.count) == 1
    _close_grads(ts.opt_state.mu, _port_tree(adam.mu, pair))
    _close_grads(ts.opt_state.nu, _port_tree(adam.nu, pair), 2e-4)
    for got, want in zip(ts.qstate[:3], js.qstate[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    # the input state is not modified
    assert int(pair["tstate"].opt_state.count) == 0


def test_three_gen_steps_in_a_row_match_jax(pair):
    js, ts = pair["jstate"], pair["tstate"]
    jw, tw = JaxLossWeights.make(**WEIGHTS), LossWeights.make(**WEIGHTS)
    for i in range(3):
        x = _batch(20 + i)
        js, jm_ = pair["jgen"](js, jnp.asarray(x), jw, use_gan=False)
        ts, tm_ = pair["tgen"](ts, torch.from_numpy(x), tw)
        assert _rel(tm_["loss"], jm_["loss"]) <= 1e-4, i
    _close_tree(ts.qstate[:3], _np(tuple(js.qstate[:3])), 1e-3)


def test_eval_step_matches_jax(pair):
    x = _batch(30)
    jmx, jcodes, jx_hat = pair["jeval"](pair["jstate"], jnp.asarray(x),
                                        JaxLossWeights.make(**WEIGHTS))
    tmx, tcodes, tx_hat = pair["teval"](pair["tstate"], torch.from_numpy(x),
                                        LossWeights.make(**WEIGHTS))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert tcodes.shape == (2, 8, 60)
    for k in ("loss", "loss_l1", "loss_l2", "loss_freq"):
        assert _rel(tmx[k], jmx[k]) <= 1e-5, k
    np.testing.assert_allclose(tmx["l_t"].numpy(), np.asarray(jmx["l_t"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tx_hat.numpy(), np.asarray(jx_hat), rtol=1e-4,
                               atol=5e-5)


def test_remat_recomputes_the_same_step(pair):
    """`remat` (recompute each SEANet stage in the backward, less memory)
    gives the step of the plain graph, bit for bit; `model.remat: true` in
    a config turns it on."""
    cfg = pair["tm"].cfg
    cfg_r = dataclasses.replace(cfg, seanet=dataclasses.replace(
        cfg.seanet, remat=True))
    gen_r = make_train_steps(cfg_r, freq_loss_kwargs=FL)[0]
    x, w = torch.from_numpy(_batch(32)), LossWeights.make(**WEIGHTS)
    _, m = pair["tgen"](pair["tstate"], x, w, keep_grads=True)
    _, mr = gen_r(pair["tstate"], x, w, keep_grads=True)
    assert torch.equal(m["loss"], mr["loss"])
    for g, gr in zip(tree_leaves(m["grads"]), tree_leaves(mr["grads"])):
        assert torch.equal(g, gr)
    conf = _config("unused")
    conf["model"]["remat"] = True
    trainer = Trainer(ConfigNamespace(conf), [], [], str(pair["tmp"] / "r"),
                      device="cpu")
    assert trainer.model.cfg.seanet.remat


def test_model_forward_matches_jax(pair):
    x = _batch(31).transpose(0, 2, 1)       # [B, C, T]
    jout, jcodes, jcommit, _ = pair["jm"].forward(jnp.asarray(x))
    tout, tcodes, tcommit, _ = pair["tm"](torch.from_numpy(x))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=5e-5)
    assert tuple(tcommit.shape) == (8,) and not bool(tcommit.any())


# -- checkpoints and the trainer --------------------------------------------

def _nights(root, n=4, length=900):
    chan = root / "synth" / "thorax"
    chan.mkdir(parents=True)
    for i in range(n):
        t = np.arange(length) / 10.0
        sig = (np.sin(2 * np.pi * (0.25 + 0.02 * i) * t)
               + 0.1 * np.random.RandomState(40 + i).randn(length))
        np.savez(chan / f"night{i}.npz", data=sig.astype(np.float32), fs=10)


def _config(root):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["dataset"]["root"] = str(root)
    return cfg


def _assert_states_equal(a, b):
    for (ka, x), (kb, y) in zip(_leaves(a.params), _leaves(b.params)):
        assert ka == kb and torch.equal(x, y), ka
    for x, y in zip(a.qstate[:3], b.qstate[:3]):
        assert torch.equal(x, y)
    assert a.qstate.inited == b.qstate.inited
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for x, y in zip(tree_leaves((a.opt_state.mu, a.opt_state.nu)),
                    tree_leaves((b.opt_state.mu, b.opt_state.nu))):
        assert torch.equal(x, y)
    assert torch.equal(a.rng, b.rng)


def test_train_main_fits_saves_and_resumes_bit_for_bit(tmp_path, monkeypatch):
    """`python -m encodec_tpu_torch.train` on a JSON config: two epochs of
    two steps with k-means init, eval and save; a fresh Trainer resumes the
    saved state bit for bit and trains on; `--resume_from` continues. The
    loaders' virtual epochs are cut to 4 training items and 1 for eval."""
    build = train_entry.build_dataloaders

    def cut(config):
        train, val, mapping = build(config)
        train.dataset.size, val.dataset.size = 4, 1
        return train, val, mapping

    monkeypatch.setattr(train_entry, "build_dataloaders", cut)
    _nights(tmp_path / "data")
    cfg = _config(tmp_path / "data")
    cfg["model"]["target_bandwidths"] = [0.08]
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    run = tmp_path / "run"
    trainer = train_main(["--config", str(tmp_path / "c.json"), "--log_dir",
                          str(run), "--max_epochs", "2", "--device", "cpu"])
    assert trainer.state.qstate.inited          # k-means ran on batch one
    assert int(trainer.state.opt_state.count) == 4
    assert (run / "model.ckpt").exists() and (run / "model.ckpt.prev").exists()
    assert (run / "config.json").exists()
    fresh = Trainer(ConfigNamespace(cfg), [], [], str(run), device="cpu")
    fresh.resume()
    assert fresh.start_epoch == 3
    _assert_states_equal(fresh.state, trainer.state)
    x = torch.from_numpy(_batch(50))
    state, m = fresh.gen_step(fresh.state, x, fresh.weights_for_epoch(3))
    assert np.isfinite(float(m["loss"])) and int(state.opt_state.count) == 5
    again = train_main(["--config", str(tmp_path / "c.json"),
                        "--resume_from", str(run), "--device", "cpu"])
    assert again.start_epoch == 3 and int(again.state.opt_state.count) == 6


def test_checkpoint_save_load_bit_for_bit_and_jax_opens_it(pair, tmp_path):
    ts, _ = pair["tgen"](pair["tstate"], torch.from_numpy(_batch(60)),
                         LossWeights.make(**WEIGHTS))
    path = tmp_path / "model.ckpt"
    save_checkpoint(ts, 7, path, extra={"param_layout": "torch"})
    raw, epoch, extra = load_checkpoint(path)
    assert epoch == 7 and extra == {"param_layout": "torch"}
    _assert_states_equal(state_to_device(raw, torch.device("cpu")), ts)
    # the JAX package's reader opens it (no target): its own RVQState class
    jraw, jepoch, _ = jax_load_checkpoint(path)
    assert jepoch == 7 and type(jraw.qstate) is jrvq.RVQState
    assert jraw._fields[:3] == ("params", "qstate", "opt_state")
    np.testing.assert_array_equal(
        jraw.params["encoder"]["lstm"]["layers"][0]["w_hh"],
        ts.params["encoder"]["lstm"]["layers"][0]["w_hh"].numpy())
    np.testing.assert_array_equal(jraw.opt_state.nu["decoder"]["init_conv"]
                                  ["w"], ts.opt_state.nu["decoder"]
                                  ["init_conv"]["w"].numpy())


def test_trainer_resumes_a_jax_written_checkpoint(tmp_path):
    cfg = _config(tmp_path)
    jm = jax_model_from_config(ConfigNamespace(cfg))
    jstate, _, _ = jax_create_train_state(jm, seed=0)
    jgen = jax_make_train_steps(jm.cfg, freq_loss_kwargs=FL)[0]
    js, _ = jgen(jstate, jnp.asarray(_batch(70)),
                 JaxLossWeights.make(**WEIGHTS), use_gan=False)
    path = tmp_path / "model.ckpt"
    jax_save_checkpoint(js, 5, path, extra={"config": cfg})
    trainer = Trainer(ConfigNamespace(cfg), [], [], str(tmp_path / "run"),
                      device="cpu")
    trainer.resume(str(path))
    assert trainer.start_epoch == 6
    st = trainer.state
    jq = tuple(_np(js.qstate))
    want = params_from_jax(_np(js.params), jq, trainer.model.cfg)[0]
    for (k, a), (_, b) in zip(_leaves(st.params), _leaves(want)):
        assert torch.equal(a, b), k
    adam = _find_adam(js.opt_state)
    assert int(st.opt_state.count) == 1
    for got, tree in ((st.opt_state.mu, adam.mu), (st.opt_state.nu, adam.nu)):
        for (k, a), (_, b) in zip(_leaves(got), _leaves(
                params_from_jax(_np(tree), jq, trainer.model.cfg)[0])):
            assert torch.equal(a, b), k
    assert st.qstate.inited and np.array_equal(st.qstate.embed.numpy(),
                                               np.asarray(js.qstate.embed))
    # the model follows the state, and a step runs from it
    assert torch.equal(trainer.model.params["decoder"]["init_conv"]["w"],
                       st.params["decoder"]["init_conv"]["w"])
    state, m = trainer.gen_step(st, torch.from_numpy(_batch(71)),
                                trainer.weights_for_epoch(6))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("gan", [False, True], ids=["gen", "gan"])
def test_trainer_takes_a_bf16_step(gan, tmp_path):
    """`common.compute_dtype: bfloat16` (refused before the mixed-precision
    slice) builds a Trainer whose steps compute the conv trunks in bf16:
    one generator step from a fresh state (the k-means init) is finite
    and, with the discriminator, so are a GAN generator step and a
    discriminator step; the masters, the Adam moments and the losses stay
    float32. Asynchronous saves: `tests/test_torch_parallel_train.py`; the
    data×seq step: `tests/test_torch_seq_parallel.py`."""
    cfg = _config(tmp_path)
    cfg["common"]["compute_dtype"] = "bfloat16"
    cfg["model"]["train_discriminator"] = gan
    tr = Trainer(ConfigNamespace(cfg), [], [], str(tmp_path / "r"),
                 device="cpu")
    assert tr.compute_dtype is torch.bfloat16
    x = torch.from_numpy(_batch(72))
    state, m = tr.gen_step(tr.state, x, tr.weights_for_epoch(1))
    metrics = [m]
    if gan:
        state, m = tr.gen_step(state, x, tr.weights_for_epoch(1),
                               use_gan=True)
        state, dm = tr.disc_step(state, x, tr.weights_for_epoch(1))
        metrics += [m, dm]
        assert np.isfinite(float(m["loss_gen"]))
        assert np.isfinite(float(dm["loss_disc"]))
        for k, leaf in _leaves((state.disc_params, state.disc_opt_state.mu,
                                state.disc_opt_state.nu)):
            assert leaf.dtype == torch.float32, k
    assert np.isfinite(float(metrics[0]["loss"]))
    assert all(v.dtype == torch.float32 for mt in metrics
               for v in mt.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())
    for k, leaf in _leaves((state.params, state.opt_state.mu,
                            state.opt_state.nu)):
        assert leaf.dtype == torch.float32, k
    assert state.qstate.embed.dtype == torch.float32


def test_seq_parallel_must_divide_the_world(tmp_path):
    """`distributed.seq_parallel: 2` in a single process: the entry point
    refuses a world the seq axis does not divide (JAX's `__main__.py`
    asserts `devices % seq_parallel == 0`) before it builds anything."""
    cfg = _config(tmp_path)
    cfg["distributed"] = {"data_parallel": True, "seq_parallel": 2}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        train_main(["--config", str(tmp_path / "c.json"), "--log_dir",
                    str(tmp_path / "r"), "--device", "cpu"])
    assert not (tmp_path / "r").exists()


def test_gan_config_and_balancer_build(tmp_path, pair):
    """The discriminator and the balancer, refused before the GAN slice,
    now build: a train state with both, the four steps, a Trainer."""
    from encodec_tpu_torch.losses import Balancer
    from encodec_tpu_torch.models import MSSTFTConfig

    tm, disc = pair["tm"], MSSTFTConfig(filters=2, n_ffts=(64,),
                                        hop_lengths=(16,), win_lengths=(64,))
    bal = Balancer(weights={"l_t": 1.0, "l_f": 1.0})
    state = create_train_state(tm, disc_cfg=disc, balancer=bal)
    assert len(state.disc_params["discs"]) == 1
    assert int(state.disc_opt_state.count) == 0
    assert sorted(state.balancer_state["fix"]) == ["l_f", "l_t"]
    steps = make_train_steps(tm.cfg, disc, balancer=bal)
    assert len(steps) == 4 and all(callable(f) for f in steps)
    cfg = _config(tmp_path)
    cfg["model"]["train_discriminator"] = True
    cfg["balancer"] = {"weights": {"l_t": 1.0, "l_f": 1.0}}
    trainer = Trainer(ConfigNamespace(cfg), [], [], str(tmp_path / "r"),
                      device="cpu")
    assert trainer.disc_cfg.n_ffts == (64,) and trainer.balancer is not None
