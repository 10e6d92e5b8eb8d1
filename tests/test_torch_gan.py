"""The GAN phase of training: the port against the JAX package on the CPU.

The tiny model of `tests/test_torch_train.py` (ratios [5, 2, 1], 4
filters, dimension 16, 32 bins, 8 stages of one shared book, every
cluster size at 50 so no code expires and no draw is used) with the
discriminator of JAX's `tests/test_train.py` (`filters=2`, `n_ffts=(64,
32)`, `hop_lengths=(16, 8)`, `win_lengths=(64, 32)`), B=2, T=600; the
weights from the JAX package's init, carried across with `params_from_jax`
and `msstftd_params_from_jax`; inputs seeded numpy arrays.

Tolerances: the spectrogram and `conv2d` forward rtol/atol 1e-5 (the JAX
kernel tests' tolerance), their input and weight gradients rtol 1e-5 and
atol 1e-6 of the largest |value|; the discriminator's logits and feature
maps 1e-5; the chunked sums (chunk 7: a ragged tail at both resolutions)
1e-5 relative, against JAX's chunked sums and against the port's own
whole-signal forward. Steps as in `tests/test_torch_train.py`: losses and
metrics 1e-5 relative, every gradient leaf within 1e-4 of its own largest
|value| plus 1e-4 of the whole gradient's, parameters after Adam within
2e-5 where JAX's gradient is above that noise and within 2·lr elsewhere,
three alternating GAN and discriminator steps 2e-3 relative (below).

The GAN generator step's gradient is the exception, bounded at
`GAN_GRAD_REL` = 5e-3 instead of 1e-4. The feature-matching loss is an
L1 distance, so its gradient jumps where a feature of x̂ crosses the same
feature of x, and the tiny discriminator (2 filters) has many such
features within 1e-6 of each other (22 of 680 in one map, measured). A
float32 rounding of x̂ then flips signs: evaluated in float64 at the
float32 x̂ of one torch thread instead of the float64 x̂, the loss's
gradient with respect to x̂ moved by 0.5% of its largest |value|, and the
port's float32 step gradient lay 3.7e-5 (two threads) to 1.6e-3 (one
thread) from its float64 evaluation by the measure above, JAX's 1.4e-4
(three batch seeds and noise levels: 3e-5 to 1.6e-3 between the two
packages). The GAN terms' own gradient with respect to a given x̂ holds to
1e-5 (`test_gan_terms_and_their_gradient_match_jax`), their values to
1e-5, and the step's other terms are `tests/test_torch_train.py`'s; a
wrong term moves the gradient by tens of percent (the GAN terms are two
thirds of its norm). Adam's first steps are ±lr wherever the gradient's
sign differs, so those flips reach the parameters, and three alternating
GAN and discriminator steps in a row are held to 2e-3 relative
(`GAN_SEQ_REL`), not 1e-4 as without the GAN terms: the third step's loss
read 5.0e-4 from JAX's (measured).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.losses.gan import disc_loss as jax_disc_loss
from encodec_tpu.losses.gan import total_loss as jax_total_loss
from encodec_tpu.losses.spectrogram import (
    reconstruction_loss as jax_reconstruction_loss)
from encodec_tpu.models import msstftd as jmsstftd
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.model import forward_train as jax_forward_train
from encodec_tpu.ops import conv as jconv
from encodec_tpu.ops import conv2d as jconv2d
from encodec_tpu.ops.stft import spectrogram as jax_spectrogram
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import TrainState as JaxTrainState
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import load_checkpoint as jax_load_checkpoint
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu.train import save_checkpoint as jax_save_checkpoint
from encodec_tpu_torch.models import build_model, msstftd, params_from_jax
from encodec_tpu_torch.models import zoo
from encodec_tpu_torch.models.zoo import _find_adam, msstftd_params_from_jax
from encodec_tpu_torch.ops import conv as tconv
from encodec_tpu_torch.ops import conv2d as tconv2d
from encodec_tpu_torch.ops import spectrogram
from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                     load_checkpoint, make_train_steps,
                                     save_checkpoint)
from encodec_tpu_torch.train.optim import tree_leaves
from encodec_tpu_torch.train.steps import gan_terms
from encodec_tpu_torch.train.trainer import state_to_device
from tests.test_torch_train import (FL, FL_FULL, TINY, _batch, _close_grads,
                                    _leaves, _np, _rel)

WEIGHTS = dict(lr=1e-3, freq=0.25, l2=0.01, commit=0.25, codebook=1.0,
               disc_lr=1e-3)
DISC = dict(filters=2, n_ffts=(64, 32), hop_lengths=(16, 8),
            win_lengths=(64, 32))
ROUTES = ("chunked", "remat", "plain")
GAN_GRAD_REL = 5e-3
GAN_SEQ_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    """JAX NHWC → the port's NCHW, as numpy."""
    return np.asarray(a).transpose(0, 3, 1, 2)


def _disc_cfgs(route):
    chunk = 7 if route == "chunked" else None
    return (jmsstftd.MSSTFTConfig(**DISC, time_chunk=chunk),
            msstftd.MSSTFTConfig(**DISC, time_chunk=chunk))


@pytest.fixture(scope="module")
def gan():
    """The tiny model and discriminator in both packages, with equal
    weights, fresh train states and the steps of each route (built on
    first use)."""
    jm = jax_build_model([0.08], seed=3, **TINY)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    jcfg, tcfg = _disc_cfgs("plain")
    jstate, _, _ = jax_create_train_state(jm, jcfg, seed=0)
    tstate = create_train_state(tm, tcfg, seed=0)._replace(
        disc_params=msstftd_params_from_jax(_np(jstate.disc_params)))
    steps = {}

    def steps_for(route):
        if route not in steps:
            jc, tc = _disc_cfgs(route)
            remat = route == "remat"
            js = jax_make_train_steps(jm.cfg, jc, freq_loss_kwargs=FL,
                                      disc_remat=remat)
            ts = make_train_steps(tm.cfg, tc, freq_loss_kwargs=FL,
                                  disc_remat=remat)
            steps[route] = dict(jgen=js[0], jdisc=js[1], tgen=ts[0],
                                tdisc=ts[1])
        return steps[route]

    return dict(jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg, jstate=jstate,
                tstate=tstate, steps=steps_for)


def _port_tree(tree, gan):
    return params_from_jax(_np(tree), tuple(_np(gan["jm"].qstate)),
                           gan["tm"].cfg)[0]


def _port_disc(tree):
    return msstftd_params_from_jax(_np(tree))


def _close_after_adam(got_tree, want_tree, jgrads, lr, rel=1e-4):
    """Parameters after Adam's first step: within 2e-5 where JAX's
    gradient is above its noise (`rel` of the leaf's and the whole
    gradient's largest |value|; there the step is -lr·sign(g)), within 2·lr
    elsewhere (a sign inside the noise may differ)."""
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    grads = {k: np.abs(v.numpy()) for k, v in _leaves(jgrads)}
    assert got.keys() == want.keys() == grads.keys()
    top = max(float(g.max()) for g in grads.values())
    for k in got:
        g = grads[k]
        noise = rel * (float(g.max()) + top)
        err = np.abs(got[k].numpy() - want[k].numpy())
        assert float(err[g > noise].max(initial=0)) <= 2e-5, k
        assert float(err.max()) <= 2 * lr, k


def _jax_step_rng(js):
    return jax.random.split(js.rng)[1]


def _jax_gan_grads(gan, x):
    """JAX's gradient of the GAN generator loss (the whole-signal route:
    every route computes this function)."""
    jm, js, jcfg = gan["jm"], gan["jstate"], gan["jcfg"]
    w = JaxLossWeights.make(**WEIGHTS)
    rng = _jax_step_rng(js)

    def loss_fn(params):
        x_hat, _, commit, _ = jax_forward_train(
            params, js.qstate, x, jm.cfg, jm.cfg.rvq.n_q, rng, training=True)
        freq = jax_reconstruction_loss(x[..., 0], x_hat[..., 0], **FL_FULL)
        _, fmap_real = jmsstftd.msstftd_forward(js.disc_params, x, jcfg)
        logits_fake, fmap_fake = jmsstftd.msstftd_forward(js.disc_params,
                                                          x_hat, jcfg)
        lg = jax_total_loss(fmap_real, logits_fake, fmap_fake, x, x_hat)
        cm = jnp.mean(commit)
        return (lg["l_1"] * w.l1 + freq["total_loss"] * w.freq
                + lg["l_2"] * w.l2 + cm * w.commit + cm * w.codebook
                + lg["l_g"] * w.gen + lg["l_feat"] * w.feat)

    return jax.grad(loss_fn)(js.params)


def _jax_disc_grads(gan, x):
    jm, js, jcfg = gan["jm"], gan["jstate"], gan["jcfg"]
    x_hat = jax_forward_train(js.params, js.qstate, x, jm.cfg,
                              jm.cfg.rvq.n_q, _jax_step_rng(js),
                              training=True)[0]

    def loss_fn(dp):
        logits_real, _ = jmsstftd.msstftd_forward(dp, x, jcfg)
        logits_fake, _ = jmsstftd.msstftd_forward(dp, x_hat, jcfg)
        return jax_disc_loss(logits_real, logits_fake)

    return jax.grad(loss_fn)(js.disc_params)


# -- the ops -----------------------------------------------------------------

def test_spectrogram_matches_jax():
    x = np.random.RandomState(1).randn(2, 1, 600).astype(np.float32)
    want = np.asarray(jax_spectrogram(jnp.asarray(x), 64, 16, 48))
    got = spectrogram(torch.from_numpy(x), 64, 16, 48).numpy()
    assert got.shape == want.shape == (2, 1, 33, 34)
    for g, w in ((got.real, want.real), (got.imag, want.imag)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    mag = spectrogram(torch.from_numpy(x), 64, 16, 48, power=2.0).numpy()
    np.testing.assert_allclose(mag, np.abs(want) ** 2, rtol=1e-5, atol=1e-5)


def _conv2d_pair(norm, seed=4):
    p = _np(jconv2d.init_conv2d(jax.random.PRNGKey(seed), 3, 4, (3, 9),
                                norm=norm))
    p["b"] = p["b"] + 0.1          # a bias that matters
    return p, msstftd_params_from_jax({"discs": [{"convs": [p]}]})[
        "discs"][0]["convs"][0]


@pytest.mark.parametrize("impl", ["taps", "xla"])
@pytest.mark.parametrize("norm", ["none", "weight_norm", "spectral_norm"])
def test_conv2d_and_its_gradients_match_jax(norm, impl):
    """Forward with stride (1, 2), dilation (2, 1) and padding; dx and
    every weight leaf's gradient against `jax.vjp` of JAX's `impl`."""
    jp, tp_ = _conv2d_pair(norm)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, 33, 3).astype(np.float32)      # [B, t, w, C]
    kw = dict(stride=(1, 2), dilation=(2, 1), padding=(2, 4))
    y, vjp = jax.vjp(lambda xx, pp: jconv2d.conv2d(pp, xx, impl=impl, **kw),
                     jnp.asarray(x), jax.tree.map(jnp.asarray, jp))
    ct = rng.randn(*y.shape).astype(np.float32)
    jdx, jdp = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(_nchw(x).copy()).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(k not in ("u_sn", "v_sn"))
              for k, v in tp_.items()}
    ty = tconv2d.conv2d(leaves, tx, impl=impl, **kw)
    np.testing.assert_allclose(ty.detach().numpy(), _nchw(y), rtol=1e-5,
                               atol=1e-5)
    names = [k for k in leaves if leaves[k].requires_grad]
    grads = torch.autograd.grad(ty, [tx] + [leaves[k] for k in names],
                                torch.from_numpy(_nchw(ct).copy()))
    want = {"x": _nchw(jdx)}
    jdp_port = msstftd_params_from_jax({"discs": [{"convs": [_np(jdp)]}]})[
        "discs"][0]["convs"][0]
    want.update({k: jdp_port[k].numpy() for k in names})
    for k, g in zip(["x"] + names, grads):
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["conv1d", "conv_transpose1d", "conv2d"])
def test_spectral_norm_matches_jax(kind):
    """The power iteration (u, v), σ and the effective weight, for a 1-D
    conv (`[Cout, Cin, K]`), a transposed one (`[Cin, Cout, K]`: Cout is
    dim 1) and a 2-D conv."""
    key = jax.random.PRNGKey(6)
    if kind == "conv2d":
        jp, tp_ = _conv2d_pair("spectral_norm", 6)
        transposed = False
    else:
        transposed = kind == "conv_transpose1d"
        init = (jconv.init_sconv_transpose1d if transposed
                else jconv.init_sconv1d)
        jp = _np(init(key, 6, 4, 5, norm="spectral_norm"))
        axes = (1, 2, 0) if transposed else (2, 1, 0)
        tp_ = {"w_orig": _t(jp["w_orig"].transpose(axes)),
               "u_sn": _t(jp["u_sn"]), "v_sn": _t(jp["v_sn"]),
               "b": _t(jp["b"])}
    jn = jconv.spectral_norm_power_iterate(jax.tree.map(jnp.asarray, jp))
    tn = tconv.spectral_norm_power_iterate(tp_, transposed=transposed)
    for k in ("u_sn", "v_sn"):
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]),
                                   rtol=1e-5, atol=1e-6)
    jw = np.asarray(jconv._spectral_weight(jn))
    if kind == "conv2d":
        tw, jw = tconv2d.weight2d(tn).numpy(), jw.transpose(3, 2, 0, 1)
    else:
        tw = tconv.effective_weight(tn, transposed=transposed).numpy()
        jw = jw.transpose((1, 2, 0) if transposed else (2, 1, 0))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    jsigma = float(jnp.dot(jn["u_sn"], jconv._sn_matrix(jn["w_orig"])
                           @ jn["v_sn"]))
    tsigma = float(torch.dot(tn["u_sn"], tconv._sn_matrix(
        tn["w_orig"], transposed) @ tn["v_sn"]))
    assert jsigma > 0 and _rel(tsigma, jsigma) <= 1e-5
    # the tree walker finds the transposed conv by its key, `up`
    tree = {"up" if transposed else "conv": tp_}
    walked = tconv.spectral_norm_update_tree(tree)
    key_ = "up" if transposed else "conv"
    assert torch.equal(walked[key_]["u_sn"], tn["u_sn"])


# -- the discriminator -------------------------------------------------------

def test_msstftd_forward_matches_jax(gan):
    x = _batch(1)
    jl, jf = jmsstftd.msstftd_forward(gan["jstate"].disc_params,
                                      jnp.asarray(x), gan["jcfg"])
    tl, tf = msstftd.msstftd_forward(gan["tstate"].disc_params,
                                     torch.from_numpy(x), gan["tcfg"])
    assert len(tl) == len(jl) == 2 and all(len(f) == 5 for f in tf)
    for got, want in zip(tl + [a for f in tf for a in f],
                         jl + [a for f in jf for a in f]):
        want = _nchw(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert msstftd.sub_time_halo(gan["tcfg"]) == 10
    assert msstftd.msstftd_num_fmaps(gan["tcfg"]) == 5


@pytest.mark.parametrize("i", [0, 1])
def test_chunked_sums_match_jax_and_the_whole_forward(gan, i):
    """chunk=7 over 34 and 72 frames: a ragged last chunk at both
    resolutions; every sum against JAX's chunked sums and the port's
    whole-signal forward."""
    x = _batch(2)
    x_hat = x + 0.3 * np.random.RandomState(3).randn(*x.shape).astype(
        np.float32)
    jsub = gan["jstate"].disc_params["discs"][i]
    tsub = gan["tstate"].disc_params["discs"][i]
    want = jmsstftd.msstftd_gan_sums_chunked(
        jsub, jnp.asarray(x), jnp.asarray(x_hat), gan["jcfg"], i, chunk=7)
    got = msstftd.msstftd_gan_sums_chunked(
        tsub, torch.from_numpy(x), torch.from_numpy(x_hat), gan["tcfg"], i,
        chunk=7)
    lr, fr = msstftd.msstftd_sub_forward(tsub, torch.from_numpy(x),
                                         gan["tcfg"], i)
    lf, ff = msstftd.msstftd_sub_forward(tsub, torch.from_numpy(x_hat),
                                         gan["tcfg"], i)
    assert lr.shape[2] % 7 != 0
    whole = {"lg_real": (1 - lr).square().sum(), "sum_real": lr.sum(),
             "n_logit": float(lr.numel()),
             "lg_fake": (1 - lf).square().sum(), "sq_fake": lf.square().sum(),
             "sum_fake": lf.sum(),
             "feat_diff": torch.stack([(a - b).abs().sum()
                                       for a, b in zip(fr, ff)]),
             "feat_real": torch.stack([a.abs().sum() for a in fr])}
    assert set(got) == set(want) == set(whole)
    for k in whole:
        g = np.asarray(got[k], np.float64)
        for ref in (np.asarray(want[k], np.float64),
                    np.asarray(whole[k], np.float64)):
            np.testing.assert_allclose(g, ref, rtol=1e-5, err_msg=k)
    # the real signal alone
    alone = msstftd.msstftd_gan_sums_chunked(tsub, torch.from_numpy(x), None,
                                             gan["tcfg"], i, chunk=7)
    assert set(alone) == {"lg_real", "sum_real", "n_logit"}
    assert torch.equal(alone["lg_real"], got["lg_real"])


def test_msstftd_params_from_torch_matches_jax():
    """A reference-layout state dict (`discriminators.{i}.convs.{j}.conv.`,
    `…conv_post.conv.`; the first conv without a norm) built here."""
    jcfg, tcfg = _disc_cfgs("plain")
    rng = np.random.RandomState(7)
    state = {}
    for i in range(jcfg.num_discriminators):
        plan = jmsstftd._sub_channel_plan(jcfg)
        for j, (cin, cout, _s, _d, _p, k, norm) in enumerate(plan):
            pre = (f"discriminators.{i}.conv_post.conv." if j == len(plan) - 1
                   else f"discriminators.{i}.convs.{j}.conv.")
            w = rng.randn(cout, cin, *k).astype(np.float32)
            if norm == "weight_norm":
                state[pre + "weight_v"] = w
                state[pre + "weight_g"] = rng.rand(cout, 1, 1, 1).astype(
                    np.float32)
            else:
                state[pre + "weight"] = w
            state[pre + "bias"] = rng.randn(cout).astype(np.float32)
    got = zoo.msstftd_params_from_torch(state, tcfg)
    want = msstftd_params_from_jax(
        _np(jmsstftd.msstftd_params_from_torch(state, jcfg)))
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys() and len(g) == 2 * (1 * 2 + 5 * 3)
    for k in g:
        assert torch.equal(g[k], w[k]), k


# -- the steps ---------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_gan_terms_and_their_gradient_match_jax(gan, route):
    """(l_g, l_feat) and the gradient of 3·l_g + 3·l_feat with respect to
    a given x̂, by each route, against JAX's whole-signal terms."""
    _, tcfg = _disc_cfgs(route)
    x = _batch(5)
    x_hat = x + 0.3 * np.random.RandomState(6).randn(*x.shape).astype(
        np.float32)
    js = gan["jstate"]

    def jterms(y):
        _, fr = jmsstftd.msstftd_forward(js.disc_params, jnp.asarray(x),
                                         gan["jcfg"])
        lf, ff = jmsstftd.msstftd_forward(js.disc_params, y, gan["jcfg"])
        lg = jax_total_loss(fr, lf, ff, jnp.asarray(x), y)
        return 3 * lg["l_g"] + 3 * lg["l_feat"], (lg["l_g"], lg["l_feat"])

    (_, (jl_g, jl_feat)), jgrad = jax.value_and_grad(jterms, has_aux=True)(
        jnp.asarray(x_hat))
    y = torch.from_numpy(x_hat).requires_grad_(True)
    l_g, l_feat = gan_terms(gan["tstate"].disc_params, tcfg,
                            torch.from_numpy(x), y,
                            disc_remat=route == "remat")
    grad, = torch.autograd.grad(3 * l_g + 3 * l_feat, y)
    assert _rel(l_g, jl_g) <= 1e-5 and _rel(l_feat, jl_feat) <= 1e-5
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgrad).max()))


@pytest.mark.parametrize("route", ROUTES)
def test_gan_gen_step_matches_jax(gan, route):
    """`gen_step(use_gan=True)` by the chunked route, `disc_remat` and the
    whole-signal forward against JAX's same route: losses, every gradient
    leaf, the parameters and Adam moments after the step, the codebooks;
    the discriminator untouched."""
    st = gan["steps"](route)
    x = _batch(0)
    js, jm_ = st["jgen"](gan["jstate"], jnp.asarray(x),
                         JaxLossWeights.make(**WEIGHTS), use_gan=True)
    ts, tm_ = st["tgen"](gan["tstate"], torch.from_numpy(x),
                         LossWeights.make(**WEIGHTS), use_gan=True,
                         keep_grads=True)
    for k in ("loss", "loss_gen", "loss_feat", "loss_l1", "loss_freq",
              "loss_commit"):
        assert _rel(tm_[k], jm_[k]) <= 1e-5, k
    assert _rel(tm_["grad_norm"], jm_["grad_norm"]) <= GAN_GRAD_REL
    jgrads = _port_tree(_jax_gan_grads(gan, jnp.asarray(x)), gan)
    _close_grads(tm_["grads"], jgrads, GAN_GRAD_REL)
    _close_after_adam(ts.params, _port_tree(js.params, gan), jgrads,
                      WEIGHTS["lr"], GAN_GRAD_REL)
    adam = _find_adam(js.opt_state)
    _close_grads(ts.opt_state.mu, _port_tree(adam.mu, gan), GAN_GRAD_REL)
    _close_grads(ts.opt_state.nu, _port_tree(adam.nu, gan),
                 2 * GAN_GRAD_REL)
    for got, want in zip(ts.qstate[:3], js.qstate[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    for a, b in zip(tree_leaves(ts.disc_params),
                    tree_leaves(gan["tstate"].disc_params)):
        assert a is b and a.grad is None


@pytest.mark.parametrize("route", ROUTES)
def test_disc_step_matches_jax(gan, route):
    """`disc_step` against JAX's: the loss and mean logits, the
    discriminator's gradient, parameters and Adam moments after the step;
    the generator's parameters and quantizer state unchanged."""
    st = gan["steps"](route)
    x = _batch(4)
    js, jm_ = st["jdisc"](gan["jstate"], jnp.asarray(x),
                          JaxLossWeights.make(**WEIGHTS))
    ts, tm_ = st["tdisc"](gan["tstate"], torch.from_numpy(x),
                          LossWeights.make(**WEIGHTS), keep_grads=True)
    for k in ("loss_disc", "logits_real", "logits_fake", "disc_grad_norm"):
        assert _rel(tm_[k], jm_[k]) <= 1e-5, k
    jgrads = _port_disc(_jax_disc_grads(gan, jnp.asarray(x)))
    _close_grads(tm_["grads"], jgrads)
    _close_after_adam(ts.disc_params, _port_disc(js.disc_params), jgrads,
                      WEIGHTS["disc_lr"])
    adam = _find_adam(js.disc_opt_state)
    assert int(ts.disc_opt_state.count) == int(adam.count) == 1
    _close_grads(ts.disc_opt_state.mu, _port_disc(adam.mu))
    _close_grads(ts.disc_opt_state.nu, _port_disc(adam.nu), 2e-4)
    assert ts.params is gan["tstate"].params
    assert ts.qstate is gan["tstate"].qstate
    assert int(ts.opt_state.count) == 0


def test_three_alternating_gan_and_disc_steps_match_jax(gan):
    """gan.yaml's route (chunked): a GAN generator step, then a plain
    generator step and a discriminator step (a coin flip each way), three
    times."""
    st = gan["steps"]("chunked")
    js, ts = gan["jstate"], gan["tstate"]
    jw, tw = JaxLossWeights.make(**WEIGHTS), LossWeights.make(**WEIGHTS)
    for i in range(3):
        x = _batch(20 + i)
        js, jm_ = st["jgen"](js, jnp.asarray(x), jw, use_gan=True)
        ts, tm_ = st["tgen"](ts, torch.from_numpy(x), tw, use_gan=True)
        assert _rel(tm_["loss"], jm_["loss"]) <= GAN_SEQ_REL, i
        js, jd = st["jdisc"](js, jnp.asarray(x), jw)
        ts, td = st["tdisc"](ts, torch.from_numpy(x), tw)
        assert _rel(td["loss_disc"], jd["loss_disc"]) <= GAN_SEQ_REL, i
    assert int(ts.disc_opt_state.count) == 3 == int(ts.opt_state.count)


# -- checkpoints -------------------------------------------------------------

def _assert_gan_states_equal(a, b):
    for x, y in zip(tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu,
                                 a.disc_params, a.disc_opt_state.mu,
                                 a.disc_opt_state.nu)),
                    tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu,
                                 b.disc_params, b.disc_opt_state.mu,
                                 b.disc_opt_state.nu))):
        assert torch.equal(x, y)
    for x, y in ((a.opt_state.count, b.opt_state.count),
                 (a.disc_opt_state.count, b.disc_opt_state.count),
                 (a.rng, b.rng)) + tuple(zip(a.qstate[:3], b.qstate[:3])):
        assert torch.equal(x, y)


def test_gan_checkpoints_cross_both_ways(gan, tmp_path):
    """The port's GAN state saves and loads bit for bit and the JAX
    package's reader opens it into its `TrainState`; a JAX-written GAN
    state (after a GAN step and a discriminator step) comes across through
    `train_state_from_jax`, discriminator and moments included, and a
    step runs from it."""
    st = gan["steps"]("chunked")
    w, jw = LossWeights.make(**WEIGHTS), JaxLossWeights.make(**WEIGHTS)
    x = _batch(30)
    ts, _ = st["tgen"](gan["tstate"], torch.from_numpy(x), w, use_gan=True)
    ts, _ = st["tdisc"](ts, torch.from_numpy(x), w)
    path = tmp_path / "port.ckpt"
    save_checkpoint(ts, 4, path, extra={"param_layout": "torch"})
    raw, epoch, _ = load_checkpoint(path)
    assert epoch == 4
    _assert_gan_states_equal(state_to_device(raw, torch.device("cpu")), ts)
    jraw, _, _ = jax_load_checkpoint(path)
    jstate = JaxTrainState(*jraw)
    np.testing.assert_array_equal(
        jstate.disc_params["discs"][1]["convs"][2]["v"],
        ts.disc_params["discs"][1]["convs"][2]["v"].numpy())
    np.testing.assert_array_equal(
        jstate.disc_opt_state.nu["discs"][0]["convs"][4]["g"],
        ts.disc_opt_state.nu["discs"][0]["convs"][4]["g"].numpy())

    js, _ = st["jgen"](gan["jstate"], jnp.asarray(x), jw, use_gan=True)
    js, _ = st["jdisc"](js, jnp.asarray(x), jw)
    jpath = tmp_path / "jax.ckpt"
    jax_save_checkpoint(js, 9, jpath)
    raw, epoch, _ = load_checkpoint(jpath)
    got = zoo.train_state_from_jax(raw, gan["tm"].cfg)
    assert epoch == 9
    for a, b in zip(tree_leaves(got.disc_params),
                    tree_leaves(_port_disc(js.disc_params))):
        assert torch.equal(a, b)
    adam = _find_adam(js.disc_opt_state)
    assert int(got.disc_opt_state.count) == 1
    for a, b in zip(tree_leaves((got.disc_opt_state.mu,
                                 got.disc_opt_state.nu)),
                    tree_leaves((_port_disc(adam.mu),
                                 _port_disc(adam.nu)))):
        assert torch.equal(a, b)
    state, m = st["tdisc"](got, torch.from_numpy(_batch(31)), w)
    assert np.isfinite(float(m["loss_disc"]))
    assert int(state.disc_opt_state.count) == 2
