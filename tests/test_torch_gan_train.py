"""The GAN phase's trainer, its checkpoints, the balanced step and a
spectral-norm step: the port against the JAX package on the CPU.

The tiny model and steps are `tests/test_torch_train.py`'s (tolerances
there); the Trainer runs its tiny experiment with the discriminator on
from epoch 1 (prob 0.5), a 64-FFT discriminator chunked by 7 frames, and
the gradient balancer (`loss.use_balancer`), over synthetic npz nights.
The coin flips are held to the JAX Trainer's with both trainers' steps
replaced by recorders (the flips are the loop's, not the steps').
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.losses.balancer import Balancer as JaxBalancer
from encodec_tpu.losses.balancer import balance as jax_balance
from encodec_tpu.losses.spectrogram import (
    reconstruction_loss as jax_reconstruction_loss)
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.model import forward_train as jax_forward_train
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu.train import save_checkpoint as jax_save_checkpoint
from encodec_tpu.train.trainer import Trainer as JaxTrainer
from encodec_tpu.train.trainer import disc_from_config as jax_disc_from_config
from encodec_tpu.train.trainer import model_from_config as jax_model_from_config
from encodec_tpu_torch.losses import Balancer
from encodec_tpu_torch.models import build_model, params_from_jax
from encodec_tpu_torch.models.zoo import msstftd_params_from_jax
from encodec_tpu_torch.train import (ConfigNamespace, LossWeights, Trainer,
                                     create_train_state, load_config,
                                     make_train_steps)
from encodec_tpu_torch.train import __main__ as train_entry
from encodec_tpu_torch.train.__main__ import main as train_main
from encodec_tpu_torch.train.optim import tree_leaves
from tests.test_torch_gan import _assert_gan_states_equal
from tests.test_torch_train import (CONFIG, FL, FL_FULL, TINY, WEIGHTS,
                                    _batch, _close_grads, _leaves, _nights,
                                    _np, _rel)

PARAMS = "encodec_tpu/params"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gan_config(root, start=1):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["dataset"]["root"] = str(root)
    cfg["common"]["max_epoch"] = 10
    cfg["model"].update(train_discriminator=True,
                        train_discriminator_start_epoch=start,
                        train_discriminator_prob=0.5, disc_time_chunk=7)
    cfg["loss"].update(weight_g=3.0, weight_feat=3.0, use_balancer=True)
    cfg["balancer"] = {"weights": {"l_t": 1.0, "l_f": 1.0}}
    return cfg


# -- the trainer --------------------------------------------------------------

def _record(trainer, log):
    """Replace a trainer's steps by recorders of the loop's choices."""
    zeros = {k: 0.0 for k in ("loss", "loss_l1", "loss_l2", "loss_freq",
                              "loss_commit", "freq_acc", "grad_norm",
                              "loss_disc", "logits_real", "logits_fake")}

    def gen(state, x, w, use_gan=False):
        log.append("gan" if use_gan else "gen")
        return state, zeros

    def step(name):
        def fn(state, x, w):
            log.append(name)
            return state, zeros
        return fn

    trainer.gen_step = gen
    trainer.disc_step = step("disc")
    trainer.balanced_gen_step = step("balanced")
    if hasattr(trainer, "_steps_for"):
        trainer._steps_for = lambda n_q: (trainer.gen_step, trainer.disc_step,
                                          trainer.balanced_gen_step)


def test_trainer_coin_flips_equal_jax(tmp_path):
    """Epoch 1 without the discriminator (no draw), then epochs 2-4 with a
    coin per batch: the same sequence of GAN, plain, balanced and
    discriminator steps as the JAX Trainer's, from the seed."""
    cfg = _gan_config(tmp_path, start=2)
    batches = [({"x": _batch(i)}, np.zeros(2, np.int32)) for i in range(6)]
    logs = {}
    for name, cls, kw in (("jax", JaxTrainer, {}),
                          ("port", Trainer, {"device": "cpu"})):
        trainer = cls(ConfigNamespace(cfg), batches, [],
                      str(tmp_path / name), **kw)
        logs[name] = []
        _record(trainer, logs[name])
        for epoch in range(1, 5):
            trainer.train_one_epoch(epoch)
    assert logs["port"] == logs["jax"]
    assert logs["port"][:6] == ["balanced"] * 6
    flips = logs["port"][6:]
    assert flips.count("disc") == flips.count("balanced") > 0
    assert flips.count("gan") > 0


def test_gan_fit_saves_and_resumes_bit_for_bit(tmp_path, monkeypatch):
    """`python -m encodec_tpu_torch.train` on a GAN config: two epochs of
    two steps (coin flips from epoch 1; the chunked discriminator; the
    balanced step), eval and save; a fresh Trainer resumes the saved
    state bit for bit, discriminator, its Adam state and the balancer's
    state included, and steps on."""
    build = train_entry.build_dataloaders

    def cut(config):
        train, val, mapping = build(config)
        train.dataset.size, val.dataset.size = 4, 1
        return train, val, mapping

    monkeypatch.setattr(train_entry, "build_dataloaders", cut)
    _nights(tmp_path / "data")
    cfg = _gan_config(tmp_path / "data")
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    run = tmp_path / "run"
    trainer = train_main(["--config", str(tmp_path / "c.json"), "--log_dir",
                          str(run), "--max_epochs", "2", "--device", "cpu"])
    s = trainer.state
    n_disc = int(s.disc_opt_state.count)
    assert int(s.opt_state.count) == 4 and 0 < n_disc < 4
    assert float(s.balancer_state["fix"]["l_t"]) > 0
    fresh = Trainer(ConfigNamespace(cfg), [], [], str(run), device="cpu")
    fresh.resume()
    assert fresh.start_epoch == 3
    _assert_gan_states_equal(fresh.state, s)
    for part in ("total", "fix"):
        for k in ("l_t", "l_f"):
            assert torch.equal(fresh.state.balancer_state[part][k],
                               s.balancer_state[part][k])
    x, w = torch.from_numpy(_batch(50)), fresh.weights_for_epoch(3)
    state, m = fresh.gen_step(fresh.state, x, w, use_gan=True)
    state, dm = fresh.disc_step(state, x, w)
    assert np.isfinite(float(m["loss_feat"]))
    assert int(state.disc_opt_state.count) == n_disc + 1


def test_trainer_resumes_a_jax_written_gan_checkpoint(tmp_path):
    cfg = _gan_config(tmp_path)
    jm = jax_model_from_config(ConfigNamespace(cfg))
    jstate, _, _ = jax_create_train_state(
        jm, jax_disc_from_config(ConfigNamespace(cfg)), seed=0,
        balancer=JaxBalancer(weights={"l_t": 1.0, "l_f": 1.0}))
    path = tmp_path / "model.ckpt"
    jax_save_checkpoint(jstate, 5, path, extra={"config": cfg})
    trainer = Trainer(ConfigNamespace(cfg), [], [], str(tmp_path / "run"),
                      device="cpu")
    trainer.resume(str(path))
    assert trainer.start_epoch == 6
    st = trainer.state
    for a, b in zip(tree_leaves(st.disc_params),
                    tree_leaves(msstftd_params_from_jax(
                        _np(jstate.disc_params)))):
        assert torch.equal(a, b)
    assert int(st.disc_opt_state.count) == 0
    assert sorted(st.balancer_state["total"]) == ["l_f", "l_t"]
    x, w = torch.from_numpy(_batch(51)), trainer.weights_for_epoch(6)
    state, dm = trainer.disc_step(st, x, w)
    state, m = trainer.gen_step(state, x, w, use_gan=True)
    assert np.isfinite(float(dm["loss_disc"])) and np.isfinite(
        float(m["loss_gen"]))


@pytest.mark.parametrize("name,chunk,n_disc", [("gan", 512, 2),
                                               ("gan_disc512", None, 1)])
def test_gan_configs_build(name, chunk, n_disc, tmp_path, caplog):
    """`params/gan.yaml` and `gan_disc512.yaml` as written build a Trainer
    and the four steps; `common.disc_remat` beside `disc_time_chunk` is
    logged as superseded."""
    config = load_config(f"{PARAMS}/{name}.yaml")
    trainer = Trainer(config, [], [], str(tmp_path / "run"), device="cpu")
    d = trainer.disc_cfg
    assert d.time_chunk == chunk and d.num_discriminators == n_disc
    assert d.filters == 32 and trainer.state.disc_params is not None
    steps = make_train_steps(trainer.model.cfg, d,
                             freq_loss_kwargs=trainer.freq_kwargs)
    assert len(steps) == 4 and steps[3] is None
    if chunk:
        config.common.disc_remat = True
        with caplog.at_level(logging.WARNING):
            Trainer(config, [], [], str(tmp_path / "r2"), device="cpu")
        assert "supersedes" in caplog.text


# -- the balanced step and spectral norm --------------------------------------

def test_balanced_gen_step_matches_jax():
    """The balancer's losses, `ratio_*` metrics and EMA state (1e-5, and
    1e-4 at the second step in a row, as for steps in a row in
    `tests/test_torch_train.py`), the gradient (the balanced cotangent and
    the commit cotangent in one backward)."""
    jm = jax_build_model([0.08], seed=3, **TINY)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    weights = {"l_t": 1.0, "l_f": 2.0}
    jbal, tbal = JaxBalancer(weights=weights), Balancer(weights=weights)
    js, _, _ = jax_create_train_state(jm, None, seed=1, balancer=jbal)
    ts = create_train_state(tm, None, seed=1, balancer=tbal)
    jstep = jax_make_train_steps(jm.cfg, None, balancer=jbal,
                                 freq_loss_kwargs=FL)[3]
    tstep = make_train_steps(tm.cfg, None, balancer=tbal,
                             freq_loss_kwargs=FL)[3]
    jw, tw = JaxLossWeights.make(**WEIGHTS), LossWeights.make(**WEIGHTS)
    for i, tol in enumerate((1e-5, 1e-4)):
        x = _batch(40 + i)
        if i == 0:
            jgrads = _jax_balanced_grads(jm, js, jnp.asarray(x), jbal, jw)
        js, jm_ = jstep(js, jnp.asarray(x), jw)
        ts, tm_ = tstep(ts, torch.from_numpy(x), tw, keep_grads=i == 0)
        for k in ("loss", "loss_l_t", "loss_l_f", "ratio_l_t", "ratio_l_f",
                  "loss_commit"):
            assert _rel(tm_[k], jm_[k]) <= tol, (i, k)
        if i == 0:   # a function of the gradient: the gradient's bound
            assert _rel(tm_["grad_norm"], jm_["grad_norm"]) <= 1e-4
        for part in ("total", "fix"):
            for k in weights:
                assert _rel(ts.balancer_state[part][k],
                            js.balancer_state[part][k]) <= tol, (i, part)
        if i == 0:
            _close_grads(tm_["grads"], params_from_jax(
                _np(jgrads), tuple(_np(jm.qstate)), tm.cfg)[0])
    assert int(ts.opt_state.count) == 2


def _jax_balanced_grads(jm, js, x, bal, w):
    """JAX's balanced step's gradient: one vjp of (x̂, mean commit) at
    (the balanced cotangent, commit + codebook weight)."""
    _, rng = jax.random.split(js.rng)

    def fwd(params):
        x_hat, _, commit, q = jax_forward_train(
            params, js.qstate, x, jm.cfg, jm.cfg.rvq.n_q, rng, training=True)
        return (x_hat, jnp.mean(commit)), q

    (x_hat, _), vjp_fn, _ = jax.vjp(fwd, js.params, has_aux=True)
    loss_fns = {
        "l_t": lambda y: jnp.mean(jnp.abs(x - y)),
        "l_f": lambda y: jax_reconstruction_loss(
            x[..., 0], y[..., 0], **FL_FULL)["total_loss"]}
    cot = jax_balance(bal, loss_fns, x_hat, js.balancer_state)[0]
    return vjp_fn((cot, w.commit + w.codebook))[0]


def test_spectral_norm_gen_step_matches_jax():
    """`model_norm="spectral_norm"` (JAX `tests/test_train.py:397-440`):
    one generator step refreshes every conv's u and v by one power
    iteration from the pre-step weights (transposed convs by Cout, their
    dim 1) and gives them no update; u, v, σ and the loss against JAX's."""
    kw = dict(TINY, model_norm="spectral_norm")
    jm = jax_build_model([0.08], seed=3, **kw)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **kw)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    js, _, _ = jax_create_train_state(jm, None, seed=0)
    ts = create_train_state(tm, None, seed=0)
    jgen = jax_make_train_steps(jm.cfg, None, freq_loss_kwargs=FL)[0]
    tgen = make_train_steps(tm.cfg, None, freq_loss_kwargs=FL)[0]
    x = _batch(45)
    js2, jm_ = jgen(js, jnp.asarray(x), JaxLossWeights.make(**WEIGHTS),
                    use_gan=False)
    ts2, tm_ = tgen(ts, torch.from_numpy(x), LossWeights.make(**WEIGHTS))
    assert _rel(tm_["loss"], jm_["loss"]) <= 1e-5
    want = params_from_jax(_np(js2.params), tuple(_np(jm.qstate)),
                           tm.cfg)[0]
    got, ref = dict(_leaves(ts2.params)), dict(_leaves(want))
    n_sn = 0
    for k in got:
        if k.endswith(("u_sn", "v_sn")):
            n_sn += 1
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            before = dict(_leaves(ts.params))[k]
            assert not torch.equal(got[k], before), k
    assert n_sn == 2 * sum(1 for k in got if k.endswith("w_orig")) > 20
    from encodec_tpu.ops import conv as jconv
    from encodec_tpu_torch.ops import conv as tconv
    up_j = js2.params["decoder"]["stages"][0]["up"]
    up_t = ts2.params["decoder"]["stages"][0]["up"]
    jsig = float(jnp.dot(up_j["u_sn"], jconv._sn_matrix(up_j["w_orig"])
                         @ up_j["v_sn"]))
    tsig = float(torch.dot(up_t["u_sn"], tconv._sn_matrix(
        up_t["w_orig"], transposed=True) @ up_t["v_sn"]))
    assert _rel(tsig, jsig) <= 1e-5
