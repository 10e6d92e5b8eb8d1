"""The published experiment configs as the port's own: the port against the
JAX package on the CPU.

- `encodec_tpu_torch/params/*.yaml` are byte copies of
  `encodec_tpu/params/*.yaml`;
- `train.load_config` with PyYAML hidden (`sys.modules["yaml"] = None`, as
  on a machine without it) gives `yaml.safe_load`'s dict, types included,
  for each file and for a `yaml.dump` snapshot of it (what the JAX trainer
  writes into a run directory), and refuses YAML outside its subset naming
  the file and line;
- `model_from_config` of each full config builds on the CPU with the JAX
  package's n_q, LSTM width, hop and discriminator resolutions (no step is
  run at that size);
- the six configs never trained on the card before (`NEW`), narrowed to
  filters 4 and dimension 16 on B=2 nights of `NIGHT` samples at their own
  ratios, bins, norm, losses and discriminator resolutions, take one
  generator step in both packages from the same weights (`params_from_jax`,
  every cluster size at 50 so no code expires, no k-means): the tolerances
  of `tests/test_torch_train.py`; `l2_weightnorm` (the GAN phase from epoch
  0) also a GAN generator step and a discriminator step at
  `tests/test_torch_gan.py`'s bounds. The gradient is read from Adam's
  first moment after the step (0.2 of the clipped gradient in both
  packages), so JAX's step is not differentiated a second time. The
  gradient's global norm before the clip (`grad_norm`) is held to
  `GRAD_NORM_REL` = 5e-3, not 1e-5: at these narrowed random weights it is
  ill-conditioned in float32 in both packages alike. Measured on the
  step's own batch, scaling the input by 1 ± 1e-7 moved it by up to 2.5e-3
  relative (l2: 641.98-643.57 in the port, 641.99-643.19 in JAX), by 1.2e-3
  in JAX for disc256_bins256, and the port's thread count alone (1, 2, 4)
  by 7e-4 (l2); the packages were 1.2e-3 (l2), 5.5e-5 (bins512_commit) and
  4.3e-5 (disc256_bins256) apart, every other config within 1e-5. The
  clipped gradient, which is what the step applies, is held at 1e-4
  through Adam's first moment (2.8e-5 of its largest value on l2);
- `python -m encodec_tpu_torch.train` on a narrowed copy of
  `tokens_10s.yaml` with PyYAML hidden writes `config.json` and resumes from
  it bit for bit; `tools.export` and `tools.inference` read a run whose
  snapshot is `config.yaml`, also without PyYAML.
"""

import dataclasses
import math
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

import encodec_tpu
import encodec_tpu_torch
from encodec_tpu.losses.spectrogram import (
    reconstruction_loss as jax_reconstruction_loss)
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu.train.trainer import disc_from_config as jax_disc_from_config
from encodec_tpu.train.trainer import (
    model_from_config as jax_model_from_config)
from encodec_tpu_torch.models import params_from_jax
from encodec_tpu_torch.models.zoo import _find_adam, msstftd_params_from_jax
from encodec_tpu_torch.tools import export, inference
from encodec_tpu_torch.train import (ConfigNamespace, Trainer,
                                     config_to_dict, create_train_state,
                                     disc_from_config, load_config,
                                     model_from_config)
from encodec_tpu_torch.train import __main__ as train_entry
from encodec_tpu_torch.train.config import read_yaml
from tests.test_torch_gan import GAN_GRAD_REL
from tests.test_torch_train import (_assert_states_equal, _batch,
                                    _close_grads, _leaves, _np, _rel)

PORT_PARAMS = Path(encodec_tpu_torch.__file__).parent / "params"
JAX_PARAMS = Path(encodec_tpu.__file__).parent / "params"
NAMES = ("bins512_commit", "default", "disc256_bins256", "gan",
         "gan_disc512", "hires_tokens", "l2", "l2_weightnorm",
         "multires_disc", "tokens_10s")
NEW = ("tokens_10s", "l2_weightnorm", "l2", "multires_disc",
       "bins512_commit", "disc256_bins256")
NIGHT = 1200       # samples per narrowed night: 4 frames at hop 300
GRAD_NORM_REL = 5e-3
EPOCH = 31         # the commit loss on, every learning rate above zero


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_pyyaml(monkeypatch):
    """`import yaml` raises ImportError, as where PyYAML is missing."""
    monkeypatch.setitem(sys.modules, "yaml", None)


def _same(got, want) -> bool:
    """Equal values of equal types, through dicts (in order) and lists."""
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return (list(got) == list(want)
                and all(type(a) is type(b) for a, b in zip(got, want))
                and all(_same(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return len(got) == len(want) and all(map(_same, got, want))
    if isinstance(want, float) and math.isnan(want):
        return math.isnan(got)
    return got == want


# -- (1) the ten files --------------------------------------------------------

def test_the_port_has_all_ten_configs():
    assert sorted(p.stem for p in JAX_PARAMS.glob("*.yaml")) == list(NAMES)
    assert sorted(p.stem for p in PORT_PARAMS.glob("*.yaml")) == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_config_is_a_byte_copy(name):
    assert (PORT_PARAMS / f"{name}.yaml").read_bytes() == \
        (JAX_PARAMS / f"{name}.yaml").read_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_safe_load_without_pyyaml(name, no_pyyaml, tmp_path):
    """The file, its snapshot (config.json) and a `yaml.dump` of it (a run
    directory's config.yaml as the JAX trainer writes it)."""
    path = PORT_PARAMS / f"{name}.yaml"
    want = yaml.safe_load(path.read_text())
    got = config_to_dict(load_config(str(path), str(tmp_path / "run")))
    assert _same(got, want)
    assert isinstance(want["optimization"]["lr"], str)   # '1e-3', YAML 1.1
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == \
        ["config.json"]
    assert _same(config_to_dict(load_config(
        str(tmp_path / "run" / "config.json"))), want)
    dumped = yaml.dump(want)
    assert _same(read_yaml(dumped), yaml.safe_load(dumped))


def _full(name):
    return ConfigNamespace(yaml.safe_load(
        (PORT_PARAMS / f"{name}.yaml").read_text()))


def _lstm_width(params):
    return params["encoder"]["lstm"]["layers"][0]["w_hh"].shape


@pytest.mark.parametrize("name", NAMES)
def test_model_from_config_matches_jax(name):
    """The full-width generator and discriminator of each config, built and
    not run: n_q, the LSTM's width, the hop, the frame rate, bins, norm,
    and the discriminator's resolutions (`train_discriminator` forced on
    where the config has it off)."""
    config = _full(name)
    tm = model_from_config(config, device="cpu")
    jm = jax_model_from_config(config)
    for part in ("seanet", "rvq"):
        assert dataclasses.asdict(getattr(tm.cfg, part)) == \
            dataclasses.asdict(getattr(jm.cfg, part)), part
    assert tm.cfg.rvq.n_q == jm.cfg.rvq.n_q
    assert tm.frame_rate == jm.frame_rate
    hop = int(np.prod(config.model.ratios))
    assert tm.cfg.seanet.hop_length == jm.cfg.seanet.hop_length == hop
    H = 32 * 2 ** len(config.model.ratios)
    assert tuple(_lstm_width(tm.params)) == (4 * H, H)
    assert tuple(np.asarray(_lstm_width(jm.params))) in ((4 * H, H),
                                                         (H, 4 * H))
    config.model.train_discriminator = True
    td, jd = disc_from_config(config), jax_disc_from_config(config)
    for field in ("filters", "n_ffts", "hop_lengths", "win_lengths",
                  "time_chunk"):
        assert getattr(td, field) == getattr(jd, field), field
    assert td.n_ffts == tuple(config.model.disc_n_ffts)


# -- (3) what the reader refuses ---------------------------------------------

REFUSED = {
    "anchor": ("a: 1\nb: &x 2\n", 2, "anchor"),
    "alias": ("a: 1\nb:\n  c: *x\n", 3, "alias"),
    "tag": ("a: !!str 1\n", 1, "tag"),
    "block scalar": ("a: 1\nb: |\n  text\n", 2, "block scalar"),
    "folded scalar": ("b: >\n  text\n", 1, "block scalar"),
    "second document": ("a: 1\n---\nb: 2\n", 2, "several documents"),
    "flow map": ("a:\n  b: {x: 1}\n", 2, "flow map"),
    "flow list over lines": ("a: [1,\n  2]\n", 1, "spanning lines"),
    "nested flow list": ("a: [1, [2]]\n", 1, "collection in a flow list"),
    "backslash escape": ('a: "x\\ty"\n', 1, "backslash escape"),
    "multi-line scalar": ("a: one\n  two\n", 2, "multi-line"),
    "map in a list": ("a:\n- x: 1\n", 2, "map inside"),
    "timestamp": ("a:\n  b: 2001-12-14\n", 2, "timestamp"),
    "tab": ("a: 1\nb:\t2\n", 2, "tab"),
    "octal int": ("a: 017\n", 1, "octal int"),
    "hex int": ("a:\n  b: 0x1F\n", 2, "hex int"),
    "binary int": ("a: [1, 0b101]\n", 1, "binary int"),
    "sexagesimal int": ("a: 1:30\n", 1, "sexagesimal int"),
    "sexagesimal float": ("a: 190:20:30.15\n", 1, "sexagesimal float"),
    "infinity": ("a: .inf\n", 1, "the float '.inf'"),
    "negative infinity": ("a: -.Inf\n", 1, "the float '-.Inf'"),
    "not a number": ("a: 1\nb: .NaN\n", 2, "the float '.NaN'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_reader_refuses_yaml_outside_its_subset(case, no_pyyaml, tmp_path):
    text, line, what = REFUSED[case]
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=re.escape(f"{path}:{line}: ")
                       + f".*{what}"):
        load_config(str(path))


SCALARS = ("1e-3", "3.", ".5", "-1.5e+3", "1.e+3", "09", "1_000", "0",
           "yes", "No", "on", "OFF", "y", "~", "null", "", "None",
           "'it''s'", '"a # b"', "b#c", "b # c", "http://x/y",
           "[1, 'two', 3.0, -4, yes, ~]", "[]", "[a b, 1e-3,]", "0o7", "+1",
           "-0", "bins 512, commit 0.1 (ref 221224_l1)")


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_scalars_as_yaml_1_1(text):
    """PyYAML's implicit resolvers, exactly: `1e-3` (no dot) is a string,
    `3.` a float, `yes` True, `None` a string."""
    doc = f"key: {text}\n"
    assert _same(read_yaml(doc), yaml.safe_load(doc))


# -- (2) the six new configs, narrowed, against JAX ---------------------------

def _narrow(name):
    """The config as written, narrowed: filters 4, dimension 16, B=2
    nights of `NIGHT` samples from a `synth` dataset, logging and saving
    every epoch."""
    cfg = yaml.safe_load((PORT_PARAMS / f"{name}.yaml").read_text())
    cfg["model"].update(filters=4, dimension=16)
    cfg["dataset"].update(batch_size=2, max_length=NIGHT, num_workers=0,
                          datasets={"synth": 1.0})
    cfg["common"]["log_interval"] = 1
    cfg["checkpoint"]["save_every"] = 1
    return cfg


def _jax_model(config):
    """JAX's generator of `config` with drawn codebooks (`kmeans_init`
    off) and every cluster size at 50; otherwise `model_from_config`'s
    (`_pair` holds its config against the port's `model_from_config`)."""
    m = config.model
    jm = jax_build_model(
        list(m.target_bandwidths), sample_rate=m.sample_rate,
        channels=m.channels, causal=m.causal, model_norm=m.norm,
        audio_normalize=m.audio_normalize, segment=None, name=m.name,
        ratios=list(m.ratios), bins=m.bins, dimension=m.dimension,
        n_filters=m.filters, decoder_final_norm="none",
        shared_codebook=True, kmeans_init=False, seed=3)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    return jm


_PAIRS: dict = {}


def _pair(name, tmp_path_factory):
    """The narrowed config's port Trainer (its steps as the entry point
    builds them) and JAX's steps, from the same weights."""
    if name in _PAIRS:
        return _PAIRS[name]
    config = ConfigNamespace(_narrow(name))
    tr = Trainer(config, [], [], str(tmp_path_factory.mktemp(name)),
                 device="cpu")
    jm = _jax_model(config)
    assert dataclasses.asdict(jm.cfg.seanet) == \
        dataclasses.asdict(tr.model.cfg.seanet)
    assert dataclasses.asdict(jm.cfg.rvq) == dict(
        dataclasses.asdict(tr.model.cfg.rvq), kmeans_init=False)
    jdisc = jax_disc_from_config(config)
    jstate = jax_create_train_state(jm, jdisc, seed=0, clip=tr.clip)[0]
    tr.model.params, tr.model.qstate = params_from_jax(
        _np(jm.params), tuple(_np(jm.qstate)), tr.model.cfg)
    tstate = create_train_state(tr.model, tr.disc_cfg, seed=0, clip=tr.clip)
    if jdisc is not None:
        tstate = tstate._replace(
            disc_params=msstftd_params_from_jax(_np(jstate.disc_params)))
    jgen, jdisc_step = jax_make_train_steps(
        jm.cfg, jdisc, freq_loss_kwargs=tr.freq_kwargs, clip=tr.clip)[:2]
    tw = tr.weights_for_epoch(EPOCH)
    _PAIRS[name] = dict(tr=tr, jm=jm, jstate=jstate, tstate=tstate,
                        jgen=jgen, jdisc=jdisc_step, tw=tw,
                        jw=JaxLossWeights.make(**tw._asdict()))
    return _PAIRS[name]


def _port(tree, p):
    return params_from_jax(_np(tree), tuple(_np(p["jm"].qstate)),
                           p["tr"].model.cfg)[0]


def _close_after_adam(got_tree, want_tree, jmu, lr, rel):
    """Parameters after Adam's first step: within 2e-5 where JAX's
    gradient (here its first moment) is above its noise, within 2·lr
    elsewhere (`tests/test_torch_gan.py`)."""
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    grads = {k: np.abs(v.numpy()) for k, v in _leaves(jmu)}
    assert got.keys() == want.keys() == grads.keys()
    top = max(float(g.max()) for g in grads.values())
    for k in got:
        noise = rel * (float(grads[k].max()) + top)
        err = np.abs(got[k].numpy() - want[k].numpy())
        assert float(err[grads[k] > noise].max(initial=0)) <= 2e-5, k
        assert float(err.max()) <= 2 * lr, k


def _check_gen_step(p, use_gan, rel):
    x = _batch(7, B=2, T=NIGHT)
    js, jm_ = p["jgen"](p["jstate"], jnp.asarray(x), p["jw"],
                        use_gan=use_gan)
    ts, tm_ = p["tr"].gen_step(p["tstate"], torch.from_numpy(x), p["tw"],
                               use_gan=use_gan)
    keys = ["loss", "loss_l1", "loss_l2", "loss_freq", "loss_commit"]
    for k in keys + (["loss_gen", "loss_feat"] if use_gan else []):
        assert _rel(tm_[k], jm_[k]) <= 1e-5, k
    assert _rel(tm_["grad_norm"], jm_["grad_norm"]) <= GRAD_NORM_REL
    # an argmax per frame: a near-tie may move one frame per item
    frames = jax_reconstruction_loss(jnp.asarray(x[..., 0]),
                                     jnp.asarray(x[..., 0]),
                                     **p["tr"].freq_kwargs)["S_x"].shape[-1]
    assert abs(float(tm_["freq_acc"]) - float(jm_["freq_acc"])) <= 1 / frames
    adam = _find_adam(js.opt_state)
    assert int(ts.opt_state.count) == int(adam.count) == 1
    jmu = _port(adam.mu, p)
    _close_grads(ts.opt_state.mu, jmu, rel)
    _close_grads(ts.opt_state.nu, _port(adam.nu, p), 2 * rel)
    _close_after_adam(ts.params, _port(js.params, p), jmu, float(p["tw"].lr),
                      rel)
    for got, want in zip(ts.qstate[:3], js.qstate[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    assert all(float(m.abs().max()) > 0 for _, m in _leaves(ts.opt_state.mu))


@pytest.mark.parametrize("name", NEW)
def test_narrowed_gen_step_matches_jax(name, tmp_path_factory):
    """One generator step of the narrowed config as the trainer builds it
    (its losses, clip, n_q and norm) against JAX's: losses 1e-5 relative,
    the gradient (Adam's first moment) and second moment 1e-4 / 2e-4,
    parameters after the step, the codebook state 1e-4."""
    p = _pair(name, tmp_path_factory)
    tr = p["tr"]
    assert tr._gan_active(1) == (name == "l2_weightnorm")
    assert tr.model.cfg.seanet.norm == _full(name).model.norm
    _check_gen_step(p, use_gan=False, rel=1e-4)


def test_l2_weightnorm_gan_step_matches_jax(tmp_path_factory):
    """The GAN generator step of l2_weightnorm (weight norm, pure L2, two
    discriminators at n_fft 1024 and hops 20 / 128 on the whole-signal
    route): `tests/test_torch_gan.py`'s bounds (`GAN_GRAD_REL`)."""
    p = _pair("l2_weightnorm", tmp_path_factory)
    assert p["tr"].disc_cfg.time_chunk is None
    assert p["tr"].disc_cfg.hop_lengths == (20, 128)
    _check_gen_step(p, use_gan=True, rel=GAN_GRAD_REL)


def test_l2_weightnorm_disc_step_matches_jax(tmp_path_factory):
    """The discriminator step of l2_weightnorm: loss and logits 1e-5
    relative, the discriminator's first moment 1e-4, its parameters after
    Adam; the generator untouched."""
    p = _pair("l2_weightnorm", tmp_path_factory)
    x = _batch(8, B=2, T=NIGHT)
    js, jm_ = p["jdisc"](p["jstate"], jnp.asarray(x), p["jw"])
    ts, tm_ = p["tr"].disc_step(p["tstate"], torch.from_numpy(x), p["tw"])
    for k in ("loss_disc", "logits_real", "logits_fake", "disc_grad_norm"):
        assert _rel(tm_[k], jm_[k]) <= 1e-5, k
    adam = _find_adam(js.disc_opt_state)
    assert int(ts.disc_opt_state.count) == int(adam.count) == 1
    jmu = msstftd_params_from_jax(_np(adam.mu))
    _close_grads(ts.disc_opt_state.mu, jmu)
    _close_grads(ts.disc_opt_state.nu, msstftd_params_from_jax(
        _np(adam.nu)), 2e-4)
    _close_after_adam(ts.disc_params, msstftd_params_from_jax(
        _np(js.disc_params)), jmu, float(p["tw"].disc_lr), 1e-4)
    assert ts.params is p["tstate"].params
    assert int(ts.opt_state.count) == 0


# -- (4) the entry points without PyYAML -------------------------------------

def _narrowed_text(name, root):
    """The published file's text with its values narrowed in place (the
    same lines, layout and comments)."""
    text = (PORT_PARAMS / f"{name}.yaml").read_text()
    for key, value in (("root", str(root)), ("batch_size", "2"),
                       ("num_workers", "0"), ("max_length", "600"),
                       ("filters", "4"), ("dimension", "16"),
                       ("log_interval", "1"), ("save_every", "1")):
        text, n = re.subn(rf"^(\s+{key}:) .*$", rf"\g<1> {value}", text,
                          flags=re.M)
        assert n == 1, key
    text, n = re.subn(r"^(\s+datasets:\n)(\s+\w+: [0-9.]+\n)+",
                      r"\g<1>    synth: 1.0\n", text, flags=re.M)
    assert n == 1
    return text


def _nights(root, n=4, length=900):
    chan = root / "synth" / "thorax"
    chan.mkdir(parents=True)
    for i in range(n):
        t = np.arange(length) / 10.0
        sig = (np.sin(2 * np.pi * (0.25 + 0.02 * i) * t)
               + 0.1 * np.random.RandomState(80 + i).randn(length))
        np.savez(chan / f"night{i}.npz", data=sig.astype(np.float32), fs=10)


@pytest.fixture(scope="module")
def tokens_run(tmp_path_factory):
    """`python -m encodec_tpu_torch.train --config <narrowed tokens_10s.yaml>
    --max_epochs 1 --device cpu` with PyYAML hidden: one epoch of 2
    batches (the loaders' virtual epochs cut to 4 training items and 2
    for eval), k-means init, eval and save."""
    base = tmp_path_factory.mktemp("tokens")
    _nights(base / "data")
    cfg_path = base / "tokens_10s.yaml"
    cfg_path.write_text(_narrowed_text("tokens_10s", base / "data"))
    build = train_entry.build_dataloaders

    def cut(config, *shard):
        train, val, mapping = build(config, *shard)
        train.dataset.size, val.dataset.size = 4, 2
        return train, val, mapping

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "yaml", None)
        # no TensorBoard writer (its import alone takes seconds)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(train_entry, "build_dataloaders", cut)
        run = base / "run"
        trainer = train_entry.main(["--config", str(cfg_path), "--log_dir",
                                    str(run), "--max_epochs", "1",
                                    "--device", "cpu"])
        again = train_entry.main(["--config", str(cfg_path), "--resume_from",
                                  str(run), "--max_epochs", "1", "--device",
                                  "cpu"])
    return dict(base=base, cfg=cfg_path, run=run, trainer=trainer,
                again=again)


def test_train_main_without_pyyaml_snapshots_json_and_resumes(tokens_run):
    run, trainer = tokens_run["run"], tokens_run["trainer"]
    assert sorted(p.name for p in run.iterdir()
                  if p.name.startswith("config")) == ["config.json"]
    want = yaml.safe_load(tokens_run["cfg"].read_text())
    assert _same(config_to_dict(load_config(str(run / "config.json"))), want)
    assert trainer.model.cfg.seanet.ratios == (5, 5, 4, 1)
    assert trainer.model.cfg.rvq.bins == 1024
    assert trainer.state.qstate.inited            # k-means on batch one
    assert int(trainer.state.opt_state.count) == 2
    again = tokens_run["again"]
    assert again.start_epoch == 2
    _assert_states_equal(again.state, trainer.state)


def test_export_and_inference_read_a_config_yaml_without_pyyaml(
        tokens_run, tmp_path, monkeypatch):
    """A run directory whose snapshot is `config.yaml` (as the JAX trainer
    writes it, `yaml.dump`): `tools.export` and `tools.inference` open it
    with PyYAML hidden; the inference tool reads the port's checkpoint."""
    run = tmp_path / "run"
    shutil.copytree(tokens_run["run"], run)
    config = yaml.safe_load((run / "config.json").read_text())
    (run / "config.json").unlink()
    (run / "config.yaml").write_text(yaml.dump(config))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert export.run_config_path(str(run)).endswith("config.yaml")
    path = export.export_run(str(run), str(tmp_path / "out"), device="cpu")
    assert Path(path).exists() and Path(path).suffix == ".th"
    inference.main(["--config", str(run / "config.yaml"), "--checkpoint",
                    str(run / "model.ckpt"), "--data_root",
                    str(tokens_run["base"] / "data"), "--dataset", "synth",
                    "--out", str(tmp_path / "codes"), "--device", "cpu"])
    files = sorted((tmp_path / "codes" / "thorax").glob("*.npz"))
    assert files
    model = tokens_run["trainer"].model
    for f in files:
        with np.load(f) as z:
            codes = z["codes"]
        assert codes.dtype == np.int32 and codes.shape[0] == model.cfg.rvq.n_q
        assert 0 <= codes.min() and codes.max() < model.cfg.rvq.bins
