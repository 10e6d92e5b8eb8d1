"""The 24 kHz slice end to end: the port against the JAX package on the same
weights and audio, on the CPU.

A small 24 kHz-shaped model (n_filters=4, dimension=16, bins=64, the 24 kHz
strides, LSTM, weight norm, causal) is built by the JAX package with
`kmeans_init=False` (uniform books; the default all-zero books would make
every code 0), exported with `torch_state_from_params` and loaded by the
port's zoo loader.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.seanet import seanet_encoder as jax_seanet_encoder
from encodec_tpu.models.torch_zoo import (save_reference_checkpoint,
                                          torch_state_from_params)
from encodec_tpu.stream import compress as jax_compress
from encodec_tpu.stream import decompress as jax_decompress
from encodec_tpu_torch.models import build_model, load_pretrained, load_state
from encodec_tpu_torch.models.seanet import seanet_encoder
from encodec_tpu_torch.stream import compress, decompress

BANDWIDTHS = [1.5, 3.0, 6.0, 12.0, 24.0]
SMALL = dict(sample_rate=24000, channels=1, causal=True,
             model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
             dimension=16, n_filters=4, kmeans_init=False)


def _models(name="unset", seed=0):
    jm = jax_build_model(BANDWIDTHS, name=name, seed=seed, **SMALL)
    tm = build_model(BANDWIDTHS, name=name, seed=seed, device="cpu", **SMALL)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _models()


def _audio(B=2, T=4800, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 24000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return (tone + 0.1 * rng.randn(B, 1, T)).astype(np.float32)


def test_latents_match_jax(pair):
    jm, tm = pair
    x = _audio()
    want = jax_seanet_encoder(jm.params["encoder"],
                              jnp.asarray(x.transpose(0, 2, 1)),
                              jm.cfg.seanet,
                              precision=jax.lax.Precision.HIGHEST)
    got = seanet_encoder(tm.infer_params["encoder"],
                         torch.from_numpy(x).transpose(1, 2), tm.cfg.seanet)
    # conv + LSTM stacks summed in different orders by XLA and oneDNN
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bandwidth", BANDWIDTHS)
def test_codes_and_audio_match_jax(pair, bandwidth):
    """Codes integer-equal at every served bandwidth (the random books'
    margins here sit far above the ~1e-6 latent drift); decoded audio
    within 1e-4 (float tolerance of the decoder stacks)."""
    jm, tm = pair
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    x = _audio()
    jframes = jm.encode(jnp.asarray(x))
    tframes = tm.encode(x)
    assert len(tframes) == 1 and tframes[0][1] is None
    np.testing.assert_array_equal(tframes[0][0].numpy(),
                                  np.asarray(jframes[0][0]))
    jg, jstats = jm.encode_guarded(jnp.asarray(x))
    tg, tstats = tm.encode_guarded(x)
    np.testing.assert_array_equal(tg[0][0].numpy(), np.asarray(jg[0][0]))
    assert tstats["n_positions"] == jstats["n_positions"]
    want = np.asarray(jm.decode(jframes))
    got = tm.decode(tframes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bandwidth", [1.5, 24.0])
def test_ecdc_bytes_identical_and_cross_decode(pair, bandwidth):
    jm, tm = pair
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    wav = _audio(B=1, T=5000, seed=3)[0]
    jreg = {"unset": lambda pretrained=True: jm}
    treg = {"unset": lambda pretrained=True: tm}
    jbytes = jax_compress(jm, wav, models=jreg)
    tbytes = compress(tm, wav, models=treg)
    assert tbytes == jbytes
    # each package decodes the other's file
    tw, tsr = decompress(jbytes, models=treg)
    jw, jsr = jax_decompress(tbytes, models=jreg)
    assert tsr == jsr == 24000
    assert tuple(tw.shape) == (1, 5000)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)


def test_ecdc_rejects_lm_and_unknown_models(pair):
    _, tm = pair
    tm.set_target_bandwidth(6.0)
    wav = _audio(B=1, T=2000)[0]
    treg = {"unset": lambda pretrained=True: tm}
    # no LM is published for this model, and none was passed
    with pytest.raises(RuntimeError, match="No LM pre-trained"):
        compress(tm, wav, use_lm=True, models=treg)
    with pytest.raises(ValueError):
        compress(tm, wav, models={"other": None})
    data = compress(tm, wav, models=treg)
    with pytest.raises(ValueError):
        decompress(b"XXXX" + data[4:], models=treg)
    with pytest.raises(EOFError):
        decompress(data[:-5], models=treg)


def test_load_pretrained_checks_sha(tmp_path, pair):
    jm, tm = pair
    path = save_reference_checkpoint(jm, str(tmp_path), name="tiny")
    fresh = build_model(BANDWIDTHS, name="unset", seed=7, device="cpu", **SMALL)
    load_pretrained(fresh, path.split("/")[-1], repository=str(tmp_path))
    for a, b in zip(fresh.qstate[:3], tm.qstate[:3]):
        assert torch.equal(a, b)
    w = fresh.params["encoder"]["init_conv"]["v"]
    assert torch.equal(w, tm.params["encoder"]["init_conv"]["v"])
    bad = tmp_path / "tiny-00000000.th"
    bad.write_bytes(open(path, "rb").read())
    with pytest.raises(RuntimeError, match="checksum"):
        load_pretrained(fresh, bad.name, repository=str(tmp_path))
    with pytest.raises(RuntimeError, match="repository"):
        load_pretrained(fresh, bad.name)


def test_cli_roundtrip(tmp_path, monkeypatch):
    """wav → .ecdc → wav through `python -m encodec_tpu_torch` (in process)
    with the registry's 24 kHz factory replaced by the small model."""
    import encodec_tpu_torch.models.model as model_mod
    from encodec_tpu_torch.__main__ import main
    from encodec_tpu_torch.utils.audio import load_wav, save_wav

    _, tm = _models(name="encodec_24khz", seed=1)

    def tiny(pretrained=True, repository=None, device="cuda"):
        assert device == "cpu"
        return tm

    monkeypatch.setitem(model_mod.MODELS, "encodec_24khz", tiny)
    save_wav(_audio(B=1, T=6000, seed=5)[0], tmp_path / "in.wav", 24000)

    def run(*argv):
        monkeypatch.setattr(sys, "argv", ["encodec_tpu_torch", *argv,
                                          "--device", "cpu"])
        main()

    run(str(tmp_path / "in.wav"), str(tmp_path / "out.ecdc"), "-b", "6")
    assert (tmp_path / "out.ecdc").read_bytes()[:4] == b"ECDC"
    run(str(tmp_path / "out.ecdc"), str(tmp_path / "out.wav"))
    wav, sr = load_wav(tmp_path / "out.wav")
    assert sr == 24000 and wav.shape == (1, 6000)
    assert np.isfinite(wav).all()
