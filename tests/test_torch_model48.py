"""The 48 kHz codec (segments, per-segment scale, overlap-add, segmented raw
`.ecdc`, `--hq`): the port against the JAX package on the CPU.

A small 48 kHz-shaped model (stereo, non-causal, `time_group_norm`,
per-segment normalization, 1 s segments with 1% overlap; sample rate 4800,
the 48 kHz strides, n_filters=4, dimension=16, bins=64) is built by the JAX
package with `kmeans_init=False`, exported with `torch_state_from_params`
and loaded by the port's zoo loader. Its bandwidths 0.36 and 2.4 kbps give
4 and 16 stages, as 6 and 24 kbps do on the full-size model.

Segment layouts at this rate (segment 4800 samples, stride 4752), B=2:
one short segment; a full group and a short tail; a length of two strides,
whose shorter last segment has the full group's frame count; and the
irregular layout, where the last two segments are both short (the analogue
of 95,100 samples at 48 kHz).

Tolerances: codes integer-equal; audio 1e-4 (float tolerance of the decoder
stacks); scales within 2 ulp (the per-segment RMS is a float32 reduction
whose summation order each framework picks).
"""

import io
import math
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.torch_zoo import (save_reference_checkpoint,
                                          torch_state_from_params)
from encodec_tpu.stream import compress as jax_compress
from encodec_tpu.stream import decompress as jax_decompress
from encodec_tpu.utils.overlap import linear_overlap_add as jax_overlap_add
from encodec_tpu_torch.models import build_model, load_pretrained, load_state
from encodec_tpu_torch.models import model as model_mod
from encodec_tpu_torch.stream import binary, compress, decompress
from encodec_tpu_torch.utils.overlap import linear_overlap_add, triangle_weight

BANDWIDTHS = [0.36, 2.4]
SR = 4800
SMALL = dict(sample_rate=SR, channels=2, causal=False,
             model_norm="time_group_norm", audio_normalize=True, segment=1.0,
             ratios=[8, 5, 4, 2], bins=64, dimension=16, n_filters=4,
             kmeans_init=False)
LAYOUTS = {
    "single_short": 3000,                 # one 3000-sample segment
    "group_and_tail": 2 * 4752 + 1000,    # 4800, 4800, 1000
    "two_strides": 2 * 4752,              # 4800, 4752 (both 15 frames)
    "irregular": 2 * 4752 + 6,            # 4800, 4758, 6 (tail: 1 frame)
}


def _models(name="unset", seed=0, bandwidths=BANDWIDTHS):
    jm = jax_build_model(bandwidths, name=name, seed=seed, **SMALL)
    tm = build_model(bandwidths, name=name, seed=seed, device="cpu", **SMALL)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch's
    spinning thread pool in each would oversubscribe them (these shapes
    are tiny, so one thread loses nothing)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    return _models()


def _audio(length, B=2, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / SR
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    # the second item is quieter, so per-item scales differ
    gain = np.array([1.0, 0.25])[:B, None, None]
    return (gain * (tone + 0.1 * rng.randn(B, 2, length))).astype(np.float32)


def _ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_triangle_weight_bits_equal_jax():
    for n in (1, 7, 150, 4800, 48000):
        t = jnp.linspace(0, 1, n + 2, dtype=jnp.float32)[1:-1]
        want = np.asarray(0.5 - jnp.abs(t - 0.5))
        np.testing.assert_array_equal(triangle_weight(n), want)


def test_overlap_add_matches_jax():
    rng = np.random.RandomState(1)
    lengths = (40, 40, 13)
    frames = [rng.randn(2, n, 2).astype(np.float32) for n in lengths]
    want = np.asarray(jax_overlap_add([jnp.asarray(f) for f in frames], 37))
    got = linear_overlap_add([torch.from_numpy(f) for f in frames], 37)
    assert got.shape == want.shape == (2, 2 * 37 + 13, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # one frame comes back as itself up to rounding
    one = linear_overlap_add([torch.from_numpy(frames[0])], 37)
    np.testing.assert_allclose(one.numpy(), frames[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bandwidth", BANDWIDTHS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_segmented_codes_scales_audio_match_jax(pair, layout, bandwidth):
    jm, tm = pair
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    length = LAYOUTS[layout]
    x = _audio(length)
    jframes = jm.encode(jnp.asarray(x))
    tframes = tm.encode(x)
    want_lens = [n for _, n in tm.cfg.segments(length)]
    assert len(tframes) == len(jframes) == len(want_lens)
    for (jc, js), (tc, ts), n in zip(jframes, tframes, want_lens):
        assert tc.shape == (2, min(tm.n_q_active, tm.cfg.rvq.n_q),
                            math.ceil(n / 320))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert ts.shape == (2, 1)
        assert _ulps(ts.numpy(), np.asarray(js)) <= 2
    want = np.asarray(jm.decode(jframes))
    got = tm.decode(tframes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batch_rows_are_segment_major(pair):
    """Stacked rows are `s·B + b`: a B=2 encode equals each item's B=1
    encode, segment by segment, and so does its decode."""
    _, tm = pair
    tm.set_target_bandwidth(2.4)
    x = _audio(LAYOUTS["group_and_tail"])
    both = tm.encode(x)
    out = tm.decode(both)
    for b in range(2):
        alone = tm.encode(x[b:b + 1])
        for (cb, sb), (ca, sa) in zip(both, alone):
            assert torch.equal(cb[b:b + 1], ca)
            assert torch.equal(sb[b:b + 1], sa)
        torch.testing.assert_close(out[b:b + 1], tm.decode(alone),
                                   rtol=1e-5, atol=1e-5)


def test_encode_guarded_matches_jax(pair):
    jm, tm = pair
    jm.set_target_bandwidth(2.4)
    tm.set_target_bandwidth(2.4)
    x = _audio(LAYOUTS["irregular"], seed=2)
    jframes, jstats = jm.encode_guarded(jnp.asarray(x))
    tframes, tstats = tm.encode_guarded(x)
    assert len(tframes) == len(jframes) == 3
    for (jc, js), (tc, ts) in zip(jframes, tframes):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert _ulps(ts.numpy(), np.asarray(js)) <= 2
    # three groups (4800, 4758 and 6 samples): positions summed over them
    assert tstats["n_positions"] == jstats["n_positions"] == 2 * (15 + 15 + 1)
    assert tstats["n_flagged"] == jstats["n_flagged"]
    assert tstats["min_margin"] == pytest.approx(jstats["min_margin"],
                                                 rel=1e-3, abs=1e-5)


def _records(data: bytes, model):
    """Split a segmented raw `.ecdc` into (header bytes, [(scale field,
    code bytes) per segment])."""
    fo = io.BytesIO(data)
    meta = binary.read_ecdc_header(fo)
    head = data[:fo.tell()]
    out = []
    for _, n in model.cfg.segments(meta["al"]):
        frames = math.ceil(n * model.frame_rate / model.sample_rate)
        scale = fo.read(4)
        out.append((scale, fo.read((frames * meta["nc"]
                                    * model.bits_per_codebook + 7) // 8)))
    assert fo.read() == b""
    return head, out


@pytest.mark.parametrize("bandwidth", BANDWIDTHS)
def test_segmented_ecdc_contract_and_cross_decode(pair, bandwidth):
    """Header and every code byte identical, each scale field within 2 ulp
    of the JAX writer's, and each package decodes the other's file."""
    jm, tm = pair
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    wav = _audio(LAYOUTS["group_and_tail"], B=1, seed=3)[0]
    jreg = {"unset": lambda pretrained=True: jm}
    treg = {"unset": lambda pretrained=True: tm}
    jbytes = jax_compress(jm, wav, models=jreg)
    tbytes = compress(tm, wav, models=treg)
    assert len(tbytes) == len(jbytes)
    jhead, jrec = _records(jbytes, tm)
    thead, trec = _records(tbytes, tm)
    assert thead == jhead and len(trec) == len(jrec) == 3
    for (js, jc), (ts, tc) in zip(jrec, trec):
        assert tc == jc
        assert _ulps(np.frombuffer(ts, ">f4"), np.frombuffer(js, ">f4")) <= 2
    # the port's writer records the scales it computed, bit for bit
    frames, _ = tm.encode_guarded(torch.from_numpy(wav)[None])
    for (ts, _), (_, scale) in zip(trec, frames):
        assert np.frombuffer(ts, ">f4")[0] == scale.item()
    tw, tsr = decompress(jbytes, models=treg)
    jw, jsr = jax_decompress(tbytes, models=jreg)
    assert tsr == jsr == SR
    assert tuple(tw.shape) == (2, wav.shape[-1])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)


def test_pcm16_wire_format(pair):
    """int16 input encodes to the codes and scales of its float conversion;
    `decode(pcm16=True)` is `save_wav`'s host quantizer of the float decode
    (within 1 LSB at under 1% of samples, the JAX package's contract)."""
    _, tm = pair
    tm.set_target_bandwidth(0.36)
    rng = np.random.RandomState(4)
    pcm = (rng.randn(1, 2, LAYOUTS["group_and_tail"]) * 0.2 * 32767).clip(
        -32768, 32767).astype(np.int16)
    f = pcm.astype(np.float32) / 32768.0
    fr_i = tm.encode(pcm)
    fr_f = tm.encode(f)
    for (ci, si), (cf, sf) in zip(fr_i, fr_f):
        assert torch.equal(ci, cf) and torch.equal(si, sf)
    out_f = tm.decode(fr_f).numpy()
    out_i16 = tm.decode(fr_f, pcm16=True).numpy()
    assert out_i16.dtype == np.int16 and out_i16.shape == out_f.shape
    host = np.trunc(np.clip(out_f, -0.99, 0.99)
                    * np.float32(32767.0)).astype(np.int16)
    diff = np.abs(out_i16.astype(np.int32) - host.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    with pytest.raises(TypeError):
        tm.encode(pcm.astype(np.int32))


def test_48khz_layout_checkpoint_loads(tmp_path, pair):
    jm, tm = pair
    path = save_reference_checkpoint(jm, str(tmp_path), name="encodec_48khz")
    fresh = build_model(BANDWIDTHS, name="unset", seed=7, device="cpu", **SMALL)
    load_pretrained(fresh, path.split("/")[-1], repository=str(tmp_path))
    for a, b in zip(fresh.qstate[:3], tm.qstate[:3]):
        assert torch.equal(a, b)
    got = fresh.params["decoder"]["final_conv"]
    want = tm.params["decoder"]["final_conv"]
    assert set(got) == set(want) == {"w", "b", "norm"}
    for k in ("w", "b"):
        assert torch.equal(got[k], want[k])
    for k in ("scale", "bias"):
        assert torch.equal(got["norm"][k], want["norm"][k])


def test_48khz_factory_config(monkeypatch):
    seen = {}

    def record(**kwargs):
        seen.update(kwargs)
        return "model"

    monkeypatch.setattr(model_mod, "build_model", record)
    assert model_mod.encodec_model_48khz(device="cpu",
                                         kmeans_init=False) == "model"
    assert seen["target_bandwidths"] == (3.0, 6.0, 12.0, 24.0)
    assert (seen["sample_rate"], seen["channels"], seen["causal"]) == (
        48_000, 2, False)
    assert seen["model_norm"] == "time_group_norm"
    assert seen["audio_normalize"] and seen["segment"] == 1.0
    assert (seen["bins"], seen["dimension"], seen["ratios"]) == (
        1024, 128, [8, 5, 4, 2])
    assert model_mod.MODELS["encodec_48khz"] is model_mod.encodec_model_48khz
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.encodec_model_48khz()            # default device is cuda


def _cli(monkeypatch, *argv):
    from encodec_tpu_torch.__main__ import main
    monkeypatch.setattr(sys, "argv", ["encodec_tpu_torch", *argv,
                                      "--device", "cpu"])
    main()


def test_cli_hq_roundtrip(tmp_path, monkeypatch):
    """mono wav → `-q` .ecdc (stereo, segmented, with scales) → wav, in
    process, with the registry's 48 kHz factory replaced by a small model
    serving the 48 kHz bandwidths."""
    from encodec_tpu_torch.utils.audio import load_wav, save_wav

    tm = build_model([3.0, 6.0, 12.0, 24.0], name="encodec_48khz", seed=1,
                     device="cpu", **SMALL)

    def tiny(pretrained=True, repository=None, device="cuda"):
        assert device == "cpu"
        return tm

    monkeypatch.setitem(model_mod.MODELS, "encodec_48khz", tiny)
    save_wav(_audio(7000, B=1, seed=5)[0, :1], tmp_path / "in.wav", SR)
    _cli(monkeypatch, str(tmp_path / "in.wav"), str(tmp_path / "out.ecdc"),
         "-q", "-b", "3")
    data = (tmp_path / "out.ecdc").read_bytes()
    head, recs = _records(data, tm)
    assert binary.read_ecdc_header(io.BytesIO(head))["m"] == "encodec_48khz"
    assert len(recs) == 2 and all(len(s) == 4 for s, _ in recs)
    _cli(monkeypatch, str(tmp_path / "out.ecdc"), str(tmp_path / "out.wav"))
    wav, sr = load_wav(tmp_path / "out.wav")
    assert sr == SR and wav.shape == (2, 7000)
    assert np.isfinite(wav).all()


def test_cli_hq_refuses_1_5_kbps_before_building(tmp_path, monkeypatch):
    from encodec_tpu_torch.utils.audio import save_wav

    def never(**kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setitem(model_mod.MODELS, "encodec_48khz", never)
    save_wav(_audio(1000, B=1)[0], tmp_path / "in.wav", SR)
    with pytest.raises(SystemExit) as exc:
        _cli(monkeypatch, str(tmp_path / "in.wav"), str(tmp_path / "o.ecdc"),
             "--hq", "-b", "1.5")
    assert exc.value.code == 1
    assert not (tmp_path / "o.ecdc").exists()
