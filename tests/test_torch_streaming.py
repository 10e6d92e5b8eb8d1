"""Streaming (chunked) encode/decode and the fixed-chunk code extractor: the
port against its own batch path and against the JAX package, on the CPU.

Tiny causal models (the shapes of `tests/test_streaming.py`) are built by the
JAX package with `kmeans_init=False`, exported with `torch_state_from_params`
and loaded by the port's zoo loader; inputs are seeded numpy arrays.

Tolerances: codes integer-equal; streamed encoder latents bit-equal to the
port's batch encoder (the same torch ops on the same values: chunked convs
see their left context, the LSTM carries (h, c)) and within 1e-5 of the JAX
package's (XLA and oneDNN sum in other orders); streamed decoder audio
within rtol 1e-4 / atol 1e-5 of the batch decoder (a transposed conv adds
the carried overlap tail after the chunk's convolution).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu import ops as jops
from encodec_tpu.models import streaming as jstream
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.seanet import SEANetConfig as JaxSEANetConfig
from encodec_tpu.models.torch_zoo import (_lstm_to_torch,
                                          torch_state_from_params)
from encodec_tpu.tools import inference as jinference
from encodec_tpu_torch import ops
from encodec_tpu_torch.models import (StreamingCodec, build_model, load_state,
                                      min_first_chunk, min_first_latent_chunk)
from encodec_tpu_torch.models.seanet import (SEANetConfig, seanet_decoder,
                                             seanet_encoder)
from encodec_tpu_torch.models.streaming import (decoder_stream_step,
                                                encoder_stream_step)
from encodec_tpu_torch.models.zoo import lstm_params_from_state
from encodec_tpu_torch.tools.inference import _StreamExtractor, extract_codes

# the strides of tests/test_streaming.py at a rate whose bandwidths give
# 2 and 6 stages (at 24 kHz these strides leave the quantizer no stage)
TINY = dict(sample_rate=2400, channels=1, causal=True,
            model_norm="weight_norm", name="encodec_24khz",
            ratios=[4, 3, 2, 1], bins=64, dimension=16, n_filters=4,
            kmeans_init=False)
BREATHING = dict(sample_rate=10, channels=1, causal=True,
                 model_norm="layer_norm", name="breathing_model",
                 ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                 decoder_final_norm="none", shared_codebook=True,
                 kmeans_init=False)


def _pair(bandwidths, seed=0, **kw):
    jm = jax_build_model(bandwidths, seed=seed, **kw)
    tm = build_model(bandwidths, seed=seed, device="cpu", **kw)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; tiny shapes lose nothing
    on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jm, tm = _pair([1.5, 6.0], **TINY)
    jm.set_target_bandwidth(6.0)
    tm.set_target_bandwidth(6.0)
    assert tm.cfg.rvq.n_q == 6
    return jm, tm


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _stream(step, params, x, bounds, cfg):
    outs, state = [], None
    for a, b in zip(bounds[:-1], bounds[1:]):
        y, state = step(params, x[:, a:b], state, cfg)
        outs.append(y)
    return outs


def test_encoder_stream_bit_equal_to_batch_and_near_jax(pair):
    jm, tm = pair
    cfg = tm.cfg.seanet
    hop = cfg.hop_length
    x = _randn(0, 2, hop * 30, 1)
    bounds = [0, hop * 12, hop * 21, hop * 30]
    params = tm.infer_params["encoder"]
    batch = seanet_encoder(params, torch.from_numpy(x), cfg)
    streamed = torch.cat(_stream(encoder_stream_step, params,
                                 torch.from_numpy(x), bounds, cfg), dim=1)
    assert torch.equal(streamed, batch)
    want = jnp.concatenate(_stream(jstream.encoder_stream_step,
                                   jm.params["encoder"], jnp.asarray(x),
                                   bounds, jm.cfg.seanet), axis=1)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_decoder_stream_matches_batch_and_jax(pair):
    jm, tm = pair
    cfg = tm.cfg.seanet
    z = _randn(1, 2, 24, cfg.dimension)
    bounds = [0, 10, 17, 24]
    params = tm.infer_params["decoder"]
    batch = seanet_decoder(params, torch.from_numpy(z), cfg)
    streamed = torch.cat(_stream(decoder_stream_step, params,
                                 torch.from_numpy(z), bounds, cfg), dim=1)
    np.testing.assert_allclose(streamed.numpy(), batch.numpy(), rtol=1e-4,
                               atol=1e-5)
    want = jnp.concatenate(_stream(jstream.decoder_stream_step,
                                   jm.params["decoder"], jnp.asarray(z),
                                   bounds, jm.cfg.seanet), axis=1)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_decoder_single_chunk_bit_equal_to_batch():
    """No chunk boundary, no reordered overlap-add: one whole-input chunk
    is the batch decoder bit for bit."""
    _, tm = _pair([1.0], sample_rate=500, channels=1, causal=True,
                  model_norm="weight_norm", name="small", ratios=[5, 4],
                  bins=32, dimension=20, n_filters=4, kmeans_init=False)
    cfg = tm.cfg.seanet
    z = torch.from_numpy(_randn(2, 2, 12, cfg.dimension))
    params = tm.infer_params["decoder"]
    one, _ = decoder_stream_step(params, z, None, cfg)
    assert torch.equal(one, seanet_decoder(params, z, cfg))


def test_streaming_codec_roundtrip_matches_offline_and_jax(pair):
    jm, tm = pair
    hop = tm.cfg.seanet.hop_length
    T = hop * 24
    x = _randn(2, 1, 1, T)
    frames = tm.encode(x)
    offline = frames[0][0].numpy()
    bounds = [0, hop * 10, hop * 18, T]
    codec, jcodec = StreamingCodec(tm), jstream.StreamingCodec(jm)
    codes, audio, jcodes = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        c = codec.encode_chunk(x[:, :, a:b])
        codes.append(c.numpy())
        audio.append(codec.decode_chunk(c).numpy())
        jcodes.append(np.asarray(jcodec.encode_chunk(jnp.asarray(x[:, :, a:b]))))
    codes = np.concatenate(codes, axis=-1)
    np.testing.assert_array_equal(codes, offline)
    np.testing.assert_array_equal(np.concatenate(jcodes, axis=-1), offline)
    np.testing.assert_allclose(np.concatenate(audio, axis=-1),
                               tm.decode(frames).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("r_of_hop", ["1", "7", "hop/2", "hop-1"])
def test_encode_finish_exact_tail(pair, r_of_hop):
    """Chunks plus `encode_finish` on a signal that is not a hop multiple
    give the offline codes, the final partial frame included; the encode
    stream is then finished."""
    _, tm = pair
    hop = tm.cfg.seanet.hop_length
    r = {"1": 1, "7": 7, "hop/2": hop // 2, "hop-1": hop - 1}[r_of_hop]
    x = _randn(40 + r, 1, 1, hop * 20 + r)
    offline = tm.encode(x)[0][0].numpy()
    assert offline.shape[-1] == 21
    codec = StreamingCodec(tm)
    parts = [codec.encode_chunk(x[:, :, :hop * 12]),
             codec.encode_chunk(x[:, :, hop * 12:hop * 20]),
             codec.encode_finish(x[:, :, hop * 20:])]
    np.testing.assert_array_equal(torch.cat(parts, -1).numpy(), offline)
    assert codec._enc_state is None


def test_finish_and_first_latent_chunk_guards(pair):
    _, tm = pair
    cfg = tm.cfg.seanet
    hop = cfg.hop_length
    x = _randn(0, 1, 1, hop * 12)
    codec = StreamingCodec(tm)
    with pytest.raises(ValueError, match="prior encode_chunk"):
        codec.encode_finish(x[:, :, :5])
    codec.encode_chunk(x)
    with pytest.raises(ValueError, match="tail length"):
        codec.encode_finish(x)                 # a whole hop is not a tail
    with pytest.raises(ValueError, match="multiple of the hop"):
        codec.encode_chunk(x[:, :, :hop + 1])
    need = min_first_latent_chunk(cfg)
    params = tm.infer_params["decoder"]
    with pytest.raises(ValueError, match="min_first_latent_chunk"):
        decoder_stream_step(params, torch.from_numpy(
            _randn(2, 1, need - 1, cfg.dimension)), None, cfg)
    decoder_stream_step(params, torch.from_numpy(
        _randn(3, 1, need, cfg.dimension)), None, cfg)


@pytest.mark.parametrize("config", ["tiny", "breathing", "full_24khz"])
def test_min_first_chunks_match_jax(config):
    kw = {"tiny": dict(ratios=(4, 3, 2, 1), dimension=16, n_filters=4,
                       causal=True),
          "breathing": dict(ratios=(5, 2, 1), dimension=16, n_filters=4,
                            causal=True, norm="layer_norm",
                            decoder_final_norm="none"),
          "full_24khz": dict(causal=True)}[config]
    cfg, jcfg = SEANetConfig(**kw), JaxSEANetConfig(**kw)
    assert min_first_chunk(cfg) == jstream.min_first_chunk(jcfg)
    assert min_first_latent_chunk(cfg) == jstream.min_first_latent_chunk(jcfg)
    if config == "full_24khz":
        assert (min_first_chunk(cfg), min_first_latent_chunk(cfg)) == (2240, 7)


def test_breathing_layer_norm_streams():
    """The fork's layer_norm breathing config streams through both the
    encoder and the decoder's per-step norm branch."""
    jm, tm = _pair([0.08], seed=1, **BREATHING)
    cfg = tm.cfg.seanet
    hop = cfg.hop_length
    x = _randn(3, 1, hop * 50, 1)
    bounds = [0, hop * 25, hop * 50]
    enc = tm.infer_params["encoder"]
    streamed = torch.cat(_stream(encoder_stream_step, enc,
                                 torch.from_numpy(x), bounds, cfg), dim=1)
    np.testing.assert_allclose(
        streamed.numpy(), seanet_encoder(enc, torch.from_numpy(x), cfg).numpy(),
        rtol=1e-4, atol=1e-5)
    want = jnp.concatenate(_stream(jstream.encoder_stream_step,
                                   jm.params["encoder"], jnp.asarray(x),
                                   bounds, jm.cfg.seanet), axis=1)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    dec = tm.infer_params["decoder"]
    z = _randn(4, 1, 30, cfg.dimension)
    zb = [0, 15, 30]
    audio = torch.cat(_stream(decoder_stream_step, dec, torch.from_numpy(z),
                              zb, cfg), dim=1)
    np.testing.assert_allclose(
        audio.numpy(), seanet_decoder(dec, torch.from_numpy(z), cfg).numpy(),
        rtol=1e-4, atol=1e-5)


def test_lstm_state_chunks_bit_equal_and_match_jax():
    pj = jops.init_lstm(jax.random.PRNGKey(5), 12, num_layers=2)
    sd = {}
    _lstm_to_torch(pj, "l.", sd)
    pt = lstm_params_from_state(sd, "l.", 2)
    x = _randn(7, 2, 20, 12)
    h0, c0 = 0.5 * _randn(8, 2, 2, 12), 0.5 * _randn(9, 2, 2, 12)
    state = (torch.from_numpy(h0), torch.from_numpy(c0))
    whole, (hT, cT) = ops.lstm(pt, torch.from_numpy(x), state=state,
                               return_state=True)
    # each chunk contiguous, as a stream's chunks are (a strided view would
    # take the input projection through another matmul kernel)
    ys, st = [], state
    for a, b in ((0, 7), (7, 13), (13, 19), (19, 20)):
        y, st = ops.lstm(pt, torch.from_numpy(x[:, a:b].copy()), state=st,
                         return_state=True)
        ys.append(y)
    assert torch.equal(torch.cat(ys, 1), whole)
    assert torch.equal(st[0], hT) and torch.equal(st[1], cT)
    yj, (hj, cj) = jops.lstm(pj, jnp.asarray(x), skip=True,
                             state=(jnp.asarray(h0), jnp.asarray(c0)),
                             return_state=True)
    for got, want in ((whole, yj), (hT, hj), (cT, cj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# signal lengths in hops + samples, per chunk size: the remainder ladder,
# tails of 1 and hop-1 samples, non-power-of-two chunks whose remainders
# the ladder must still cover, a hop multiple (zero-padded path) and a
# signal shorter than one chunk (offline fallback)
EXTRACT_CASES = [(8, 8, 0), (8, 8, 1), (8, 13, 7), (8, 21, -1), (8, 9, 8),
                 (8, 5, 3), (12, 14, 3), (12, 17, 3), (12, 20, 3),
                 (12, 23, 3)]


@pytest.mark.parametrize("chunk_hops,hops,extra", EXTRACT_CASES)
def test_stream_extractor_matches_offline_and_jax(pair, chunk_hops, hops,
                                                  extra):
    jm, tm = pair
    hop = tm.cfg.seanet.hop_length
    T = hop * hops + (extra if extra >= 0 else hop + extra)
    x = _randn(hops * 31 + extra, 1, T)
    got = _StreamExtractor(tm, chunk_hops=chunk_hops)(x)
    want = extract_codes(tm, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jinference._StreamExtractor(jm, chunk_hops=chunk_hops)(x))


def test_stream_extractor_zero_padded_tail(pair):
    """`exact_tail=False`: every fully covered frame exact; only the final
    partial frame may differ (zero vs reflect tail padding)."""
    _, tm = pair
    hop = tm.cfg.seanet.hop_length
    x = _randn(5, 1, hop * 21 + 7)
    got = _StreamExtractor(tm, chunk_hops=16, exact_tail=False)(x)
    want = extract_codes(tm, x)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])


def test_stream_extractor_guards(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="min_first_chunk"):
        _StreamExtractor(tm, chunk_hops=1)
    norm = build_model([1.5], device="cpu", audio_normalize=True, **TINY)
    with pytest.raises(ValueError, match="normalize"):
        _StreamExtractor(norm, chunk_hops=64)


def test_lstm_scan_state_arguments():
    """The K3 wrapper's state arguments on the CPU (its plain twin): the
    recurrence from (h0, c0) with the final state, and refusals."""
    from encodec_tpu_torch.kernels import lstm_scan
    from encodec_tpu_torch.kernels.lstm_cuda import lstm_recurrence
    xp = torch.from_numpy(_randn(10, 3, 9, 4 * 6))
    w = torch.from_numpy(0.3 * _randn(11, 4 * 6, 6))
    h0, c0 = (torch.from_numpy(_randn(s, 3, 6)) for s in (12, 13))
    out, hT, cT = lstm_scan(xp, w, h0, c0, return_state=True)
    want = lstm_recurrence(xp, w, h0, c0)
    for got, ref in zip((out, hT, cT), want):
        assert torch.equal(got, ref)
    assert torch.equal(hT, out[:, -1])
    zero = torch.zeros(3, 6)
    assert torch.equal(lstm_scan(xp, w, zero, zero), lstm_scan(xp, w))
    with pytest.raises(ValueError, match="both h0 and c0"):
        lstm_scan(xp, w, h0)
    with pytest.raises(ValueError, match=r"\[B, H\]"):
        lstm_scan(xp, w, h0[:2], c0[:2])
