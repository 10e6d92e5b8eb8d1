"""LM entropy coding (lmv=3, the integer LM): the port against the JAX
package on the same weights, on the CPU.

The LMs are small (dim 16, 2 heads, 2 layers, window W=20, card 64), drawn
by the JAX package's `init_lm` and carried across with
`lm_params_from_jax`; the codecs are the small 24 kHz- and 48 kHz-shaped
models of `test_torch_model.py` and `test_torch_model48.py`. The
tolerance is zero: LUTs, integer weights, CDF rows, coder bounds and
`.ecdc` bytes must be equal (a segmented file's scale fields excepted,
which may differ by 2 ulp, as for raw files). Audio decoded by the two
packages from the same codes agrees within 1e-4 (the decoder stacks'
float tolerance).
"""

import io
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.models import ilm as jax_ilm
from encodec_tpu.models.lm import LMConfig as JaxLMConfig
from encodec_tpu.models.lm import LMModel as JaxLMModel
from encodec_tpu.models.lm import init_lm as jax_init_lm
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.torch_zoo import (torch_state_from_lm_params,
                                          torch_state_from_params)
from encodec_tpu.stream import compress as jax_compress
from encodec_tpu.stream import decompress as jax_decompress
from encodec_tpu_torch import native
from encodec_tpu_torch.models import build_model, ilm, load_state
from encodec_tpu_torch.models.lm import LMConfig, LMModel, get_lm_model
from encodec_tpu_torch.models.zoo import lm_params_from_jax
from encodec_tpu_torch.stream import binary, compress, decompress
from encodec_tpu_torch.stream.ac import (ArithmeticCoder, ArithmeticDecoder,
                                         encode_bounds)
from encodec_tpu_torch.stream.compress import read_frames

SMALL_LM = dict(n_q=8, card=64, dim=16, num_heads=2, num_layers=2,
                past_context=20)
CODEC_24 = dict(sample_rate=24000, channels=1, causal=True,
                model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
                dimension=16, n_filters=4, kmeans_init=False)
CODEC_48 = dict(sample_rate=4800, channels=2, causal=False,
                model_norm="time_group_norm", audio_normalize=True,
                segment=1.0, ratios=[8, 5, 4, 2], bins=64, dimension=16,
                n_filters=4, kmeans_init=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lm_pair(seed=0, **cfg):
    jcfg = JaxLMConfig(**cfg)
    jlm = JaxLMModel(jcfg, jax_init_lm(jax.random.PRNGKey(seed), jcfg))
    tlm = LMModel(LMConfig(**cfg),
                  lm_params_from_jax(jax.tree.map(np.asarray, jlm.params)),
                  device="cpu")
    return jlm, tlm


@pytest.fixture(scope="module")
def lms():
    return _lm_pair(**SMALL_LM)


@pytest.fixture(scope="module")
def ilms(lms):
    jlm, tlm = lms
    return jax_ilm.IntLMModel.from_lm(jlm), ilm.IntLMModel.from_lm(tlm)


def _codecs(bandwidths, name="unset", **kw):
    jm = jax_build_model(bandwidths, name=name, seed=0, **kw)
    tm = build_model(bandwidths, name=name, seed=0, device="cpu", **kw)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


@pytest.fixture(scope="module")
def codecs24():
    return _codecs([1.5, 3.0, 6.0], **CODEC_24)


@pytest.fixture(scope="module")
def codecs48():
    return _codecs([0.36, 2.4], **CODEC_48)


def _audio(shape, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.1 * rng.randn(*shape)).astype(np.float32)


def test_tables_constants_and_weights_equal_jax(lms):
    def crc(a):
        return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF

    for name in ("exp2_table", "sin_table", "gelu_table", "invsqrt_table"):
        np.testing.assert_array_equal(getattr(ilm, name)(),
                                      getattr(jax_ilm, name)())
    for dim in (16, 200):
        np.testing.assert_array_equal(ilm.pos_phase_steps(dim, 10000.0),
                                      jax_ilm.pos_phase_steps(dim, 10000.0))
        assert ilm.layernorm_consts(dim) == jax_ilm.layernorm_consts(dim)
    for hd in (8, 25):
        assert ilm.qk_scale_const(hd) == jax_ilm.qk_scale_const(hd)
    # the pins of the JAX package's test_table_contract_pins
    assert {"exp2": crc(ilm.exp2_table()), "sin": crc(ilm.sin_table()),
            "gelu": crc(ilm.gelu_table()), "invsqrt": crc(ilm.invsqrt_table()),
            "pos200": crc(ilm.pos_phase_steps(200, 10000.0))} == {
        "exp2": 0xFFC99D30, "sin": 0x8E331FCF, "gelu": 0xB19D4276,
        "invsqrt": 0x7864271F, "pos200": 0x3ACB52E2}
    jlm, tlm = lms
    jparams, jexps = jax_ilm.quantize_lm_params(jlm.params, jlm.cfg)
    tparams, texps = ilm.quantize_lm_params(tlm.params, tlm.cfg)
    assert texps == jexps
    jl, jt = jax.tree_util.tree_flatten(jparams)
    tl, tt = jax.tree_util.tree_flatten(tparams)
    assert jt == tt
    for a, b in zip(tl, jl):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_contractions_exact_at_their_bounds():
    """Every contraction at its extreme operands (all +-MM_CLIP over n=800
    terms; q7 = +-2047 against k = +-16319; a full 2^12 of weight on every
    key against v = +-16319) equals the int64 product."""
    rng = np.random.RandomState(11)
    a = rng.randint(-ilm.MM_CLIP, ilm.MM_CLIP + 1, (4, 800))
    a[0], a[1] = ilm.MM_CLIP, -ilm.MM_CLIP
    w = rng.randint(-127, 128, (800, 6))
    w[:, 0], w[:, 1] = 127, -127
    want = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(want).max() == ilm.MM_CLIP * 127 * 800
    got = ilm._dot_i8(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jax_ilm._dot_i8(jnp.asarray(a, jnp.int32),
                                   jnp.asarray(w, jnp.int8))), want)

    q = rng.choice([-2047, 2047], (2, 3, 5, 25))              # [B, H, T, hd]
    k = rng.choice([-16319, 16319], (2, 3, 25, 781))          # [B, H, hd, S]
    q[0, 0, 0], k[0, 0, :, 0] = 2047, 16319
    want = np.einsum("bhtd,bhds->bhts", q.astype(np.int64), k.astype(np.int64))
    assert np.abs(want).max() == 2047 * 16319 * 25
    np.testing.assert_array_equal(
        ilm._imatmul(torch.from_numpy(q), torch.from_numpy(k)).numpy(), want)

    S = 781
    wts = np.full((2, 3, 5, S), 4096, np.int64)
    wts[1] = rng.randint(0, 4096 // S + 2, (3, 5, S))
    v = rng.choice([-16319, 16319], (2, S, 3, 25))
    v[0] = 16319
    out = np.einsum("bhts,bshd->bthd", wts, v.astype(np.int64))
    want = (out.reshape(2, 5, -1) + (1 << 11)) >> 12
    got = ilm._attention_out(torch.from_numpy(wts), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_rows_equal_jax(ilms):
    """ilm_step over 2W+5 steps at B=2 (past the window's fill and wrap)
    gives JAX's rows bit for bit."""
    jm, tm = ilms
    W = tm.cfg.past_context
    B, K, T = 2, tm.cfg.n_q, 2 * W + 5
    shifted = np.random.RandomState(1).randint(
        0, tm.card + 1, (B, K, T)).astype(np.int32)
    step = jax.jit(lambda p, i, s: jax_ilm.ilm_step(p, jm.exps, i, s, jm.cfg))
    js, ts = jm.init_stream(batch=B), tm.init_stream(batch=B)
    for t in range(T):
        want, js = step(jm.iparams, jnp.asarray(shifted[:, :, t]), js)
        got, ts = tm.step(torch.from_numpy(shifted[:, :, t]), ts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {t}")
    np.testing.assert_array_equal(ts.kcache.numpy(), np.asarray(js.kcache))
    np.testing.assert_array_equal(ts.phase.numpy(), np.asarray(js.phase))
    # a phase offset is `offset` wraparound additions
    steps = ilm.pos_phase_steps(tm.cfg.dim, tm.cfg.max_period)
    np.testing.assert_array_equal(
        tm.init_stream(offset=12345).phase.numpy(),
        (12345 * steps.astype(np.uint64)) % (1 << 32))


def test_chunk_equals_step_scan_splits_and_jax(ilms):
    jm, tm = ilms
    B, K, T = 2, tm.cfg.n_q, 47
    shifted = np.random.RandomState(2).randint(
        0, tm.card + 1, (B, K, T)).astype(np.int32)
    full, _ = tm.chunk_forward(torch.from_numpy(shifted), tm.init_stream(B))
    full = full.numpy()
    want, _ = jm.chunk_exec(B, K, T)(
        jm.iparams, jnp.asarray(shifted),
        jax_ilm.carry_from_state(jm.init_stream(batch=B)))
    np.testing.assert_array_equal(full, np.asarray(want))
    state = tm.init_stream(B)
    for t in range(T):
        rows, state = tm.step(torch.from_numpy(shifted[:, :, t]), state)
        np.testing.assert_array_equal(rows.numpy(), full[:, t])
    for size in (12, 20, 21):
        state, outs = tm.init_stream(B), []
        for lo in range(0, T, size):
            cdf, state = tm.chunk_forward(
                torch.from_numpy(shifted[:, :, lo:lo + size]), state)
            outs.append(cdf.numpy())
        np.testing.assert_array_equal(np.concatenate(outs, 1), full)
    # rows are valid coder CDFs
    assert full[..., -1].max() <= 2 ** 24 and np.diff(full, axis=-1).min() >= 2


def test_codec_symbol_bounds_batched_equal_jax(ilms):
    jm, tm = ilms
    rng = np.random.RandomState(3)
    codes = [rng.randint(0, tm.card, (tm.cfg.n_q, n)).astype(np.int32)
             for n in (30, 17, 5)]
    got = tm.codec_symbol_bounds_batched(codes, 16)          # 2 chunks
    want = jm.codec_symbol_bounds_batched(codes, 16)
    for (gl, gh), (wl, wh) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gh, wh)


def _payload_records(data: bytes, model):
    """(header bytes, metadata, [(scale field, stream bytes)]) of an lmv=3
    file with an 'fl' index."""
    fo = io.BytesIO(data)
    meta = binary.read_ecdc_header(fo)
    head = data[:fo.tell()]
    records = []
    for n in meta["fl"]:
        scale = fo.read(4) if model.normalize else b""
        records.append((scale, fo.read(n)))
    assert fo.read() == b""
    return head, meta, records


@pytest.mark.parametrize("layout", ["single", "blocked", "segments"])
def test_lmv3_files_identical_to_jax_and_cross_decode(lms, codecs24, codecs48,
                                                      layout):
    """The JAX and port writers give the same lmv=3 bytes (a segment's scale
    field within 2 ulp), each package decodes the other's file, the port
    decodes to the writer's codes, and the LM file decodes to the raw
    file's audio."""
    jlm, tlm = lms
    if layout == "segments":
        jm, tm = codecs48
        bandwidth, lm_restart = 0.36, None
        wav = _audio((2, 2 * 4752 + 1000), seed=7)       # 15, 15, 4 frames
    else:
        jm, tm = codecs24
        bandwidth = 6.0
        lm_restart = 7 if layout == "blocked" else None
        wav = _audio((1, 8000), seed=5)                   # 25 frames
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    jreg = {"unset": lambda pretrained=True: jm}
    treg = {"unset": lambda pretrained=True: tm}
    jbytes = jax_compress(jm, wav, use_lm=True, lm=jlm, models=jreg,
                          lm_restart=lm_restart)
    tbytes = compress(tm, wav, use_lm=True, lm=tlm, models=treg,
                      lm_restart=lm_restart)
    meta = binary.read_ecdc_header(io.BytesIO(tbytes))
    assert meta["lmv"] == 3 and "cc" in meta
    if layout == "single":
        assert tbytes == jbytes and "fl" not in meta
    elif layout == "blocked":
        assert tbytes == jbytes
        assert meta["lmb"] == 7 and len(meta["fl"]) == 4    # 25 frames
    else:
        thead, _, trec = _payload_records(tbytes, tm)
        jhead, _, jrec = _payload_records(jbytes, tm)
        assert thead == jhead and len(trec) == 3
        for (ts, tstream), (js, jstream) in zip(trec, jrec):
            assert tstream == jstream
            a, b = (np.frombuffer(s, ">f4").astype(np.float32).view(np.int32)
                    for s in (ts, js))
            assert abs(int(a[0]) - int(b[0])) <= 2
    # the port reads back the codes its writer encoded
    guarded, _ = tm.encode_guarded(torch.from_numpy(wav)[None])
    _, frames, _ = read_frames(io.BytesIO(tbytes), models=treg, lm=tlm)
    assert len(frames) == len(guarded)
    for (got, _), (want, _) in zip(frames, guarded):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # each package decodes the other's file
    tw, tsr = decompress(jbytes, models=treg, lm=tlm)
    jw, jsr = jax_decompress(tbytes, models=jreg, lm=jlm)
    assert tsr == jsr == tm.sample_rate
    assert tuple(tw.shape) == wav.shape
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)
    # same codes as the raw file, so the same audio
    raw, _ = decompress(compress(tm, wav, models=treg), models=treg)
    got, _ = decompress(tbytes, models=treg, lm=tlm)
    np.testing.assert_array_equal(got.numpy(), raw.numpy())


def test_lm_file_refusals(lms, codecs24):
    """A flipped payload byte never yields audio and the cc check refuses
    what decodes; JAX's lmv=2 files and portable=False are refused."""
    jlm, tlm = lms
    jm, tm = codecs24
    jm.set_target_bandwidth(6.0)
    tm.set_target_bandwidth(6.0)
    treg = {"unset": lambda pretrained=True: tm}
    wav = _audio((1, 6000), seed=8)
    data = compress(tm, wav, use_lm=True, lm=tlm, models=treg)
    fo = io.BytesIO(data)
    meta = binary.read_ecdc_header(fo)
    start = fo.tell()
    refused_by_cc = 0
    for frac in (0.25, 0.5, 0.75):
        bad = bytearray(data)
        bad[start + int(frac * (len(data) - start))] ^= 0x10
        with pytest.raises((ValueError, RuntimeError, EOFError)) as err:
            decompress(bytes(bad), models=treg, lm=tlm)
        refused_by_cc += "checksum mismatch" in str(err.value)
    assert refused_by_cc >= 1
    # a header whose cc disagrees with the codes
    head = dict(meta, cc=meta["cc"] ^ 1)
    fo2 = io.BytesIO()
    binary.write_ecdc_header(fo2, head)
    with pytest.raises(ValueError, match="checksum mismatch"):
        decompress(fo2.getvalue() + data[start:], models=treg, lm=tlm)
    # lmv=2: pinned to a JAX executable
    jreg = {"unset": lambda pretrained=True: jm}
    pinned = jax_compress(jm, wav, use_lm=True, lm=jlm, models=jreg,
                          portable=False)
    assert binary.read_ecdc_header(io.BytesIO(pinned))["lmv"] == 2
    with pytest.raises(ValueError, match="lmv=2"):
        decompress(pinned, models=treg, lm=tlm)
    with pytest.raises(ValueError, match="lmv=3"):
        compress(tm, wav, use_lm=True, lm=tlm, models=treg, portable=False)
    with pytest.raises(ValueError, match="lm_restart"):
        compress(tm, wav, models=treg, lm_restart=7)


def test_native_and_python_coders_agree(ilms, monkeypatch):
    """The native coder builds here (g++) and writes and reads the Python
    coder's bitstream bit for bit; without it the Python coder serves."""
    _, tm = ilms
    assert native.available()
    rng = np.random.RandomState(4)
    K, T = tm.cfg.n_q, 60
    codes = rng.randint(0, tm.card, (K, T))
    lows, highs = tm.codec_symbol_bounds(codes)
    buf = io.BytesIO()
    coder = ArithmeticCoder(buf)
    for lo, hi in zip(lows.tolist(), highs.tolist()):
        coder.push_bounds(lo, hi)
    coder.flush()
    data = native.encode_bounds(lows, highs)
    assert data == buf.getvalue()
    shifted = np.zeros((1, K, T), np.int64)
    shifted[0, :, 1:] = 1 + codes[:, :-1]
    rows, _ = tm.chunk_forward(torch.from_numpy(shifted), tm.init_stream())
    rows = rows[0].numpy()                                   # [T, K, card]
    for dec in (native.StreamingDecoder(data),
                ArithmeticDecoder(io.BytesIO(data))):
        got = [[dec.pull(rows[t, k]) for k in range(K)] for t in range(T)]
        np.testing.assert_array_equal(np.asarray(got).T, codes)
    # the lockstep decoder, with the stream cut short; then without the
    # native library
    for native_lib in (True, False):
        if not native_lib:
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", True)
            assert not native.available()
            assert encode_bounds(lows, highs) == data
        np.testing.assert_array_equal(tm.decode_lockstep([data], K, [T])[0],
                                      codes)
        with pytest.raises(EOFError):
            tm.decode_lockstep([data[:len(data) // 2]], K, [T])


def _write_lm_checkpoint(directory, cfg_kw, seed=3):
    """A reference-layout LM `.th` under the 24 kHz LM's published name,
    written from the JAX package's random LM; returns its JAX params."""
    cfg = JaxLMConfig(**cfg_kw)
    params = jax_init_lm(jax.random.PRNGKey(seed), cfg)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in torch_state_from_lm_params(params).items()}
    torch.save(state, directory / "encodec_lm_24khz-1608e3c0.th")
    return params


def test_get_lm_model_reads_local_repository(tmp_path, codecs24):
    _, tm = codecs24
    with pytest.raises(RuntimeError, match="No LM pre-trained"):
        get_lm_model(tm, repository=str(tmp_path))          # named 'unset'
    named = build_model([1.5, 3.0, 6.0], name="encodec_24khz", device="cpu",
                        **CODEC_24)
    cfg_kw = dict(n_q=named.cfg.rvq.n_q, card=64, dim=200, num_layers=5,
                  past_context=262)
    with pytest.raises(RuntimeError, match="--repository"):
        get_lm_model(named)
    params = _write_lm_checkpoint(tmp_path, cfg_kw)
    lm = get_lm_model(named, repository=str(tmp_path))
    assert lm.cfg == LMConfig(**cfg_kw) and lm.device.type == "cpu"
    want = lm_params_from_jax(jax.tree.map(np.asarray, params))
    got_l, got_t = jax.tree_util.tree_flatten(
        jax.tree.map(lambda t: t.numpy(), lm.params))
    want_l, want_t = jax.tree_util.tree_flatten(
        jax.tree.map(lambda t: t.numpy(), want))
    assert got_t == want_t
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(a, b)


def test_cli_lm_roundtrip(tmp_path, monkeypatch):
    """wav → `-l --lm-restart 7` .ecdc → wav through `python -m
    encodec_tpu_torch` on the CPU, the LM read from `--repository`;
    `--lm-pinned` is refused."""
    import encodec_tpu_torch.models.model as model_mod
    from encodec_tpu_torch.__main__ import main
    from encodec_tpu_torch.utils.audio import load_wav, save_wav

    tm = build_model([1.5, 3.0, 6.0], name="encodec_24khz", seed=1,
                     device="cpu", **CODEC_24)

    def tiny(pretrained=True, repository=None, device="cuda"):
        assert device == "cpu"
        return tm

    monkeypatch.setitem(model_mod.MODELS, "encodec_24khz", tiny)
    _write_lm_checkpoint(tmp_path, dict(n_q=tm.cfg.rvq.n_q, card=64, dim=200,
                                        num_layers=5, past_context=262))
    save_wav(_audio((1, 6000), seed=5), tmp_path / "in.wav", 24000)

    def run(*argv):
        monkeypatch.setattr(sys, "argv", ["encodec_tpu_torch", *argv,
                                          "--repository", str(tmp_path),
                                          "--device", "cpu"])
        main()

    run(str(tmp_path / "in.wav"), str(tmp_path / "out.ecdc"), "-b", "6",
        "-l", "--lm-restart", "7")
    data = (tmp_path / "out.ecdc").read_bytes()
    meta = binary.read_ecdc_header(io.BytesIO(data))
    assert meta["lm"] and meta["lmv"] == 3 and meta["lmb"] == 7
    assert len(meta["fl"]) == 3                              # 19 frames
    run(str(tmp_path / "out.ecdc"), str(tmp_path / "out.wav"))
    wav, sr = load_wav(tmp_path / "out.wav")
    assert sr == 24000 and wav.shape == (1, 6000) and np.isfinite(wav).all()
    # the LM-coded file holds the raw file's codes
    run(str(tmp_path / "in.wav"), str(tmp_path / "raw.ecdc"), "-b", "6")
    run(str(tmp_path / "raw.ecdc"), str(tmp_path / "raw.wav"))
    raw, _ = load_wav(tmp_path / "raw.wav")
    np.testing.assert_array_equal(wav, raw)
    with pytest.raises(SystemExit) as exc:
        run(str(tmp_path / "in.wav"), str(tmp_path / "p.ecdc"), "-l",
            "--lm-pinned")
    assert exc.value.code == 1
    assert not (tmp_path / "p.ecdc").exists()
