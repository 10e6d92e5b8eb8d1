"""The reduced-precision modes of the port, on the CPU.

bf16 training compute (`make_train_steps(compute_dtype=torch.bfloat16)`,
`common.compute_dtype: bfloat16`) and `EncodecModel.set_precision`
('highest', 'high', 'fast') with the `.ecdc` writer's rules for them.

- The port's versions of JAX's two bf16 tests, with JAX's bounds
  (`tests/test_train.py::test_mixed_precision_bf16_training_converges`:
  40 steps converge below 0.9 of the first loss, masters stay float32, the
  last loss within rtol 0.35 of the float32 run's;
  `::test_gan_steps_bf16_disc`: the GAN terms and the discriminator's loss
  within rtol 0.1 of float32), the latter by each of the three GAN routes.
- One bf16 `forward_train` of the port against JAX's bf16 `forward_train`
  on the same weights: TINY's model with weight norm in place of layer
  norm (the layer norm over 4 channels amplifies bf16's rounding: there
  each package's bf16 x̂ lies 25-38% RMS from its own float32 x̂, measured,
  so the two packages' bf16 outputs differ as much). Both round every
  conv's output to bf16 (a relative step of 2^-8 = 3.9e-3), each summing
  in its own order. Held: x̂ within `BF16_XHAT_RMS` = 1.5e-2 RMS and
  `BF16_XHAT_MAX` = 3e-2 max of JAX's (measured 4.5e-3 and 1.1e-2), the
  commit losses within rtol `BF16_COMMIT` = 1e-2 (measured 3.8e-3), at
  least 98% of the codes equal (measured 99.9%). A float32 port would pass
  those bounds too (3.9e-3 RMS from JAX's bf16 x̂, measured: the two
  packages round independently, and the float32 output lies between
  them), so x̂ must also lie at least `BF16_XHAT_MIN_RMS` = 1e-3 RMS from
  JAX's float32 x̂ (measured 4.7e-3; a float32 port 2.4e-7).
- The float32 path: `compute_dtype` None, torch.float32 and "float32"
  give the same bits, and every cast of the float32 path is the identity
  (the weights and the norms' inputs are the very tensors they were).
- The cast points: the encoder and decoder trunks get bf16 inside the
  step, the LSTM kernel's wrapper and its backward get float32, the RVQ
  gets float32 latents, norm statistics are float32, the discriminator's
  logits float32 and its feature maps bf16.
- `set_precision`: the writer refuses 'high' and 'fast', guarded or not
  and with the caller's codes (the card's audit found no guard threshold
  that certifies either), and writes at 'highest' through the guard at
  1e-3; the streaming codec follows the mode; invalid modes raise; the
  TF32 flags are restored after a call, an exception included.
"""

import importlib
import io

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.model import forward_train as jax_forward_train
from encodec_tpu_torch import device as tdevice
from encodec_tpu_torch import ops
from encodec_tpu_torch.models import (MSSTFTConfig, StreamingCodec,
                                      build_model, msstftd, params_from_jax)
from encodec_tpu_torch.models import model as tmodel
from encodec_tpu_torch.stream import compress, decompress
from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                     make_train_steps)
from encodec_tpu_torch.train.optim import tree_leaves
from tests.test_torch_train import FL, TINY, _batch, _np

cmod = importlib.import_module("encodec_tpu_torch.stream.compress")
tlstm = importlib.import_module("encodec_tpu_torch.ops.lstm")

BF16_XHAT_RMS = 1.5e-2
BF16_XHAT_MAX = 3e-2
BF16_XHAT_MIN_RMS = 1e-3
BF16_COMMIT = 1e-2
DISC = dict(filters=2, n_ffts=(64, 32), hop_lengths=(16, 8),
            win_lengths=(64, 32))
# JAX's tests/test_train.py::tiny_setup model (80 stages of one shared book)
JAX_TINY = dict(sample_rate=10, channels=1, causal=True,
                model_norm="layer_norm", name="breathing_model",
                ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                decoder_final_norm="none", shared_codebook=True)
SMALL24 = dict(sample_rate=24000, channels=1, causal=True,
               model_norm="weight_norm", name="encodec_24khz",
               ratios=[8, 5, 4, 2], bins=64, dimension=16, n_filters=4,
               kmeans_init=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(seed=0, B=4, T=600):
    return torch.from_numpy(_batch(seed, B=B, T=T))


# ---------------------------------------------------------------------------
# bf16 training compute
# ---------------------------------------------------------------------------

def test_mixed_precision_bf16_training_converges():
    """compute_dtype=bf16: conv trunks in bf16, float32 masters and losses;
    the tiny fit converges like the float32 one (JAX's test and bounds)."""
    model = build_model([0.8], device="cpu", **JAX_TINY)
    batch = _x(1, B=8)
    weights = LossWeights.make(lr=1e-3)

    def run(compute_dtype):
        state = create_train_state(model, None, seed=0)
        gen_step, *_ = make_train_steps(model.cfg, None, freq_loss_kwargs=FL,
                                        compute_dtype=compute_dtype)
        losses = []
        for _ in range(40):
            state, m = gen_step(state, batch, weights, use_gan=False)
            losses.append(float(m["loss"]))
        return state, losses

    state16, losses16 = run(torch.bfloat16)
    _, losses32 = run(None)
    assert all(np.isfinite(losses16))
    assert losses16[-1] < losses16[0] * 0.9
    assert all(t.dtype == torch.float32 for t in tree_leaves(
        (state16.params, state16.opt_state.mu, state16.opt_state.nu)))
    assert losses16[-1] < losses32[0]
    np.testing.assert_allclose(losses16[-1], losses32[-1], rtol=0.35)


@pytest.fixture(scope="module")
def gan_setup():
    model = build_model([0.8], device="cpu", **JAX_TINY)
    state = create_train_state(model, MSSTFTConfig(**DISC), seed=0)
    return model, state


@pytest.mark.parametrize("route", ["remat", "chunked", "plain"])
def test_gan_steps_bf16_disc(gan_setup, route):
    """The GAN phase with the discriminator's conv stack in bf16 (float32
    STFT, logits and sums), by each route (JAX's test takes `disc_remat`):
    the steps are finite and the GAN terms and the discriminator's loss
    within rtol 0.1 of float32's."""
    model, state = gan_setup
    disc = MSSTFTConfig(**DISC, time_chunk=7 if route == "chunked" else None)
    kw = dict(freq_loss_kwargs=FL, disc_remat=route == "remat")
    gen16, disc16, _, _ = make_train_steps(model.cfg, disc,
                                           compute_dtype=torch.bfloat16, **kw)
    gen32, disc32, _, _ = make_train_steps(model.cfg, disc, **kw)
    weights = LossWeights.make(lr=1e-3, disc_lr=1e-3)
    batch = _x(9)
    s1, m = gen16(state, batch, weights, use_gan=True)
    _, m32 = gen32(state, batch, weights, use_gan=True)
    assert np.isfinite(float(m["loss"]))
    for k in ("loss_feat", "loss_gen"):
        np.testing.assert_allclose(float(m[k]), float(m32[k]), rtol=0.1)
    _, dm = disc16(s1, batch, weights)
    _, dm32 = disc32(s1, batch, weights)
    assert np.isfinite(float(dm["loss_disc"]))
    np.testing.assert_allclose(float(dm["loss_disc"]),
                               float(dm32["loss_disc"]), rtol=0.1)
    assert all(t.dtype == torch.float32
               for t in tree_leaves(s1.disc_params))


def test_bf16_forward_train_matches_jax():
    """One bf16 training forward (k-means off: the uniform books, every
    cluster at 50 so nothing expires) of the port against JAX's on the
    same weights and input, at the tolerances of the module's docstring."""
    tiny = dict(TINY, model_norm="weight_norm")
    jm = jax_build_model([0.08], seed=3, **tiny)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **tiny)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    x = _batch(5)
    jx, jcodes, jcommit, _ = jax_forward_train(
        jm.params, jm.qstate, jnp.asarray(x), jm.cfg, jm.cfg.rvq.n_q,
        jax.random.PRNGKey(0), compute_dtype=jnp.bfloat16)
    jx32 = np.asarray(jax_forward_train(
        jm.params, jm.qstate, jnp.asarray(x), jm.cfg, jm.cfg.rvq.n_q,
        jax.random.PRNGKey(0))[0])
    tx, tcodes, tcommit, _ = tmodel.forward_train(
        tm.params, tm.qstate, torch.from_numpy(x), tm.cfg, tm.cfg.rvq.n_q,
        torch.Generator().manual_seed(0), compute_dtype=torch.bfloat16)
    assert tx.dtype == torch.float32 and tcommit.dtype == torch.float32
    jx = np.asarray(jx)
    d = tx.detach().numpy() - jx
    rms = float(np.sqrt((d ** 2).mean() / (jx ** 2).mean()))
    assert rms <= BF16_XHAT_RMS, rms
    d32 = tx.detach().numpy() - jx32
    rms32 = float(np.sqrt((d32 ** 2).mean() / (jx32 ** 2).mean()))
    assert rms32 >= BF16_XHAT_MIN_RMS, rms32     # the trunks ran in bf16
    assert float(np.abs(d).max() / np.abs(jx).max()) <= BF16_XHAT_MAX
    np.testing.assert_allclose(tcommit.detach().numpy(), np.asarray(jcommit),
                               rtol=BF16_COMMIT)
    same = float((tcodes.numpy() == np.asarray(jcodes)).mean())
    assert same >= 0.98, same


# ---------------------------------------------------------------------------
# The float32 path and the cast points
# ---------------------------------------------------------------------------

def test_float32_path_is_unchanged():
    """`compute_dtype` None, torch.float32 and "float32" are one step to
    the bit, and the float32 path's casts return the tensors they got."""
    model = build_model([0.08], seed=3, device="cpu", **TINY)
    state = create_train_state(model, MSSTFTConfig(**DISC), seed=0)
    weights = LossWeights.make(lr=1e-3, disc_lr=1e-3)
    batch = _x(11, B=2)
    outs = []
    for dt in (None, torch.float32, "float32"):
        gen, disc, _, _ = make_train_steps(model.cfg, MSSTFTConfig(**DISC),
                                           freq_loss_kwargs=FL,
                                           compute_dtype=dt)
        s, m = gen(state, batch, weights, use_gan=True)
        _, dm = disc(s, batch, weights)
        outs.append(tree_leaves((s.params, s.opt_state.mu,
                                 tuple(s.qstate[:3]))) +
                    [m["loss"], dm["loss_disc"]])
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))
    p = model.infer_params["encoder"]["init_conv"]
    x = torch.randn(1, 10, 1)
    w, b = ops.conv.conv_weights(p, x)
    assert w is p["w"] and b is p["b"]
    y = torch.randn(2, 4, 9)
    assert y.float() is y
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_steps(model.cfg, None, compute_dtype=torch.float16)


def test_bf16_cast_points(monkeypatch):
    """Under bf16: the encoder and decoder trunks get bf16, K3's wrapper
    (saving forward) and its backward get float32, the RVQ gets float32
    latents, convs compute in bf16 with the norms' statistics in float32,
    the discriminator returns float32 logits beside bf16 feature maps, and
    the step's gradients are float32."""
    seen = {"scan": [], "bwd": [], "rvq": [], "trunks": []}
    scan, bwd, rvq_fwd = tlstm.lstm_scan, tlstm.lstm_scan_backward, \
        tmodel.rvq_forward
    enc, dec = tmodel.seanet_encoder, tmodel.seanet_decoder

    def spy_scan(xp, w_hh, *a, **k):
        seen["scan"].append((xp.dtype, w_hh.dtype))
        return scan(xp, w_hh, *a, **k)

    def spy_bwd(pre, c_seq, d_out, w_hh, *a, **k):
        seen["bwd"].append((pre.dtype, d_out.dtype, w_hh.dtype))
        return bwd(pre, c_seq, d_out, w_hh, *a, **k)

    def spy_rvq(state, x, *a, **k):
        seen["rvq"].append(x.dtype)
        return rvq_fwd(state, x, *a, **k)

    monkeypatch.setattr(tlstm, "lstm_scan", spy_scan)
    monkeypatch.setattr(tlstm, "lstm_scan_backward", spy_bwd)
    monkeypatch.setattr(tlstm, "lstm_scan_plain", spy_scan)
    monkeypatch.setattr(tlstm, "lstm_scan_backward_plain", spy_bwd)
    def spy_trunk(fn):
        def call(params, x, *a, **k):
            seen["trunks"].append(x.dtype)
            return fn(params, x, *a, **k)
        return call

    monkeypatch.setattr(tmodel, "rvq_forward", spy_rvq)
    monkeypatch.setattr(tmodel, "seanet_encoder", spy_trunk(enc))
    monkeypatch.setattr(tmodel, "seanet_decoder", spy_trunk(dec))
    model = build_model([0.08], seed=3, device="cpu", **TINY)
    state = create_train_state(model, None, seed=0)
    gen, *_ = make_train_steps(model.cfg, None, freq_loss_kwargs=FL,
                               compute_dtype=torch.bfloat16)
    _, m = gen(state, _x(2, B=2), LossWeights.make(), keep_grads=True)
    f32 = torch.float32
    assert seen["scan"] and all(d == (f32, f32) for d in seen["scan"])
    assert seen["bwd"] and all(d == (f32,) * 3 for d in seen["bwd"])
    assert seen["rvq"] == [f32]
    assert seen["trunks"] == [torch.bfloat16] * 2
    assert all(g.dtype == f32 for g in tree_leaves(m["grads"]))
    # norms: float32 statistics, the result cast back
    x = torch.randn(2, 7, 6).to(torch.bfloat16)
    scale, bias = torch.rand(6), torch.rand(6)
    for fn in (ops.layer_norm, ops.time_group_norm):
        got = fn(x, scale, bias)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, fn(x.float(), scale, bias).to(torch.bfloat16))
    # a conv in bf16 from float32 masters; the LSTM returns the input dtype
    p = model.params["encoder"]["init_conv"]
    y = ops.sconv1d(p, x[..., :1], kernel_size=7, causal=True,
                    norm="layer_norm")
    assert y.dtype == torch.bfloat16 and p["w"].dtype == f32
    # the discriminator: float32 logits, bf16 feature maps
    disc_cfg = MSSTFTConfig(**DISC)
    dparams = msstftd.init_msstftd(torch.Generator().manual_seed(0),
                                   disc_cfg)
    logits, fmaps = msstftd.msstftd_forward(dparams, _x(1, B=1), disc_cfg,
                                            compute_dtype=torch.bfloat16)
    assert all(lg.dtype == f32 for lg in logits)
    assert all(f.dtype == torch.bfloat16 for fm in fmaps for f in fm)
    sums = msstftd.msstftd_gan_sums_chunked(
        dparams["discs"][0], _x(1, B=1), _x(2, B=1), disc_cfg, 0, chunk=7,
        compute_dtype=torch.bfloat16)
    assert all(v.dtype == f32 for v in sums.values())


# ---------------------------------------------------------------------------
# set_precision and the writer
# ---------------------------------------------------------------------------

def _model24(seed=0):
    m = build_model([1.5, 3.0], seed=seed, device="cpu", **SMALL24)
    m.set_target_bandwidth(1.5)
    return m, {m.name: (lambda pretrained=True: m)}


def _wav(seed, n):
    return (np.random.RandomState(seed).randn(1, n).astype(np.float32)
            * 0.3)


def test_compress_precision_guard():
    """`.ecdc` writing refuses set_precision('fast') and 'high' (the
    card's audit certified neither), and 'highest' writes after."""
    model, reg = _model24(seed=1)
    wav = _wav(3, 640)
    try:
        for mode in ("fast", "high"):
            model.set_precision(mode)
            with pytest.raises(RuntimeError, match=r"refusing to write "
                               rf"\.ecdc at set_precision\('{mode}'\)"):
                compress(model, wav, models=reg)
    finally:
        model.set_precision("highest")
    assert compress(model, wav, models=reg)


@pytest.mark.parametrize("source", ["guarded", "unguarded", "frames"])
def test_writer_refuses_high(source, monkeypatch):
    """At 'high' the writer refuses before it encodes, whatever the codes'
    source (the guard, the plain encode, the caller's frames), quoting the
    audit that found no certifying threshold; at 'highest' the same call
    writes, through the guard at 1e-3 by default."""
    m, reg = _model24(seed=9)
    wav = _wav(10, 3200)
    frames = m.encode(torch.from_numpy(wav[None]))
    kw = {"guarded": {}, "unguarded": {"tie_guard": False},
          "frames": {"frames": frames}}[source]
    calls = []
    for name in ("encode", "encode_guarded"):
        orig = getattr(type(m), name)

        def spy(self, x, *a, _orig=orig, _name=name, **k):
            calls.append((_name, k.get("threshold")))
            return _orig(self, x, *a, **k)
        monkeypatch.setattr(type(m), name, spy)
    def write():
        fo = io.BytesIO()
        cmod.compress_to_file(m, wav, fo, models=reg, **kw)
        return fo.getvalue()

    m.set_precision("high")
    try:
        with pytest.raises(RuntimeError, match=r"set_precision\('high'\): "
                           r"TF32 .* 42 of 1,515 positions"):
            write()
    finally:
        m.set_precision("highest")
    assert calls == []
    data = write()
    assert calls == {"guarded": [("encode_guarded", cmod.GUARD_THRESHOLD)],
                     "unguarded": [("encode", None)], "frames": []}[source]
    assert cmod.GUARD_THRESHOLD == 1e-3
    out, sr = decompress(data, models=reg, device="cpu")
    assert sr == m.sample_rate and out.shape == (1, wav.shape[-1])


def test_streaming_codec_follows_set_precision(monkeypatch):
    """The codec runs each chunk in the model's mode at that call: at
    'high' its streamed codes equal the offline ones, and at 'fast' its
    encoder and decoder trunks get bf16, as the offline calls do."""
    model, _ = _model24(seed=2)
    hop = model.cfg.seanet.hop_length
    x = torch.from_numpy(_wav(11, hop * 24)[None])
    try:
        model.set_precision("high")
        offline = model.encode(x)[0][0]
        codec = StreamingCodec(model)
        streamed = torch.cat([codec.encode_chunk(x[:, :, :hop * 12]),
                              codec.encode_chunk(x[:, :, hop * 12:])], -1)
        assert torch.equal(streamed, offline)
        import encodec_tpu_torch.models.streaming as smod
        dtypes = []
        for name in ("encoder_stream_step", "decoder_stream_step"):
            orig = getattr(smod, name)

            def spy(params, y, *a, orig=orig, **k):
                dtypes.append(y.dtype)
                return orig(params, y, *a, **k)
            monkeypatch.setattr(smod, name, spy)
        model.set_precision("fast")
        codec = StreamingCodec(model)
        codes = codec.encode_chunk(x[:, :, :hop * 12])
        audio = codec.decode_chunk(codes)
        assert dtypes == [torch.bfloat16, torch.bfloat16]
        assert audio.dtype == torch.float32 and torch.isfinite(audio).all()
    finally:
        model.set_precision("highest")


def test_invalid_modes_and_flags_restored():
    """Unknown modes raise; a model call at 'high' leaves both TF32 flags
    as they were, also when the call raises, and reading the flags after
    it raises no mixed-API error."""
    model, _ = _model24(seed=4)
    with pytest.raises(ValueError, match="precision mode"):
        model.set_precision("medium")
    with pytest.raises(ValueError, match="precision mode"):
        with tdevice.precision_scope("bf16"):
            pass
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, cd.allow_tf32)
    try:
        for flags in ((False, False), (True, False)):
            mm.allow_tf32, cd.allow_tf32 = flags
            model.set_precision("high")
            model.encode(torch.from_numpy(_wav(1, 1280)[None]))
            assert (mm.allow_tf32, cd.allow_tf32) == flags
            with pytest.raises(ValueError, match="expected"):
                model.encode(torch.zeros(1, 1280))      # not [B, C, T]
            assert (mm.allow_tf32, cd.allow_tf32) == flags
            with tdevice.precision_scope("high"):
                assert mm.allow_tf32 and cd.allow_tf32
            with tdevice.precision_scope("fast"):
                assert not (mm.allow_tf32 or cd.allow_tf32)
            assert (mm.allow_tf32, cd.allow_tf32) == flags
    finally:
        mm.allow_tf32, cd.allow_tf32 = before
        model.set_precision("highest")


def test_fast_mode_encodes_and_decodes():
    """'fast' on the CPU: bf16 conv trunks, float32 latents into K2's twin
    and float32 audio out; the codes are mostly those of 'highest' (the
    random books' margins sit well above bf16's drift almost everywhere)."""
    model, _ = _model24(seed=6)
    x = torch.from_numpy(_wav(12, 4800)[None])
    ref = model.encode(x)
    model.set_precision("fast")
    try:
        frames = model.encode(x)
        audio = model.decode(frames)
        guarded, stats = model.encode_guarded(x)
    finally:
        model.set_precision("highest")
    assert frames[0][0].shape == ref[0][0].shape
    assert float((frames[0][0] == ref[0][0]).float().mean()) >= 0.9
    assert audio.dtype == torch.float32 and torch.isfinite(audio).all()
    assert stats["n_positions"] == frames[0][0].shape[-1]
