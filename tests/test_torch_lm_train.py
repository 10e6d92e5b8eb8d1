"""Training the entropy-coding LM in the port against the JAX package's
trainer (optax), on the CPU, and coding lmv=3 files with the trained LM.

Small LMs (dim 16-32, 2 heads, 2 layers, card 32-64, windows of 16-20),
drawn by the JAX `init_lm`, carried across with `zoo.lm_params_from_jax`;
codes from a numpy seed. Tolerances: the loss within 1e-5 relative (both
float32, their own summation orders). After one and three Adam steps
every parameter is within 0.2·lr = 6e-5 of JAX's (lr = 3e-4): Adam divides
each gradient entry by the root of its second moment, so where an entry
is small against the float32 noise of the two gradients its step differs
by a fraction of lr, not of the weight (measured here: 9.0e-6 after one
step, 2.3e-5 after three). Since that hardly sees the gradient's size, the
gradient itself is held to JAX's (1e-4 of each leaf's largest |value|),
the raw global norm to optax's (1e-5 relative), and a clip that binds is
held over three steps.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.models import lm as jlm
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.torch_zoo import torch_state_from_params
from encodec_tpu.stream.compress import \
    decompress_from_file as jax_decompress_from_file
from encodec_tpu.train import lm_train as jtrain
from encodec_tpu_torch.models import build_model, ilm, load_state
from encodec_tpu_torch.models import lm as tlm
from encodec_tpu_torch.models.zoo import lm_params_from_jax
from encodec_tpu_torch.stream import compress, decompress
from encodec_tpu_torch.train import lm_train as ttrain
from encodec_tpu_torch.train.optim import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed=0, **kw):
    cfg = dict(n_q=4, card=32, dim=32, num_heads=2, num_layers=2,
               past_context=16)
    cfg.update(kw)
    jcfg, tcfg = jlm.LMConfig(**cfg), tlm.LMConfig(**cfg)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _structured_codes(rng, B, K, T, card):
    """Predictable code streams (the JAX package's test_lm_train.py):
    per-codebook cycles with 5% noise, entropy far below log2(card)."""
    base = (np.arange(T)[None, None, :]
            * (1 + np.arange(K))[None, :, None]) % card
    noise = rng.randint(0, card, size=(B, K, T))
    mask = rng.rand(B, K, T) < 0.05
    return np.where(mask, noise,
                    np.broadcast_to(base, (B, K, T))).astype(np.int32)


def _max_leaf_diff(tparams, jparams) -> float:
    jl = jax.tree.leaves(jparams)
    tl = tree_leaves(tparams)
    assert len(jl) == len(tl)
    return max(float(np.abs(t.numpy() - np.asarray(j)).max())
               for t, j in zip(tl, jl))


def test_shift_codes_equals_jax():
    codes = np.random.RandomState(0).randint(0, 32, (2, 3, 7))
    np.testing.assert_array_equal(
        ttrain.shift_codes(torch.from_numpy(codes)).numpy(),
        np.asarray(jtrain.shift_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        ttrain.shift_codes(torch.arange(6).reshape(1, 2, 3))[0].numpy(),
        [[0, 1, 2], [0, 4, 5]])


def test_lm_loss_equals_jax():
    jcfg, jp, tcfg, tp_ = _pair(seed=1)
    codes = _structured_codes(np.random.RandomState(1), 3, 4, 20, 32)
    jloss, jm = jtrain.lm_loss(jp, jnp.asarray(codes), jcfg)
    tloss, tm = ttrain.lm_loss(tp_, torch.from_numpy(codes), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["bits_per_code"]),
                               float(jm["bits_per_code"]), rtol=1e-5)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_equal_optax(steps):
    jcfg, jp, tcfg, tp_ = _pair(seed=2)
    jopt, jstate = jtrain.create_lm_train_state(jp, lr=3e-4)
    jstep = jtrain.make_lm_train_step(jcfg, jopt)
    opt, state = ttrain.create_lm_train_state(tp_, lr=3e-4)
    step = ttrain.make_lm_train_step(tcfg, opt)
    rng = np.random.RandomState(2)
    before = [t.clone() for t in tree_leaves(tp_)]
    for _ in range(steps):
        codes = _structured_codes(rng, 4, 4, 24, 32)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(codes))
        tp_, state, tm = step(tp_, state, torch.from_numpy(codes))
        np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                                   rtol=1e-5)
    assert int(state.count) == steps
    diff = _max_leaf_diff(tp_, jp)
    assert diff <= 0.2 * 3e-4, diff
    # the inputs are not changed in place
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(
        _pair(seed=2)[3])))


def test_gradient_equals_jax():
    """Adam's step hardly depends on the gradient's size, so the gradient
    itself is held to JAX's: every leaf within 1e-4 of its largest
    |value|, floored at 1e-3 of the whole gradient's largest |value| (the
    key biases' exact gradient is zero: every key, the zero first one
    included, carries the same bias, which the softmax does not see; both
    packages give float32 noise of 1e-10 there). The step's `grad_norm`
    (the raw gradient's global norm) is within 1e-5 relative of optax's
    `global_norm`."""
    import optax

    from encodec_tpu_torch.train.steps import _grads, _with_grad

    jcfg, jp, tcfg, tp_ = _pair(seed=6)
    codes = _structured_codes(np.random.RandomState(6), 4, 4, 24, 32)
    (_, _), jgrads = jax.value_and_grad(jtrain.lm_loss, has_aux=True)(
        jp, jnp.asarray(codes), jcfg)
    params = _with_grad(tp_)
    loss, _ = ttrain.lm_loss(params, torch.from_numpy(codes), tcfg)
    grads = _grads(loss, params)
    jl = [np.asarray(j) for j in jax.tree.leaves(jgrads)]
    tl = [t.numpy() for t in tree_leaves(grads)]
    assert len(jl) == len(tl)
    floor = 1e-3 * max(float(np.abs(j).max()) for j in jl)
    worst = max(float(np.abs(t - j).max()) / max(float(np.abs(j).max()), floor)
                for t, j in zip(tl, jl))
    assert worst <= 1e-4, worst
    opt, state = ttrain.create_lm_train_state(tp_, lr=3e-4)
    _, _, m = ttrain.make_lm_train_step(tcfg, opt)(
        tp_, state, torch.from_numpy(codes))
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(optax.global_norm(jgrads)), rtol=1e-5)


def test_binding_clip_steps_equal_optax():
    """Three steps with a clip that binds at every step (raw norms about
    0.94-0.99 against a clip of 0.05): the clip changes the ratios between
    steps, which Adam does see. Parameters within 0.2·lr of optax's, as in
    `test_train_steps_equal_optax` (measured 1.3e-6; the port without the
    clip lands 1.8e-4 from optax with it)."""
    jcfg, jp, tcfg, tp_ = _pair(seed=6)
    jopt, jstate = jtrain.create_lm_train_state(jp, lr=3e-4, clip=0.05)
    jstep = jtrain.make_lm_train_step(jcfg, jopt)
    opt, state = ttrain.create_lm_train_state(tp_, lr=3e-4, clip=0.05)
    step = ttrain.make_lm_train_step(tcfg, opt)
    rng = np.random.RandomState(7)
    for _ in range(3):
        codes = _structured_codes(rng, 4, 4, 24, 32)
        jp, jstate, _ = jstep(jp, jstate, jnp.asarray(codes))
        tp_, state, m = step(tp_, state, torch.from_numpy(codes))
        assert float(m["grad_norm"]) > 0.05
    diff = _max_leaf_diff(tp_, jp)
    assert diff <= 0.2 * 3e-4, diff


def test_lm_training_reduces_entropy():
    """The port's version of the JAX package's test: 150 steps on
    structured codes take the cross-entropy below 0.6 of log2(card), and
    the trained LM codes held-out codes below 0.8 of raw bit packing."""
    from encodec_tpu_torch.stream.ac import (ArithmeticCoder,
                                             build_stable_quantized_cdf)
    from encodec_tpu_torch.stream.binary import pack_bits

    cfg = tlm.LMConfig(n_q=4, card=32, dim=32, num_layers=2, num_heads=2,
                       past_context=16)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    opt, state = ttrain.create_lm_train_state(params, lr=3e-3)
    step = ttrain.make_lm_train_step(cfg, opt)
    for _ in range(150):
        batch = torch.from_numpy(_structured_codes(rng, 8, 4, 24, 32))
        params, state, metrics = step(params, state, batch)
    bits = float(metrics["bits_per_code"])
    assert np.isfinite(bits) and bits < np.log2(32) * 0.6, bits

    lm = tlm.LMModel(cfg, params, device="cpu")
    held = _structured_codes(np.random.RandomState(99), 1, 4, 48, 32)[0]
    K, T = held.shape
    fo = io.BytesIO()
    coder = ArithmeticCoder(fo)
    st = lm.init_stream(1)
    inp = np.zeros((1, K), np.int64)
    for t in range(T):
        probas, st = lm.step(inp, st)
        for k in range(K):
            coder.push(int(held[k, t]),
                       build_stable_quantized_cdf(probas[0, :, k].numpy(), 24))
        inp = 1 + held[None, :, t].astype(np.int64)
    coder.flush()
    assert len(fo.getvalue()) < 0.8 * len(pack_bits(held.T, 5))


CODEC_24 = dict(sample_rate=24000, channels=1, causal=True,
                model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
                dimension=16, n_filters=4, kmeans_init=False)


def test_port_trained_lm_writes_lmv3_files_jax_decodes():
    """An LM trained in the port on the port codec's own codes, passed
    through `IntLMModel.from_lm`, writes lmv=3 files (blocked and
    unblocked) that the JAX package decodes to the same codes; its
    parameters cross to JAX with a numpy tree map (the same layout). The
    port reads its own file back to the same codes."""
    jm = jax_build_model([1.5, 3.0, 6.0], name="unset", seed=0, **CODEC_24)
    tm = build_model([1.5, 3.0, 6.0], name="unset", seed=0, device="cpu",
                     **CODEC_24)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    tm.set_target_bandwidth(6.0)
    jm.set_target_bandwidth(6.0)
    rng = np.random.RandomState(3)
    t = np.arange(2 * 2400) / 24000.0
    wavs = [(0.3 * np.sin(2 * np.pi * f * t) + 0.1 * rng.randn(t.size))
            .astype(np.float32)[None] for f in (220.0, 440.0, 880.0)]
    codes = torch.cat([tm.encode(torch.from_numpy(w)[None])[0][0]
                       for w in wavs])                       # [3, 8, 30]
    cfg = tlm.LMConfig(n_q=8, card=64, dim=16, num_heads=2, num_layers=2,
                       past_context=20)
    params = tlm.init_lm(torch.Generator().manual_seed(4), cfg)
    opt, state = ttrain.create_lm_train_state(params, lr=3e-3)
    step = ttrain.make_lm_train_step(cfg, opt)
    for _ in range(5):
        params, state, metrics = step(params, state, codes)
    lm = tlm.LMModel(cfg, params, device="cpu")
    jlm_ = jlm.LMModel(jlm.LMConfig(n_q=8, card=64, dim=16, num_heads=2,
                                    num_layers=2, past_context=20),
                       jax.tree.map(lambda x: jnp.asarray(x.numpy()), params))
    treg = {tm.name: lambda pretrained=True: tm}
    jreg = {jm.name: lambda pretrained=True: jm}
    wav = wavs[1]
    for restart in (None, 12):
        data = compress(tm, wav, use_lm=True, lm=lm, models=treg,
                        lm_restart=restart)
        written = tm.encode_guarded(torch.from_numpy(wav)[None], 1e-3)[0]
        seen = []
        jax_decompress_from_file(
            io.BytesIO(data), models=jreg, lm=jlm_,
            decode=lambda frames: (seen.append(frames), jm.decode(frames))[1])
        np.testing.assert_array_equal(np.asarray(seen[0][0][0]),
                                      written[0][0].numpy())
        back, sr = decompress(data, models=treg, lm=lm, device="cpu")
        assert back.shape == (1, wav.shape[-1]) and sr == 24000
    assert ilm.IntLMModel.from_lm(lm) is ilm.IntLMModel.from_lm(lm)
