"""The lmv=3 decode step as the card runs it, on the CPU: the integer LM's
head split into its product (`_head_acc`) and its tail (`_head_tail`), the
fused twin `stream.device_ac.ac_head_pull_lanes` (the CPU route of
`kernels.ac_head_pull`), the static decode runner (`models.ilm.
_DecodeGraph`, run eagerly here) and `IntLMModel.decode_lockstep` through
it, each against the JAX package.

Every comparison is exact (tolerance zero): CDF rows, symbols, the coder
state after every step (JAX's two uint32 limbs joined into one integer),
the `ok` and `eof` flags, and decoded codes. The LMs are small (dim 16, 2
heads, 2 layers, W = 4 and 8, card 16 and 64, 4 codebooks), drawn by the
JAX package and carried across; trunk outputs, feeds and symbols come from
numpy seeds, and the streams are written by the host coder or by the JAX
package's lmv=3 writer.
"""

import importlib
import io

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
from encodec_tpu.models.torch_zoo import torch_state_from_params
from encodec_tpu.stream import compress as jax_compress
from encodec_tpu.stream import device_ac as jax_ac
from encodec_tpu_torch import kernels
from encodec_tpu_torch.kernels import ac_cuda
from encodec_tpu_torch.models import build_model, ilm, load_state
from encodec_tpu_torch.models.lm import LMConfig, LMModel
from encodec_tpu_torch.models.zoo import lm_params_from_jax
from encodec_tpu_torch.stream import device_ac
from encodec_tpu_torch.stream.ac import ArithmeticCoder
from encodec_tpu_torch.stream.compress import read_frames

LMS = {"card16": dict(n_q=4, card=16, dim=16, num_heads=2, num_layers=2,
                      past_context=4),
       "card64": dict(n_q=4, card=64, dim=16, num_heads=2, num_layers=2,
                      past_context=8),
       # the codecs' 8 codebooks at 6 kbps (24 kHz), for the files
       "file": dict(n_q=8, card=64, dim=16, num_heads=2, num_layers=2,
                    past_context=8)}
CODEC_24 = dict(sample_rate=24000, channels=1, causal=True,
                model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
                dimension=16, n_filters=4, kmeans_init=False)
jax_lockstep = importlib.import_module(
    "encodec_tpu.stream.compress")._lockstep_decode_int


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ilm_pair(name, seed=2):
    cfg = LMS[name]
    jcfg = JaxLMConfig(**cfg)
    jlm = JaxLMModel(jcfg, jax_init_lm(jax.random.PRNGKey(seed), jcfg))
    tlm = LMModel(LMConfig(**cfg),
                  lm_params_from_jax(jax.tree.map(np.asarray, jlm.params)),
                  device="cpu")
    return jlm, tlm, jax_ilm.IntLMModel.from_lm(jlm), \
        ilm.IntLMModel.from_lm(tlm)


@pytest.fixture(scope="module", params=["card16", "card64"])
def pair(request):
    return _ilm_pair(request.param)


def _trunk_out(rng, shape, scale):
    """Integer trunk outputs (A10 activations), some beyond the head's
    clip: `scale` sets how peaked the rows are."""
    return rng.randint(-scale, scale + 1, size=shape).astype(np.int64)


def _head_args(tm, K):
    ip = tm.iparams
    return ip["head_b"][:K].to(torch.int32), tm.exps[0], ip["lut"]["exp2"]


@pytest.mark.parametrize("scale", [300, 4000, 30000])
def test_split_head_equals_jax_head_cdf(pair, scale):
    """`_head_tail(_head_acc(x))` and `_head_cdf` give JAX's `_head_cdf`
    rows bit for bit, one lead dimension or two; large activations (past
    MM_CLIP) make the rows peaked."""
    _, _, jm, tm = pair
    K, d = tm.cfg.n_q, tm.cfg.dim
    rng = np.random.RandomState(scale)
    for shape in ((3, d), (2, 5, d)):
        x = _trunk_out(rng, shape, scale)
        want = np.asarray(jax_ilm._head_cdf(jm.iparams, jm.exps,
                                            jnp.asarray(x, jnp.int32), K))
        acc = ilm._head_acc(tm.iparams, torch.from_numpy(x), K)
        assert acc.dtype == torch.float64
        assert tuple(acc.shape) == (K, int(np.prod(shape[:-1])), tm.card)
        rows = ilm._head_tail(acc, *_head_args(tm, K))
        np.testing.assert_array_equal(
            rows.reshape(*shape[:-1], K, tm.card).numpy(), want)
        np.testing.assert_array_equal(
            ilm._head_cdf(tm.iparams, tm.exps, torch.from_numpy(x),
                          K).numpy(), want)


def _jax_state_as_int(state) -> np.ndarray:
    """JAX's (low, high, current) limb pairs, max_bit, pos -> `[S, 5]`."""
    st = [np.asarray(x).astype(np.int64) for x in state]
    return np.stack([(st[0] << 32) | st[1], (st[2] << 32) | st[3],
                     (st[4] << 32) | st[5], st[6], st[7]], -1)


def _streams(tm, x, ts, rng):
    """Host-code each lane's symbols under the head's rows of its trunk
    outputs `x` [T, S, d]: symbols drawn from each row's distribution, lane
    s coding its first ts[s] steps. Returns (streams, symbols [T, S, K])."""
    T, S = x.shape[:2]
    K = tm.cfg.n_q
    rows = ilm._head_cdf(tm.iparams, tm.exps, torch.from_numpy(x),
                         K).numpy()                           # [T, S, K, card]
    syms = np.zeros((T, S, K), np.int64)
    datas = []
    for s in range(S):
        fo = io.BytesIO()
        coder = ArithmeticCoder(fo)
        for t in range(ts[s]):
            for k in range(K):
                cdf = rows[t, s, k]
                p = np.diff(np.concatenate([[0], cdf])).astype(np.float64)
                syms[t, s, k] = rng.choice(tm.card, p=p / p.sum())
                coder.push(int(syms[t, s, k]), cdf)
        coder.flush()
        datas.append(fo.getvalue())
    return datas, syms


def _lockstep_against_jax(jm, tm, x, datas, ts):
    """`kernels.ac_head_pull` on CPU tensors (the fused twin) step by step
    from the head's product, against JAX's `_head_cdf` and vmapped
    `ac_pull_row` with the fused scan's masking (a lane is active while
    t < ts): state, codes, feed, ok and eof equal after every step.
    Returns the twin's (codes [T, S, K], ok, eof)."""
    T, S = x.shape[:2]
    K = tm.cfg.n_q
    L = max(1, max(len(d) for d in datas))
    buf = np.zeros((S, L), np.uint8)
    for s, d in enumerate(datas):
        buf[s, :len(d)] = np.frombuffer(d, np.uint8)
    nbits = np.array([8 * len(d) for d in datas], np.int64)
    head = jax.jit(lambda p, xx: jax_ilm._head_cdf(p, jm.exps, xx, K))
    jpull = jax.jit(jax.vmap(jax_ac.ac_pull_row, in_axes=(0, 0, 0, 0)))
    jst = jax_ac.init_state(batch=S)
    jdata, jnb = jnp.asarray(buf), jnp.asarray(nbits.astype(np.int32))
    jok, jeof = np.ones(S, bool), np.zeros(S, bool)
    state = device_ac.init_state(S)
    data, tnb = torch.from_numpy(buf), torch.from_numpy(nbits)
    tts = torch.tensor(ts, dtype=torch.int64)
    codes = torch.full((T, S, K), -1, dtype=torch.int64)
    feed = torch.full((S, K), -1, dtype=torch.int64)
    ok = torch.ones(S, dtype=torch.bool)
    eof = torch.zeros(S, dtype=torch.bool)
    step = torch.zeros(1, dtype=torch.int64)
    head_b, e0, lut = _head_args(tm, K)
    for t in range(T):
        rows = head(jm.iparams, jnp.asarray(x[t], jnp.int32))
        new, jsym, jok_t, jeof_t = jpull(jst, rows, jdata, jnb)
        active = t < np.asarray(ts)
        jst = tuple(jnp.where(jnp.asarray(active), a, b)
                    for a, b in zip(new, jst))
        jsym = np.where(active[:, None], np.asarray(jsym), 0)
        jok &= np.asarray(jok_t) | ~active
        jeof |= np.asarray(jeof_t) & active
        jfeed = np.where((t + 1 < np.asarray(ts))[:, None], jsym + 1, 0)

        acc = ilm._head_acc(tm.iparams, torch.from_numpy(x[t]), K)
        kernels.ac_head_pull(state, acc, head_b, e0, lut, data, tnb, tts,
                             step, codes, feed, ok, eof)
        step += 1
        msg = f"step {t}"
        np.testing.assert_array_equal(state.numpy(), _jax_state_as_int(jst),
                                      err_msg=msg)
        np.testing.assert_array_equal(codes[t].numpy(), jsym, err_msg=msg)
        np.testing.assert_array_equal(feed.numpy(), jfeed, err_msg=msg)
        np.testing.assert_array_equal(ok.numpy(), jok, err_msg=msg)
        np.testing.assert_array_equal(eof.numpy(), jeof, err_msg=msg)
    return codes.numpy(), ok.numpy(), eof.numpy()


@pytest.mark.parametrize("case", ["ragged", "corrupt", "cut"])
def test_fused_twin_equals_jax_head_and_pull(pair, case):
    """The fused twin (through the wrapper's CPU route, counting no launch)
    equals JAX's head followed by JAX's `ac_pull_row` at every step: three
    ragged lanes (inactive lanes write zeros and keep their state); flipped
    bytes and a stream of 0xFF bytes (which lands past every interval at
    its first pull: a head's rows never reach 2^24) beside an intact lane;
    a stream cut in half (eof) beside an intact lane."""
    _, _, jm, tm = pair
    K, d = tm.cfg.n_q, tm.cfg.dim
    T = 12
    rng = np.random.RandomState({"ragged": 1, "corrupt": 2, "cut": 3}[case])
    S = {"ragged": 3, "corrupt": 3, "cut": 2}[case]
    x = np.concatenate([_trunk_out(rng, (T, 1, d), 4000 * (1 + s))
                        for s in range(S)], 1)            # [T, S, d]
    ts = [T, T - 3, 5] if case == "ragged" else [T] * S
    datas, syms = _streams(tm, x, ts, rng)
    if case == "corrupt":
        flipped = bytearray(datas[1])
        flipped[len(flipped) // 3] ^= 0xFF
        datas = [datas[0], bytes(flipped), b"\xff" * len(datas[2])]
    elif case == "cut":
        datas = [datas[0], datas[1][:len(datas[1]) // 2]]
    kernels.reset_launch_counts()
    codes, ok, eof = _lockstep_against_jax(jm, tm, x, datas, ts)
    assert kernels.launch_counts()["ac_head_pull"] == 0
    np.testing.assert_array_equal(codes[:, 0], syms[:, 0])
    assert ok[0] and not eof[0]
    if case == "ragged":
        for s, n in enumerate(ts):
            np.testing.assert_array_equal(codes[:n, s], syms[:n, s])
            assert not codes[n:, s].any()
        assert ok.all() and not eof.any()
    elif case == "corrupt":
        assert not ok[2], "the 0xFF stream was not flagged"
        assert not np.array_equal(codes[:, 1], syms[:, 1])
    else:
        assert eof[1], "the cut stream raised no eof"


def test_runner_rows_equal_jax_steps_through_the_window_fill(pair):
    """The static decode runner, eager on the CPU: its ring with the mask
    from the device step counter gives JAX's `ilm_step` rows at every step
    while the window fills and past it (JAX's `length` from 1 to W + 1,
    over 2W + 3 steps), with the feed JAX is given."""
    _, _, jm, tm = pair
    W, K, S = tm.cfg.past_context, tm.cfg.n_q, 2
    T = 2 * W + 3
    feeds = np.random.RandomState(W).randint(0, tm.card + 1, (T, S, K))
    step = jax.jit(lambda p, i, s: jax_ilm.ilm_step(p, jm.exps, i, s, jm.cfg))
    js = jm.init_stream(batch=S)
    with torch.inference_mode():
        runner = ilm._DecodeGraph(tm, S, K, n_bytes=8, n_steps=T)
        runner.reset([b""] * S, [T] * S)
        for t in range(T):
            want, js = step(jm.iparams, jnp.asarray(feeds[t], jnp.int32), js)
            runner.feed.copy_(torch.from_numpy(feeds[t]))
            runner.lm()
            got = ilm._head_tail(runner.acc, *_head_args(tm, K))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want),
                err_msg=f"step {t} (JAX length {int(js.length)})")
            runner.t += 1
    assert int(js.length) == W + 1


def _codecs(bandwidths, **kw):
    jm = jax_build_model(bandwidths, name="unset", seed=0, **kw)
    tm = build_model(bandwidths, name="unset", seed=0, device="cpu", **kw)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


def _audio(shape, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.1 * rng.randn(*shape)).astype(np.float32)


def test_decode_lockstep_equals_jax_on_a_jax_written_file(monkeypatch):
    """A JAX-written lmv=3 file read by the port: `decode_lockstep` (the
    runner, eager on the CPU) returns JAX's `_lockstep_decode_int` codes on
    the file's lanes, which are ragged (10 frames in `lm_restart` blocks of
    4: 4, 4 and 2 steps), and they are the codes the writer coded."""
    jm, tm = _codecs([1.5, 3.0, 6.0], **CODEC_24)
    bandwidth, restart, wav = 6.0, 4, _audio((1, 3200), seed=5)
    jlm, tlm, jilm, _ = _ilm_pair("file", seed=4)
    jm.set_target_bandwidth(bandwidth)
    tm.set_target_bandwidth(bandwidth)
    data = jax_compress(jm, wav, use_lm=True, lm=jlm,
                        models={"unset": lambda pretrained=True: jm},
                        lm_restart=restart)
    calls = []
    lockstep = ilm.IntLMModel.decode_lockstep

    def spy(self, datas, K, Ts):
        out = lockstep(self, datas, K, Ts)
        calls.append((list(datas), K, list(Ts), out))
        return out

    monkeypatch.setattr(ilm.IntLMModel, "decode_lockstep", spy)
    _, frames, _ = read_frames(io.BytesIO(data),
                               models={"unset": lambda pretrained=True: tm},
                               lm=tlm)
    (datas, K, Ts, got), = calls
    assert len(set(Ts)) > 1, Ts
    np.testing.assert_array_equal(got, jax_lockstep(datas, jilm, K, Ts))
    guarded, _ = tm.encode_guarded(torch.from_numpy(wav)[None])
    assert len(frames) == len(guarded)
    for (codes, _), (want, _) in zip(frames, guarded):
        np.testing.assert_array_equal(codes.numpy(), want.numpy())


def test_ac_plan_raises_beyond_shared_memory():
    """The plan gives the kernel's 4-CTA clusters of 8 warps and its
    dynamic shared memory, and refuses what a block cannot hold: rows past
    227 KB, a card a warp cannot hold in its registers."""
    plan = ac_cuda.ac_plan(32, 1024)
    assert plan == {"cluster": 4, "threads": 256,
                    "smem": 4 * 32 * 1056 + 4 * 1024 + 3 * 32 + 16}
    assert ac_cuda.ac_plan(16, 1024)["smem"] < plan["smem"]
    assert ac_cuda.ac_plan(2, 16)["smem"] == 4 * 2 * 1056 + 4 * 1024 + 24
    assert ac_cuda.ac_plan(54, 1024)["smem"] <= 232_448
    with pytest.raises(ValueError, match="227 KB"):
        ac_cuda.ac_plan(55, 1024)
    with pytest.raises(ValueError, match="at most 1024"):
        ac_cuda.ac_plan(4, 1025)


def test_decode_runners_are_cached_per_shape(pair):
    """One runner per (lanes, codebooks), reused while its buffers hold the
    decode, made anew with power-of-two capacities when they do not, and
    at most `DECODE_GRAPHS` kept, the least recently used dropped first."""
    _, _, _, tm = pair
    tm.__dict__.pop("_decode_graphs", None)
    first = tm._decode_graph(2, 3, 100, 9)
    assert (first.data.shape[1], first.codes.shape[0]) == (128, 16)
    assert tm._decode_graph(2, 3, 128, 16) is first
    grown = tm._decode_graph(2, 3, 129, 16)
    assert grown is not first and grown.data.shape[1] == 256
    for S in range(1, 2 + tm.DECODE_GRAPHS):
        tm._decode_graph(S, 4, 8, 8)
    graphs = tm._decode_graphs
    assert len(graphs) == tm.DECODE_GRAPHS
    assert (2, 3) not in graphs and (1 + tm.DECODE_GRAPHS, 4) in graphs
