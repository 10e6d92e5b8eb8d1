"""The range decoder of lmv=3 on the device: the port's plain twin
(`stream/device_ac.py`, the CPU route of `kernels.ac_head_pull`) against the
JAX package's `stream/device_ac.py` and the host `ArithmeticDecoder`, and
`IntLMModel.decode_lockstep` against JAX's `_lockstep_decode_int`, on the
CPU.

Every comparison is exact (tolerance zero): symbols, the coder state after
every row (JAX's two uint32 limbs joined into one integer), the `ok` and
`eof` flags, decoded codes and the exception a bad stream raises. The
streams are written by the host coder from seeded random pdfs (the cases
of `tests/test_device_ac.py`) or by the port's small integer LM (dim 16,
2 heads, 2 layers, W=20, card 64, 8 codebooks: `test_torch_lm.py`'s
shape), the LM's weights drawn by the JAX package and carried across.
"""

import importlib
import io
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.models import ilm as jax_ilm
from encodec_tpu.models.lm import LMConfig as JaxLMConfig
from encodec_tpu.models.lm import LMModel as JaxLMModel
from encodec_tpu.models.lm import init_lm as jax_init_lm
from encodec_tpu.stream import device_ac as jax_ac
from encodec_tpu_torch import kernels
from encodec_tpu_torch.models import ilm
from encodec_tpu_torch.models.lm import LMConfig, LMModel
from encodec_tpu_torch.models.zoo import lm_params_from_jax
from encodec_tpu_torch.stream import ac as port_ac
from encodec_tpu_torch.stream import device_ac
from encodec_tpu_torch.stream.ac import (ArithmeticCoder, ArithmeticDecoder,
                                         build_stable_quantized_cdf,
                                         encode_bounds)

SMALL_LM = dict(n_q=8, card=64, dim=16, num_heads=2, num_layers=2,
                past_context=20)
jax_lockstep = importlib.import_module(
    "encodec_tpu.stream.compress")._lockstep_decode_int


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _encode(syms, cdfs) -> bytes:
    fo = io.BytesIO()
    coder = ArithmeticCoder(fo)
    for s, cdf in zip(syms, cdfs):
        coder.push(int(s), cdf)
    coder.flush()
    return fo.getvalue()


def _roundtrip_case(rng, n_symbols, card, skew):
    """Host-encode random symbols under per-step random CDFs; return
    (bytes, cdfs [N, card] int64, symbols [N])."""
    pdfs = rng.dirichlet(np.full(card, skew), size=n_symbols).astype(np.float32)
    cdfs = np.stack([
        build_stable_quantized_cdf(p, 24, check=True) for p in pdfs])
    syms = np.array([rng.choice(card, p=p / p.sum()) for p in pdfs])
    return _encode(syms, cdfs), cdfs, syms


def _extreme_skew_case(rng, n_symbols=500, card=128):
    """Near-zero-entropy pdfs: the ranges stay narrow, the regime of deep
    injection loops, long prefix flushes and `max_bit` toward 61."""
    pdf = np.full(card, 1e-6, np.float32)
    pdf[3] = 1.0
    pdf /= pdf.sum()
    cdf = build_stable_quantized_cdf(pdf, 24, check=True)
    syms = np.where(rng.rand(n_symbols) < 0.97, 3,
                    rng.randint(0, card, size=n_symbols))
    cdfs = np.tile(cdf, (n_symbols, 1))
    return _encode(syms, cdfs), cdfs, syms


def _host_decode(data, cdfs):
    dec = ArithmeticDecoder(io.BytesIO(data))
    return np.array([dec.pull(c) for c in cdfs])


def _u8(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


CASES = [("card16", 16, 1.0), ("card64", 64, 0.05), ("card1024", 1024, 0.3)]


@pytest.mark.parametrize("name,card,skew", CASES)
def test_twin_decode_rows_matches_jax_and_host(name, card, skew):
    rng = np.random.RandomState(card)
    data, cdfs, syms = _roundtrip_case(rng, 200, card, skew)
    np.testing.assert_array_equal(_host_decode(data, cdfs), syms)
    got, ok = device_ac.ac_decode_rows(_u8(data), torch.from_numpy(cdfs))
    want, want_ok = jax_ac.ac_decode_rows(
        jnp.asarray(np.frombuffer(data, np.uint8)),
        jnp.asarray(cdfs.astype(np.int32)))
    assert bool(ok) and bool(want_ok)
    np.testing.assert_array_equal(got.numpy(), syms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twin_extreme_skew_long_stream():
    data, cdfs, syms = _extreme_skew_case(np.random.RandomState(7))
    got, ok = device_ac.ac_decode_rows(_u8(data), torch.from_numpy(cdfs))
    assert bool(ok)
    np.testing.assert_array_equal(got.numpy(), syms)
    np.testing.assert_array_equal(_host_decode(data, cdfs), syms)


def _jax_state_as_int(state) -> np.ndarray:
    """JAX's (low, high, current) limb pairs, max_bit, pos -> `[S, 5]`."""
    st = [np.asarray(x).astype(np.int64) for x in state]
    return np.stack([(st[0] << 32) | st[1], (st[2] << 32) | st[3],
                     (st[4] << 32) | st[5], st[6], st[7]], -1)


def _lanes(cases, K):
    """Streams of equal card as lanes: data [S, L] zero-padded, nbits,
    rows [S, R, K, card] (R = the longest lane's rows; a shorter lane's
    extra rows repeat its last CDF)."""
    R = max(-(-len(c[1]) // K) for c in cases)
    card = cases[0][1].shape[1]
    L = max(len(c[0]) for c in cases)
    data = np.zeros((len(cases), L), np.uint8)
    rows = np.zeros((len(cases), R * K, card), np.int64)
    for s, (d, cdfs) in enumerate(cases):
        data[s, :len(d)] = np.frombuffer(d, np.uint8)
        rows[s] = cdfs[np.minimum(np.arange(R * K), len(cdfs) - 1)]
    nbits = np.array([8 * len(c[0]) for c in cases], np.int64)
    return data, nbits, rows.reshape(len(cases), R, K, card)


def _rowwise_against_jax(data, nbits, rows):
    """Twin `ac_pull_row` and JAX's (vmapped over lanes), row by row: the
    state, symbols, ok and eof after every row must be equal. Returns the
    twin's per-row (symbols [R, S, K], ok [R, S], eof [R, S])."""
    S, R = rows.shape[:2]
    jpull = jax.jit(jax.vmap(jax_ac.ac_pull_row, in_axes=(0, 0, 0, 0)))
    jst = jax_ac.init_state(batch=S)
    jdata, jnb = jnp.asarray(data), jnp.asarray(nbits.astype(np.int32))
    st = device_ac.init_state(S)
    tdata, tnb = torch.from_numpy(data), torch.from_numpy(nbits)
    out = ([], [], [])
    for r in range(R):
        jst, jsym, jok, jeof = jpull(jst, jnp.asarray(
            rows[:, r].astype(np.int32)), jdata, jnb)
        st, sym, ok, eof = device_ac.ac_pull_row(
            st, torch.from_numpy(rows[:, r]), tdata, tnb)
        np.testing.assert_array_equal(st.numpy(), _jax_state_as_int(jst),
                                      err_msg=f"state after row {r}")
        np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(eof.numpy(), np.asarray(jeof))
        for acc, x in zip(out, (sym, ok, eof)):
            acc.append(x.numpy())
    return tuple(np.stack(x) for x in out)


@pytest.mark.parametrize("name,card,skew", CASES)
def test_twin_lanes_state_and_flags_equal_jax(name, card, skew):
    """Three ragged lanes of one card, 4 codebooks per row: the twin's state
    after every row equals JAX's, and the symbols the host decoder's."""
    K = 4
    cases, syms = [], []
    for seed, n in ((card, 200), (card + 1, 120), (card + 2, 37)):
        data, cdfs, s = _roundtrip_case(np.random.RandomState(seed), n, card,
                                        skew)
        cases.append((data, cdfs))
        syms.append(s)
    got, ok, eof = _rowwise_against_jax(*_lanes(cases, K))
    for s, want in enumerate(syms):
        np.testing.assert_array_equal(
            got[:, s].reshape(-1)[:len(want)], want)
        n_rows = len(want) // K
        assert ok[:n_rows, s].all() and not eof[:n_rows, s].any()


def _straddle_case(rng, n_symbols=300, card=1024, limit=49):
    """A stream whose interval keeps straddling a bit boundary, so the
    common prefix cannot flush: each such symbol adds ~10 unflushed bits
    (`max_bit` to 59 here, the reference's limit being 61); then random
    symbols. Returns (bytes, cdfs, symbols, the coder's deepest max_bit)."""
    cdf = build_stable_quantized_cdf(np.full(card, 1.0 / card, np.float32),
                                     24)
    prev = np.concatenate([[0], cdf[:-1]])
    fo = io.BytesIO()
    coder = ArithmeticCoder(fo)
    syms, deepest = [], -1
    for _ in range(n_symbols):
        low, high = coder.low, coder.high
        while high - low + 1 < 2 ** 24:
            low, high = 2 * low, 2 * high + 1
        sym = int(rng.randint(card))
        if coder.max_bit <= limit:
            p = (low ^ high).bit_length() - 1
            boundary = (high >> p) << p
            ratio = (high - low + 1) / 2 ** 24
            for j in range(card):
                if (low + math.ceil(int(prev[j]) * ratio) < boundary
                        <= low + math.floor((int(cdf[j]) - 1) * ratio)):
                    sym = j
                    break
        coder.push(sym, cdf)
        syms.append(sym)
        deepest = max(deepest, coder.max_bit)
    coder.flush()
    return fo.getvalue(), np.tile(cdf, (n_symbols, 1)), np.array(syms), deepest


def test_twin_deep_max_bit_state_equals_jax():
    """`max_bit` near the reference's 61: the int64 state (JAX needs both
    limbs there) equals JAX's after every row, and the symbols the host
    decoder's."""
    data, cdfs, syms, deepest = _straddle_case(np.random.RandomState(7))
    assert deepest >= 55
    np.testing.assert_array_equal(_host_decode(data, cdfs), syms)
    st = device_ac.init_state(1)
    d, nb = _u8(data)[None], torch.tensor([8 * len(data)])
    reached = -1
    for cdf in cdfs:
        st, _, _ = device_ac.ac_pull(st, torch.from_numpy(cdf)[None], d, nb)
        reached = max(reached, int(st[0, device_ac.MAX_BIT]))
    assert reached >= 55
    K = 5
    d, nb, rows = _lanes([(data, cdfs)], K)
    got, ok, eof = _rowwise_against_jax(d, nb, rows)
    np.testing.assert_array_equal(got.reshape(-1), syms)
    assert ok.all() and not eof.any()


def test_twin_flags_corrupt_and_truncated_streams_as_jax():
    """Flipped bytes and a cut stream: state, symbols, ok and eof equal
    JAX's after every row (JAX's 32-bit `current - low` wrap included).
    The CDFs fill only the lower half of the coder's range (23 bits), so a
    corrupt stream soon lands outside every interval."""
    rng = np.random.RandomState(11)
    pdfs = rng.dirichlet(np.full(32, 0.2), size=120).astype(np.float32)
    cdfs = np.stack([build_stable_quantized_cdf(p, 23) for p in pdfs])
    syms = [rng.choice(32, p=p / p.sum()) for p in pdfs]
    data = _encode(syms, cdfs)
    bad = []
    for i in range(0, len(data), max(1, len(data) // 6)):
        b = bytearray(data)
        b[i] ^= 0xFF
        bad.append((bytes(b), cdfs))
    cut = (data[:len(data) // 2], cdfs)
    got, ok, eof = _rowwise_against_jax(*_lanes(bad + [cut], 4))
    assert (~ok[:, :-1]).any(axis=0).sum() >= 3, "flips were not flagged"
    assert eof[:, -1].any(), "the cut stream raised no eof"


def test_mul_shift24_exact():
    """The int64 product and shift equal the reference's exact f64
    floor/ceil across the full operand range."""
    rng = np.random.RandomState(3)
    r = rng.randint(0, 1 << 25, size=4096)
    d = rng.randint(1 << 24, 1 << 25, size=4096)
    fl, ce = device_ac._mul_shift24(torch.from_numpy(r), torch.from_numpy(d))
    want_fl = [int(a) * int(b) >> 24 for a, b in zip(r, d)]
    want_ce = [-((-int(a) * int(b)) >> 24) for a, b in zip(r, d)]
    assert fl.tolist() == want_fl and ce.tolist() == want_ce
    ratio = d.astype(np.float64) / (1 << 24)
    assert want_fl == [math.floor(int(a) * x) for a, x in zip(r, ratio)]
    assert want_ce == [math.ceil(int(a) * x) for a, x in zip(r, ratio)]


def test_ac_pull_rows_cpu_route_is_the_twin():
    """The pull half of the decode's CPU route (`ac_pull_lanes`, which
    `kernels.ac_head_pull`'s twin runs after the head's tail), stepped by
    a device counter as the decode steps it: an inactive lane writes zeros
    and keeps its state and flags, the feed is zero on a lane's last step,
    and no kernel launch is counted."""
    K, card = 3, 16
    cases, syms = [], []
    for seed, n in ((1, 30), (2, 12)):
        data, cdfs, s = _roundtrip_case(np.random.RandomState(seed), n, card,
                                        0.5)
        cases.append((data, cdfs))
        syms.append(s)
    data, nbits, rows = _lanes(cases, K)
    S, R = rows.shape[:2]
    ts = torch.tensor([R, 4])
    state = device_ac.init_state(S)
    codes = torch.full((R, S, K), -1, dtype=torch.int64)
    feed = torch.full((S, K), -1, dtype=torch.int64)
    ok = torch.ones(S, dtype=torch.bool)
    eof = torch.zeros(S, dtype=torch.bool)
    step = torch.zeros(1, dtype=torch.int64)
    kernels.reset_launch_counts()
    for t in range(R):
        before = state[1].clone()
        device_ac.ac_pull_lanes(state, torch.from_numpy(rows[:, t]),
                                torch.from_numpy(data),
                                torch.from_numpy(nbits), ts, step, codes,
                                feed, ok, eof)
        step += 1
        if t >= 4:
            assert torch.equal(state[1], before)
            assert not codes[t, 1].any() and not feed[1].any()
        want_feed = codes[t] + 1
        want_feed[(t + 1 >= ts)] = 0
        assert torch.equal(feed, want_feed)
    assert kernels.launch_counts()["ac_head_pull"] == 0
    np.testing.assert_array_equal(codes[:, 0].reshape(-1)[:30], syms[0])
    np.testing.assert_array_equal(codes[:4, 1].reshape(-1), syms[1][:12])
    assert ok.all() and not eof.any()


# -- the lockstep decode of the integer LM ---------------------------------

@pytest.fixture(scope="module")
def ilms():
    jcfg = JaxLMConfig(**SMALL_LM)
    jlm = JaxLMModel(jcfg, jax_init_lm(jax.random.PRNGKey(2), jcfg))
    tlm = LMModel(LMConfig(**SMALL_LM),
                  lm_params_from_jax(jax.tree.map(np.asarray, jlm.params)),
                  device="cpu")
    jilm = jax_ilm.IntLMModel.from_lm(jlm)
    jilm.CODEC_CHUNK = 16          # several of JAX's chunks per decode
    return jilm, ilm.IntLMModel.from_lm(tlm)


def _lm_streams(tm, Ts, seed):
    rng = np.random.RandomState(seed)
    K = tm.cfg.n_q
    codes = [rng.randint(0, tm.card, (K, T)) for T in Ts]
    datas = [encode_bounds(lo, hi)
             for lo, hi in tm.codec_symbol_bounds_batched(codes)]
    return codes, datas


def _outcome(fn):
    try:
        return fn()
    except (EOFError, RuntimeError) as exc:
        return type(exc)


def test_decode_lockstep_equals_jax_ragged_lanes(ilms):
    jm, tm = ilms
    K, Ts = tm.cfg.n_q, [19, 11, 37]
    codes, datas = _lm_streams(tm, Ts, 5)
    got = tm.decode_lockstep(datas, K, Ts)
    want = jax_lockstep(datas, jm, K, Ts)
    assert got.shape == (3, K, max(Ts)) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    for s, T in enumerate(Ts):
        np.testing.assert_array_equal(got[s, :, :T], codes[s])
        assert not got[s, :, T:].any()


def test_decode_lockstep_bad_streams_raise_as_jax(ilms):
    """A truncated lane raises EOFError, a corrupt one RuntimeError('Binary
    search failed'), each as JAX's decoder does: for every cut and flipped
    byte tried, the port's outcome (codes or exception) equals JAX's."""
    jm, tm = ilms
    K, Ts = tm.cfg.n_q, [24, 9]
    _, datas = _lm_streams(tm, Ts, 6)
    with pytest.raises(EOFError, match="sooner than expected"):
        tm.decode_lockstep([datas[0][:len(datas[0]) // 2], datas[1]], K, Ts)
    seen = set()
    n = len(datas[0])
    for i in range(0, n, max(1, n // 6)):
        b = bytearray(datas[0])
        b[i] ^= 0x5A
        bad = [bytes(b), datas[1]]
        got = _outcome(lambda: tm.decode_lockstep(bad, K, Ts))
        want = _outcome(lambda: jax_lockstep(bad, jm, K, Ts))
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
            seen.add("codes")
        else:
            assert got is want, (i, got, want)
            seen.add(want.__name__)
    assert "RuntimeError" in seen, seen


def test_decode_lockstep_never_uses_the_host_decoder(ilms, monkeypatch):
    _, tm = ilms

    def boom(*args, **kwargs):
        raise AssertionError("the host range decoder was called")

    monkeypatch.setattr(port_ac, "make_decoder", boom)
    monkeypatch.setattr(ArithmeticDecoder, "pull", boom)
    K, Ts = tm.cfg.n_q, [7, 12]
    codes, datas = _lm_streams(tm, Ts, 8)
    got = tm.decode_lockstep(datas, K, Ts)
    for s, T in enumerate(Ts):
        np.testing.assert_array_equal(got[s, :, :T], codes[s])
