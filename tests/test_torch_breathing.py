"""The breathing tokenizer: the port against the JAX package on the CPU.

- `breathing_model` and the tiny breathing config of `tests/test_tools.py`:
  encode, decode and `codebooks`, with weights carried from the JAX
  package's random init (`kmeans_init=False`) by `params_from_jax` and by
  the reference-layout route (`torch_state_from_params` → `load_state`);
- K3's plain twin at the breathing model's hidden size (H=1024) against the
  JAX layer (`ops/lstm.py::_layer`);
- JAX-trained checkpoints (`train.checkpoint`, format v2) read without JAX,
  and the refusals;
- `tools.inference.main` of both packages on one config, checkpoint and
  set of synthetic nights, `code_distribution` and `decode_most_frequent`;
- the copied `BreathingDataset`, `MergedDataset` and `DataLoader`;
- `StreamingCodec.n_q` fixed when the codec is built, as in JAX.

Inputs are seeded numpy arrays. Tolerances: codes integer-equal; the LSTM
layer within rtol 1e-4 / atol 1e-5 (XLA and oneDNN sum in other orders);
decoded audio against JAX within rtol 1e-4 / atol 5e-5: the tiny
layer-norm decoder (4 filters, random weights; output RMS 0.58, peak 1.7)
amplifies rounding, so that one-ulp relative noise on its weights moves
JAX's own output by up to 4.3e-5 (seeds 3 and 5); the port is within
2.7e-5 of JAX there.
"""

import json
import pickle
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.data import (BreathingDataset as JaxBreathingDataset,
                              DataLoader as JaxDataLoader,
                              MergedDataset as JaxMergedDataset)
from encodec_tpu.models import streaming as jstream
from encodec_tpu.models.model import breathing_model as jax_breathing_model
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.torch_zoo import torch_state_from_params
from encodec_tpu.ops.lstm import _layer as jax_lstm_layer
from encodec_tpu.tools import inference as jinference
from encodec_tpu.train import create_train_state, save_checkpoint
from encodec_tpu.train.config import load_config as jax_load_config
from encodec_tpu.train.trainer import model_from_config as jax_model_from_config
from encodec_tpu_torch.data import BreathingDataset, DataLoader, MergedDataset
from encodec_tpu_torch.kernels import lstm_scan_plain
from encodec_tpu_torch.models import (StreamingCodec, breathing_model,
                                      build_model, load_state, params_from_jax)
from encodec_tpu_torch.tools import inference
from encodec_tpu_torch.train import (CheckpointVersionError, ConfigNamespace,
                                     load_checkpoint,
                                     load_checkpoint_with_fallback,
                                     load_config, model_from_config)

# the tiny breathing model of tests/test_tools.py
TINY_BREATHING = dict(sample_rate=10, channels=1, causal=True,
                      model_norm="layer_norm", name="breathing_model",
                      ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                      decoder_final_norm="none", shared_codebook=True,
                      kmeans_init=False)
# the tiny streaming model of tests/test_torch_streaming.py (weight norm,
# one book per stage): 2 stages at 1.5 kbps, 6 at 6 kbps
TINY_24K = dict(sample_rate=2400, channels=1, causal=True,
                model_norm="weight_norm", name="encodec_24khz",
                ratios=[4, 3, 2, 1], bins=64, dimension=16, n_filters=4,
                kmeans_init=False)
# the experiment config of tests/test_tools.py::test_inference_cli_main
CONFIG = {
    "common": {"log_interval": 1, "max_epoch": 1, "seed": 0,
               "gradient_clipping": True},
    "checkpoint": {"save_every": 1},
    "optimization": {"lr": 1e-3, "disc_lr": 1e-3},
    "loss": {"weight_l1": 1.0, "weight_l2": 0.0, "weight_commit": 0.0,
             "weight_freq": 0.0, "weight_g": 0.0, "weight_feat": 0.0,
             "alpha": 0.01, "bandwidth": None, "n_fft": 64,
             "commit_start_epoch": 0},
    "lr_scheduler": {"warmup_epoch": 1},
    "model": {"ratios": [5, 2, 1], "bins": 32, "dimension": 16,
              "target_bandwidths": [0.08], "train_discriminator": False,
              "train_discriminator_start_epoch": 9,
              "train_discriminator_prob": 0.0, "disc_hop_lengths": [16],
              "disc_win_lengths": [64], "disc_n_ffts": [64],
              "filters": 4, "audio_normalize": False, "causal": True,
              "norm": "layer_norm", "segment": "None",
              "name": "my_encodec", "sample_rate": 10, "channels": 1},
}
DECODE_TOL = dict(rtol=1e-4, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_of(jm, factory=build_model, *args, **kw):
    """A port model with the JAX model's weights, through `params_from_jax`."""
    tm = factory(*args, device="cpu", **kw)
    tm.params, tm.qstate = params_from_jax(jax.tree.map(np.asarray, jm.params),
                                           tuple(np.asarray(a) for a in
                                                 jm.qstate), tm.cfg)
    return tm


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build_model([0.08], seed=3, **TINY_BREATHING)
    return jm, _port_of(jm, build_model, [0.08], seed=3, **TINY_BREATHING)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _codes(model, x):
    frames = model.encode(x)
    assert len(frames) == 1
    return np.asarray(frames[0][0])


def test_tiny_breathing_encode_decode_codebooks_match_jax(tiny):
    jm, tm = tiny
    x = _randn(0, 2, 1, 600)
    jframes = jm.encode(jnp.asarray(x))
    tframes = tm.encode(torch.from_numpy(x))
    codes = tframes[0][0].numpy()
    assert codes.shape == (2, 8, 60)
    np.testing.assert_array_equal(codes, np.asarray(jframes[0][0]))
    assert tframes[0][1] is None and jframes[0][1] is None
    np.testing.assert_allclose(tm.decode(tframes).numpy(),
                               np.asarray(jm.decode(jframes)), **DECODE_TOL)
    # one shared book
    assert tuple(tm.codebooks.shape) == (1, 32, 16)
    np.testing.assert_array_equal(tm.codebooks.numpy(),
                                  np.asarray(jm.codebooks))


@pytest.mark.parametrize("config", ["breathing", "24k_weight_norm"])
def test_params_from_jax_equals_the_reference_state_route(config):
    kw, bw = ((TINY_BREATHING, [0.08]) if config == "breathing"
              else (TINY_24K, [1.5, 6.0]))
    jm = jax_build_model(bw, seed=5, **kw)
    direct = _port_of(jm, build_model, bw, seed=5, **kw)
    via_state = build_model(bw, seed=6, device="cpu", **kw)
    load_state(via_state, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    got, want = dict(_leaves(direct.params)), dict(_leaves(via_state.params))
    assert got.keys() == want.keys() and len(got) > 10
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(direct.qstate, via_state.qstate):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_breathing_model_at_full_width_matches_jax():
    """`breathing_model` at its published widths (H=1024 LSTM, D=256, 1024
    bins, 8 stages of one shared book) on a 10-minute signal: T=20."""
    jm = jax_breathing_model(kmeans_init=False)
    tm = _port_of(jm, breathing_model, kmeans_init=False)
    assert tm.params["encoder"]["lstm"]["layers"][0]["w_hh"].shape == (4096,
                                                                       1024)
    assert (tm.cfg.rvq.bins, tm.cfg.rvq.dimension, tm.n_q_active,
            tm.cfg.rvq.shared_codebook) == (1024, 256, 8, True)
    assert tm.cfg.seanet.hop_length == 300 and tm.sample_rate == 10
    x = 0.5 * _randn(1, 1, 1, 6000)
    codes = _codes(tm, torch.from_numpy(x))
    assert codes.shape == (1, 8, 20)
    np.testing.assert_array_equal(codes, _codes(jm, jnp.asarray(x)))


@pytest.mark.parametrize("stateful", [False, True])
def test_plain_k3_at_h1024_matches_jax_layer(stateful):
    H, B, T = 1024, 2, 20
    rng = np.random.RandomState(7)
    bound = 1.0 / np.sqrt(H)
    layer = {k: rng.uniform(-bound, bound, s).astype(np.float32)
             for k, s in (("w_ih", (4 * H, H)), ("w_hh", (4 * H, H)),
                          ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
    x = _randn(8, B, T, H)
    if stateful:
        h0, c0 = np.tanh(_randn(9, B, H)), _randn(10, B, H)
    else:
        h0 = c0 = np.zeros((B, H), np.float32)
    want, want_h, want_c = jax_lstm_layer(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(c0))
    t = {k: torch.from_numpy(v) for k, v in layer.items()}
    xp = (torch.from_numpy(x) @ t["w_ih"].t() + t["b_ih"] + t["b_hh"])
    state = ((torch.from_numpy(h0), torch.from_numpy(c0)) if stateful
             else (None, None))
    out, hT, cT = lstm_scan_plain(xp.contiguous(), t["w_hh"], *state,
                                  return_state=True)
    for got, ref in ((out, want), (hT, want_h), (cT, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


# -- checkpoints and the extraction tool ---------------------------------

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A config file, a checkpoint the JAX trainer's code wrote for it, and
    a dataset of three synthetic nights (10 Hz `.npz` with `data`, `fs`)."""
    yaml = pytest.importorskip("yaml")
    root = tmp_path_factory.mktemp("experiment")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.dump(CONFIG))
    jm = jax_model_from_config(jax_load_config(str(cfg_path)))
    state, _, _ = create_train_state(jm, None, seed=0)
    ckpt = root / "model.ckpt"
    save_checkpoint(state, 3, ckpt, extra={"note": "synthetic"})
    nights = root / "data" / "synth" / "thorax"
    nights.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, n in enumerate((900, 1217, 640)):
        t = np.arange(n) / 10.0
        sig = np.sin(2 * np.pi * 0.25 * t) + 0.1 * rng.randn(n)
        np.savez(nights / f"n{i}.npz", data=sig.astype(np.float32), fs=10)
    return dict(root=root, cfg=cfg_path, ckpt=ckpt, jax_model=jm)


def test_load_config_and_model_from_config_match_jax(experiment):
    cfg = load_config(str(experiment["cfg"]))
    assert cfg.model.ratios == [5, 2, 1] and cfg.loss.bandwidth is None
    tm = model_from_config(cfg, device="cpu")
    # the same model from a plain dict (the machine with the card has no
    # PyYAML)
    tm2 = model_from_config(ConfigNamespace(CONFIG), device="cpu")
    jm = experiment["jax_model"]
    assert tm.name == tm2.name == jm.name == "my_encodec"
    for m in (tm, tm2):
        assert m.cfg.seanet.hop_length == jm.cfg.seanet.hop_length == 10
        assert (m.cfg.rvq.n_q, m.cfg.rvq.bins, m.cfg.rvq.shared_codebook) == (
            jm.cfg.rvq.n_q, jm.cfg.rvq.bins, True)
        assert m.cfg.seanet.norm == "layer_norm" and m.cfg.seanet.causal


def test_jax_checkpoint_loads_and_gives_jax_codes(experiment):
    state, epoch, extra = load_checkpoint(experiment["ckpt"])
    assert epoch == 3 and extra == {"note": "synthetic"}
    # TrainState's fields come back by name; the quantizer state as the
    # port's own RVQState
    assert state._fields[:2] == ("params", "qstate")
    assert type(state.qstate).__module__ == "encodec_tpu_torch.quant.rvq"
    assert all(isinstance(v, np.ndarray) for _, v in _leaves(state.params))
    tm = model_from_config(load_config(str(experiment["cfg"])), device="cpu")
    tm.params, tm.qstate = params_from_jax(state.params, state.qstate, tm.cfg)
    jm = experiment["jax_model"]
    x = _randn(11, 1, 1, 700)
    np.testing.assert_array_equal(_codes(tm, torch.from_numpy(x)),
                                  _codes(jm, jnp.asarray(x)))


def test_checkpoint_fallback_to_previous_generation(experiment, tmp_path):
    state, _, _ = load_checkpoint(experiment["ckpt"])
    path = tmp_path / "m.ckpt"
    jstate, _, _ = create_train_state(experiment["jax_model"], None, seed=1)
    save_checkpoint(jstate, 1, path)
    save_checkpoint(jstate, 2, path)              # rotates epoch 1 to .prev
    assert load_checkpoint_with_fallback(path)[1] == 2
    path.write_bytes(path.read_bytes()[:100])     # truncated newest file
    with pytest.raises(Exception):
        load_checkpoint(path)
    _, epoch, _ = load_checkpoint_with_fallback(path)
    assert epoch == 1
    assert state.params.keys() == load_checkpoint(
        str(path) + ".prev")[0].params.keys()


@pytest.mark.parametrize("kind", ["v1_pickle", "future_version"])
def test_checkpoint_refusals(tmp_path, kind):
    path = tmp_path / "bad.ckpt"
    if kind == "v1_pickle":
        path.write_bytes(pickle.dumps({"state": [1, 2, 3], "epoch": 1}))
    else:
        manifest = json.dumps({"format_version": 99, "epoch": 1, "extra": {},
                               "tree": {"t": "none"}, "nleaves": 0})
        with open(path, "wb") as fh:
            np.savez(fh, __manifest__=np.frombuffer(manifest.encode(),
                                                    np.uint8))
    (tmp_path / "bad.ckpt.prev").write_bytes(b"")  # never reached
    for load in (load_checkpoint, load_checkpoint_with_fallback):
        with pytest.raises(CheckpointVersionError):
            load(path)


@pytest.mark.parametrize("stream_chunk_hops", [None, 16])
def test_inference_main_dumps_the_jax_tools_npz(experiment, tmp_path,
                                                monkeypatch,
                                                stream_chunk_hops):
    args = ["--config", str(experiment["cfg"]), "--checkpoint",
            str(experiment["ckpt"]), "--data_root",
            str(experiment["root"] / "data"), "--dataset", "synth"]
    if stream_chunk_hops:
        args += ["--stream_chunk_hops", str(stream_chunk_hops)]
    monkeypatch.setattr(sys, "argv", ["inf", *args, "--out",
                                      str(tmp_path / "jax")])
    jinference.main()
    inference.main([*args, "--out", str(tmp_path / "port"), "--device",
                    "cpu"])
    files = sorted(p.name for p in (tmp_path / "jax" / "thorax").glob("*.npz"))
    assert files == ["n0.npz", "n1.npz", "n2.npz"]
    all_codes = []
    for name in files:
        with np.load(tmp_path / "jax" / "thorax" / name) as want, \
                np.load(tmp_path / "port" / "thorax" / name) as got:
            assert got["codes"].dtype == np.int32
            np.testing.assert_array_equal(got["codes"], want["codes"])
            assert float(got["fs"]) == float(want["fs"]) == 1.0
            all_codes.append(got["codes"])
    assert [c.shape for c in all_codes] == [(8, 90), (8, 122), (8, 64)]
    codes = np.concatenate(all_codes, axis=1)
    got = inference.code_distribution(codes, bins=32)
    want = jinference.code_distribution(codes, bins=32)
    for k in ("counts", "probs", "entropy"):
        np.testing.assert_array_equal(got[k], want[k])


def test_code_distribution_and_decode_most_frequent_match_jax(tiny):
    jm, tm = tiny
    x = _randn(12, 1, 600)
    codes = inference.extract_codes(tm, x)
    np.testing.assert_array_equal(codes, jinference.extract_codes(jm, x))
    dist = inference.code_distribution(codes, bins=32)
    want = jinference.code_distribution(codes, bins=32)
    np.testing.assert_array_equal(dist["counts"], want["counts"])
    np.testing.assert_array_equal(dist["entropy"], want["entropy"])
    audio = inference.decode_most_frequent(tm, dist["counts"], length=30)
    assert audio.shape == (1, 300)
    np.testing.assert_allclose(
        audio, jinference.decode_most_frequent(jm, want["counts"], 30),
        **DECODE_TOL)


def test_process_dataset_streamed_equals_offline(tiny, tmp_path):
    jm, tm = tiny

    class Nights:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {"x": _randn(20 + i, 1, 600 + 37 * i),
                    "filename": f"n{i}.npz", "selected_channel": "thorax"}

    assert inference.process_dataset(tm, Nights(), str(tmp_path / "a")) == 2
    inference.process_dataset(tm, Nights(), str(tmp_path / "b"),
                              channel_subdir=False, stream_chunk_hops=8)
    jinference.process_dataset(jm, Nights(), str(tmp_path / "j"))
    for i in range(2):
        with np.load(tmp_path / "a" / "thorax" / f"n{i}.npz") as a, \
                np.load(tmp_path / "b" / f"n{i}.npz") as b, \
                np.load(tmp_path / "j" / "thorax" / f"n{i}.npz") as j:
            np.testing.assert_array_equal(a["codes"], j["codes"])
            np.testing.assert_array_equal(b["codes"], a["codes"])
            assert a["codes"].shape == (8, 60 + (37 * i + 9) // 10)


# -- data -----------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Three datasets of 10 Hz nights on two channels; one night of "a" at
    20 Hz."""
    root = tmp_path_factory.mktemp("nights")
    rng = np.random.RandomState(1)
    for ds, n_files in (("a", 5), ("b", 3), ("c", 4)):
        for ch in ("thorax", "abdomen"):
            d = root / ds / ch
            d.mkdir(parents=True)
            for i in range(n_files):
                n = 700 + 50 * i
                fs = 20 if (ds, i) == ("a", 2) else 10
                t = np.arange(n) / fs
                sig = (np.sin(2 * np.pi * 0.3 * t + i) + 0.2 * rng.randn(n)
                       + (ch == "abdomen"))
                sig[100:110] *= 40.0                     # a motion artifact
                np.savez(d / f"s{i}.npz", data=sig.astype(np.float32), fs=fs)
    return str(root)


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_breathing_dataset_items_equal_jax(data_root, mode):
    kw = dict(mode=mode, channels={"thorax": 0.7, "abdomen": 0.3},
              max_length=600, blocklist=["s4.npz"])
    port = BreathingDataset(data_root, "a", rng=np.random.RandomState(4), **kw)
    ref = JaxBreathingDataset(data_root, "a", rng=np.random.RandomState(4),
                              **kw)
    assert port.file_list == ref.file_list and len(port) > 0
    for i in range(len(port)):
        _assert_items_equal(port[i], ref[i])
        _assert_items_equal(port.__getitem__(i, rng=np.random.RandomState(i)),
                            ref.__getitem__(i, rng=np.random.RandomState(i)))


def test_merged_dataset_and_loader_batches_equal_jax(data_root):
    def build(ds_cls, merged_cls, loader_cls):
        parts = [ds_cls(data_root, name, mode="train", max_length=500,
                        rng=np.random.RandomState(2)) for name in ("b", "c")]
        merged = merged_cls(parts, [0.6, 0.4], rng=np.random.RandomState(3))
        return merged, loader_cls(merged, batch_size=3, shuffle=True, seed=5)

    port, port_loader = build(BreathingDataset, MergedDataset, DataLoader)
    ref, ref_loader = build(JaxBreathingDataset, JaxMergedDataset,
                            JaxDataLoader)
    assert len(port) == len(ref) and len(port_loader) == len(ref_loader)
    for i in range(4):
        (got, got_id), (want, want_id) = port[i], ref[i]
        assert got_id == want_id
        _assert_items_equal(got, want)
    threaded = DataLoader(port, batch_size=3, shuffle=True, seed=5,
                          num_workers=2)
    for _epoch in range(2):   # each pass over a loader is its next epoch
        batches = list(zip(port_loader, ref_loader, threaded))
        assert len(batches) == len(port_loader) > 0
        for got, want, got_threaded in batches:
            assert got[0]["x"].shape == (3, 500, 1)
            for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                               jax.tree.leaves(got_threaded)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                np.testing.assert_array_equal(np.asarray(c), np.asarray(b))


# -- F1: StreamingCodec.n_q ----------------------------------------------

def test_streaming_codec_n_q_is_fixed_when_built_as_in_jax():
    """Built at 1.5 kbps, models then set to 6 kbps: both packages stream 2
    stages; assigning `codec.n_q = 1` takes effect from the next chunk."""
    jm = jax_build_model([1.5, 6.0], seed=0, **TINY_24K)
    tm = _port_of(jm, build_model, [1.5, 6.0], seed=0, **TINY_24K)
    for m in (jm, tm):
        m.set_target_bandwidth(1.5)
    jcodec, tcodec = jstream.StreamingCodec(jm), StreamingCodec(tm)
    for m in (jm, tm):
        m.set_target_bandwidth(6.0)
    assert tm.n_q_active == jm.n_q_active > 2
    assert tcodec.n_q == jcodec.n_q == 2
    hop = tm.cfg.seanet.hop_length
    x = _randn(30, 1, 1, 18 * hop)
    first = tcodec.encode_chunk(torch.from_numpy(x[..., :12 * hop])).numpy()
    want = np.asarray(jcodec.encode_chunk(jnp.asarray(x[..., :12 * hop])))
    assert first.shape == want.shape == (1, 2, 12)
    np.testing.assert_array_equal(first, want)
    jcodec.n_q = tcodec.n_q = 1
    nxt = tcodec.encode_chunk(torch.from_numpy(x[..., 12 * hop:])).numpy()
    want = np.asarray(jcodec.encode_chunk(jnp.asarray(x[..., 12 * hop:])))
    assert nxt.shape == want.shape == (1, 1, 6)
    np.testing.assert_array_equal(nxt, want)
    # and the codec built with an explicit n_q keeps it
    assert StreamingCodec(tm, n_q=3).n_q == 3
