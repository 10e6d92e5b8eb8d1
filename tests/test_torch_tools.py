"""The port's tools and data modules against the JAX package's, on the CPU:
export (a run directory → a reference `.th`), the batch tool, the
benchmark, the figures and the hierarchy ablation, the profiling helpers,
the BWH loader and the curation, and the two repaired faults (F3:
`EncodecModel.get_lm_model`; F4: `decompress(device=...)`).

Models are the small ones of the other port tests (a 24 kHz-shaped codec
with 4 filters, D=16, 64 bins; the tiny breathing tokenizer of
`tests/test_tools.py`), with weights carried from the JAX package where
the two are compared. Tolerances: checkpoints, codes, `.ecdc` bytes, the
batch tool's wavs against per-file decoding, and the numpy-only data
modules are exact; latents and audio computed by the two packages agree
within 1e-4 (the decoder stacks' float32 tolerance of the other port
tests).
"""

import io
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encodec_tpu.data import bwh as jbwh
from encodec_tpu.data import curation as jcuration
from encodec_tpu.models.lm import LMConfig as JaxLMConfig
from encodec_tpu.models.lm import LMModel as JaxLMModel
from encodec_tpu.models.lm import init_lm as jax_init_lm
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.torch_zoo import (
    load_pretrained as jax_load_pretrained,
    torch_state_from_lm_params as jax_torch_state_from_lm_params,
    torch_state_from_params)
from encodec_tpu.quant.rvq import (
    rvq_intermediate_results as jax_rvq_intermediate_results)
from encodec_tpu.tools import batch as jbatch
from encodec_tpu.tools import visualize as jvisualize
from encodec_tpu_torch.data import bwh, curation
from encodec_tpu_torch.models import build_model, load_state
from encodec_tpu_torch.models import lm as tlm
from encodec_tpu_torch.models.zoo import (lm_params_from_jax,
                                          lm_params_from_state,
                                          load_pretrained,
                                          save_reference_checkpoint,
                                          state_from_params,
                                          torch_state_from_lm_params)
from encodec_tpu_torch.quant import rvq_intermediate_results
from encodec_tpu_torch.stream import compress, decompress
from encodec_tpu_torch.stream.compress import compress_to_file
from encodec_tpu_torch.tools import batch, benchmark, export, visualize
from encodec_tpu_torch.train import ConfigNamespace, Trainer
from encodec_tpu_torch.train.optim import tree_leaves
from encodec_tpu_torch.utils.audio import convert_audio, load_wav, save_wav
from encodec_tpu_torch.utils import profiling
from encodec_tpu_torch.utils.profiling import device_trace, span

CODEC_24 = dict(sample_rate=24000, channels=1, causal=True,
                model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
                dimension=16, n_filters=4, kmeans_init=False)
BREATHING = dict(sample_rate=10, channels=1, causal=True,
                 model_norm="layer_norm", name="breathing_model",
                 ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                 decoder_final_norm="none", shared_codebook=True,
                 kmeans_init=False, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def codecs():
    """The small 24 kHz-shaped codec in both packages (the same weights),
    named `encodec_24khz`, at 1.5 kbps, with an LM of its n_q."""
    jm = jax_build_model([1.5], name="encodec_24khz", seed=0, **CODEC_24)
    tm = build_model([1.5], name="encodec_24khz", seed=0, device="cpu",
                     **CODEC_24)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    jm.set_target_bandwidth(1.5)
    tm.set_target_bandwidth(1.5)
    cfg = dict(n_q=tm.cfg.rvq.n_q, card=64, dim=16, num_heads=2,
               num_layers=1, past_context=20)
    jlm = JaxLMModel(JaxLMConfig(**cfg),
                     jax_init_lm(jax.random.PRNGKey(0), JaxLMConfig(**cfg)))
    tlm_ = tlm.LMModel(tlm.LMConfig(**cfg), lm_params_from_jax(
        jax.tree.map(np.asarray, jlm.params)), device="cpu")
    return dict(jm=jm, tm=tm, jlm=jlm, tlm=tlm_,
                jreg={jm.name: lambda pretrained=True: jm},
                treg={tm.name: lambda pretrained=True: tm})


def _wavs(directory, lengths, seed, prefix="f"):
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, T in enumerate(lengths):
        save_wav(rng.randn(1, T).astype(np.float32) * 0.2,
                 directory / f"{prefix}{i}.wav", 24000)


@pytest.fixture(scope="module")
def published(codecs, tmp_path_factory):
    """A local repository holding a seeded LM of the published LM
    configuration of the small codec (dim 200, 5 layers, W=262) as the 24
    kHz model's LM checkpoint (the LM loader checks no checksum)."""
    cfg = tlm.lm_config_for(codecs["tm"])
    lm = tlm.LMModel(cfg, tlm.init_lm(torch.Generator().manual_seed(5), cfg),
                     device="cpu")
    path = tmp_path_factory.mktemp("lm_repository")
    state = {k: torch.from_numpy(v)
             for k, v in torch_state_from_lm_params(lm.params).items()}
    torch.save(state, path / "encodec_lm_24khz-1608e3c0.th")
    return str(path), lm


# -- the faults -------------------------------------------------------------

def test_f3_model_get_lm_model_reads_the_repository(codecs, published):
    tm, (rep, lm) = codecs["tm"], published
    got = tm.get_lm_model(rep)
    assert got.device == tm.device and got.cfg.n_q == tm.cfg.rvq.n_q
    for a, b in zip(tree_leaves(got.params), tree_leaves(lm.params)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="repository"):
        tm.get_lm_model()


def test_f4_decompress_builds_the_registry_model_on_device(
        codecs, published, monkeypatch):
    """With `models=None`, `decompress` builds the registry's model (and the
    LM from `repository`) on `device`; the default device is `cuda`."""
    import encodec_tpu_torch.models.model as model_mod
    from encodec_tpu_torch.device import resolve_device

    tm = codecs["tm"]
    seen = []

    def factory(pretrained=True, repository=None, device="cuda"):
        seen.append((str(device), repository))
        resolve_device(device)
        return tm

    monkeypatch.setitem(model_mod.MODELS, "encodec_24khz", factory)
    rep, lm = published
    wav = np.random.RandomState(4).randn(1, 3200).astype(np.float32) * 0.2
    raw = compress(tm, wav)
    coded = compress(tm, wav, use_lm=True, lm=lm)
    want, _ = decompress(raw, models=codecs["treg"])
    for data in (raw, coded):
        got, sr = decompress(data, device="cpu", repository=rep)
        assert sr == 24000 and torch.equal(got, want)
    assert seen == [("cpu", rep), ("cpu", rep)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompress(raw, repository=rep)


# -- the writers and export -------------------------------------------------

def test_lm_state_writer_equals_jax_and_reads_back(codecs):
    jstate = jax_torch_state_from_lm_params(
        jax.tree.map(np.asarray, codecs["jlm"].params))
    tstate = torch_state_from_lm_params(codecs["tlm"].params)
    assert sorted(jstate) == sorted(tstate)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k], jstate[k], err_msg=k)
    back = lm_params_from_state(tstate, codecs["tlm"].cfg.n_q, 1)
    for a, b in zip(tree_leaves(back), tree_leaves(codecs["tlm"].params)):
        assert torch.equal(a, b)


def _train_config(tmp_path):
    from tests.test_torch_train import CONFIG
    cfg = json.loads(json.dumps(CONFIG))
    cfg["dataset"]["root"] = str(tmp_path)
    return cfg


def test_export_of_a_port_run_reloads_bit_for_bit_in_both_packages(tmp_path):
    """A run directory the port's Trainer wrote (config.json, the port's
    `.ckpt`) → `tools.export` → a `.th` named by its sha256 that the port's
    and the JAX package's `load_pretrained` read back bit for bit."""
    from encodec_tpu.train.trainer import model_from_config as jax_mfc
    from encodec_tpu_torch.train.trainer import model_from_config

    cfg = _train_config(tmp_path)
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps(cfg))
    trainer = Trainer(ConfigNamespace(cfg), [], [], str(run), device="cpu")
    trainer.save(4)
    path = export.main([str(run), "--out", str(tmp_path / "out"),
                        "--device", "cpu"])
    name = os.path.basename(path)
    assert name.startswith("my_encodec-") and name.endswith(".th")
    fresh = model_from_config(ConfigNamespace(cfg), device="cpu")
    load_pretrained(fresh, name, str(tmp_path / "out"))
    for a, b in zip(tree_leaves(fresh.params),
                    tree_leaves(trainer.state.params)):
        assert torch.equal(a, b)
    for a, b in zip(fresh.qstate[:3], trainer.state.qstate[:3]):
        assert torch.equal(a, b)
    jm = jax_mfc(ConfigNamespace(cfg))
    jax_load_pretrained(jm, name, str(tmp_path / "out"))
    want = state_from_params(fresh.params, fresh.qstate, fresh.cfg)
    got = torch_state_from_params(jm.params, jm.qstate, jm.cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_export_of_a_jax_run_equals_the_jax_tool(tmp_path, monkeypatch):
    """A JAX-written run (config.yaml, a JAX `.ckpt`) exports to the same
    state dict as the JAX package's own `tools.export`."""
    pytest.importorskip("yaml")
    import yaml

    from encodec_tpu.tools.export import export_run as jax_export_run
    from encodec_tpu.train import create_train_state as jax_cts
    from encodec_tpu.train import save_checkpoint as jax_save_checkpoint
    from encodec_tpu.train.config import ConfigNamespace as JaxNS
    from encodec_tpu.train.trainer import model_from_config as jax_mfc

    cfg = _train_config(tmp_path)
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text(yaml.dump(cfg))
    jstate, _, _ = jax_cts(jax_mfc(JaxNS(cfg)), seed=0)
    jax_save_checkpoint(jstate, 2, run / "model.ckpt", extra={"config": cfg})
    jpath = jax_export_run(str(run), str(tmp_path / "jax"))
    tpath = export.export_run(str(run), str(tmp_path / "port"), device="cpu")
    want = torch.load(jpath, weights_only=True)
    got = torch.load(tpath, weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_save_reference_checkpoint_names_the_file_by_its_hash(codecs,
                                                              tmp_path):
    import hashlib
    path = save_reference_checkpoint(codecs["tm"], tmp_path, name="enc")
    sha = hashlib.sha256(open(path, "rb").read()).hexdigest()[:8]
    assert os.path.basename(path) == f"enc-{sha}.th"
    assert not (tmp_path / "export_tmp.th").exists()


# -- the batch tool ----------------------------------------------------------

@pytest.mark.parametrize("use_lm", [False, True], ids=["raw", "lm"])
def test_batch_compress_equals_jax_tool_and_per_file(codecs, tmp_path,
                                                     use_lm):
    """`compress_directory` (the streaming extractor, chunks of 8 hops)
    writes the bytes of the JAX tool and of per-file `compress_to_file`,
    for lengths that are and are not hop multiples."""
    jm, tm = codecs["jm"], codecs["tm"]
    _wavs(tmp_path / "wavs", [2400, 3201, 4807], seed=3)
    kw = dict(use_lm=use_lm, chunk_hops=8)
    tpaths = batch.compress_directory(tm, str(tmp_path / "wavs"),
                                      str(tmp_path / "t"), lm=codecs["tlm"],
                                      models=codecs["treg"], **kw)
    jpaths = jbatch.compress_directory(jm, str(tmp_path / "wavs"),
                                       str(tmp_path / "j"), lm=codecs["jlm"],
                                       models=codecs["jreg"], **kw)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths] == ["f0.ecdc", "f1.ecdc",
                                                  "f2.ecdc"]
    for i, (tp_, jp) in enumerate(zip(tpaths, jpaths)):
        data = open(tp_, "rb").read()
        assert data == open(jp, "rb").read(), tp_
        wav, sr = load_wav(tmp_path / "wavs" / f"f{i}.wav")
        ref = io.BytesIO()
        compress_to_file(tm, convert_audio(wav, sr, 24000, 1), ref,
                         use_lm=use_lm, lm=codecs["tlm"],
                         models=codecs["treg"])
        assert data == ref.getvalue(), tp_


def test_compress_seams_equal_jax(codecs):
    """`compress(tie_guard=False)` (the plain encode) and
    `compress_to_file(frames=...)` (the caller's codes) write the JAX
    writer's bytes."""
    from encodec_tpu.stream import compress as jax_compress
    from encodec_tpu.stream.compress import \
        compress_to_file as jax_compress_to_file

    jm, tm = codecs["jm"], codecs["tm"]
    wav = np.random.RandomState(6).randn(1, 4000).astype(np.float32) * 0.2
    assert compress(tm, wav, tie_guard=False) == jax_compress(
        jm, wav, tie_guard=False)
    codes = np.random.RandomState(7).randint(0, 64, (1, tm.n_q_active, 13))
    ours, theirs = io.BytesIO(), io.BytesIO()
    compress_to_file(tm, wav, ours, frames=[(torch.from_numpy(codes), None)])
    jax_compress_to_file(jm, wav, theirs,
                         frames=[(jnp.asarray(codes), None)])
    assert ours.getvalue() == theirs.getvalue()


def test_batch_compress_warns_once_on_sub_chunk_files(codecs, tmp_path):
    _wavs(tmp_path / "wavs", [2400, 2560], seed=7)
    with pytest.warns(UserWarning, match="shorter than the shared") as rec:
        paths = batch.compress_directory(codecs["tm"], str(tmp_path / "wavs"),
                                         str(tmp_path / "out"),
                                         models=codecs["treg"],
                                         chunk_hops=64)
    assert len(paths) == 2 and len(rec) == 1


def test_batch_decompress_lockstep_equals_per_file_and_jax(codecs, tmp_path):
    """`decompress_directory` over 4 lmv=3 files and 1 raw file: lockstep
    lanes (3 per lockstep, so a short second lane) write the same wavs as
    `lockstep=1` and as per-file `decompress`; `pcm16` writes the same
    files; the JAX tool's wavs agree within 2 int16 steps (its bucketed
    decode and float32 noise); the model and the LM are built once; a
    corrupted stream fails its CRC naming the file."""
    import encodec_tpu_torch.models.lm as lm_mod

    tm, lm = codecs["tm"], codecs["tlm"]
    _wavs(tmp_path / "lmw", [2560, 3201, 2560, 4481], seed=17, prefix="s")
    _wavs(tmp_path / "raww", [2909], seed=18, prefix="raw")
    ec = tmp_path / "ecdc"
    batch.compress_directory(tm, str(tmp_path / "lmw"), str(ec), use_lm=True,
                             lm=lm, models=codecs["treg"], chunk_hops=8)
    batch.compress_directory(tm, str(tmp_path / "raww"), str(ec),
                             models=codecs["treg"], chunk_hops=8)
    built, lms = [], []
    reg = {tm.name: lambda pretrained=True: (built.append(1), tm)[1]}
    lm_mod_get = lm_mod.get_lm_model
    try:
        lm_mod.get_lm_model = lambda m, repository=None: (lms.append(1),
                                                          lm)[1]
        out_ls = batch.decompress_directory(str(ec), str(tmp_path / "ls"),
                                            models=reg, lockstep=3)
    finally:
        lm_mod.get_lm_model = lm_mod_get
    assert len(built) == 1 and len(lms) == 1
    out_pf = batch.decompress_directory(str(ec), str(tmp_path / "pf"),
                                        models=codecs["treg"], lm=lm,
                                        lockstep=1)
    out_16 = batch.decompress_directory(str(ec), str(tmp_path / "p16"),
                                        models=codecs["treg"], lm=lm,
                                        pcm16=True)
    out_j = jbatch.decompress_directory(str(ec), str(tmp_path / "j"),
                                        models=codecs["jreg"],
                                        lm=codecs["jlm"])
    assert len(out_ls) == len(out_pf) == len(out_16) == len(out_j) == 5
    for a, b, c, j in zip(out_ls, out_pf, out_16, out_j):
        assert os.path.basename(a) == os.path.basename(j)
        assert open(a, "rb").read() == open(b, "rb").read() \
            == open(c, "rb").read(), a
        with open(ec / (os.path.basename(a)[:-4] + ".ecdc"), "rb") as fo:
            wav, sr = decompress(fo.read(), models=codecs["treg"], lm=lm)
        save_wav(wav.numpy(), tmp_path / "ref.wav", sr)
        assert open(tmp_path / "ref.wav", "rb").read() == \
            open(a, "rb").read(), a
        wa = np.frombuffer(open(a, "rb").read()[44:], np.int16)
        wj = np.frombuffer(open(j, "rb").read()[44:], np.int16)
        assert np.abs(wa.astype(int) - wj.astype(int)).max() <= 2, a
    victim = ec / "s2.ecdc"
    blob = bytearray(victim.read_bytes())
    blob[-3] ^= 0xFF
    victim.write_bytes(bytes(blob))
    with pytest.raises((ValueError, EOFError)) as exc:
        batch.decompress_directory(str(ec), str(tmp_path / "bad"),
                                   models=codecs["treg"], lm=lm, lockstep=3)
    if isinstance(exc.value, ValueError):
        assert "s2" in str(exc.value)


def test_batch_main_decompresses_with_device(codecs, tmp_path, monkeypatch):
    import encodec_tpu_torch.models.model as model_mod

    tm = codecs["tm"]
    monkeypatch.setitem(model_mod.MODELS, "encodec_24khz",
                        lambda pretrained=True, repository=None,
                        device="cuda": tm if str(device) == "cpu" else None)
    _wavs(tmp_path / "w", [3200], seed=9)
    batch.compress_directory(tm, str(tmp_path / "w"), str(tmp_path / "e"),
                             models=codecs["treg"], chunk_hops=8)
    paths = batch.main([str(tmp_path / "e"), str(tmp_path / "o"),
                        "--decompress", "--device", "cpu"])
    wav, sr = load_wav(paths[0])
    assert sr == 24000 and wav.shape == (1, 3200)


def test_tool_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a GPU, the tools' command lines raise unless `--device cpu`
    is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "e").mkdir()
    for main, argv in ((batch.main, [str(tmp_path / "e"), str(tmp_path / "o"),
                                     "--decompress"]),
                       (benchmark.main, []),
                       (export.main, [str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


# -- quantizer probe, figures, benchmark, profiling --------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = jax_build_model([0.08], **BREATHING)
    tm = build_model([0.08], device="cpu", **BREATHING)
    load_state(tm, torch_state_from_params(jm.params, jm.qstate, jm.cfg))
    return jm, tm


def test_rvq_intermediate_results_and_hierarchy_ablation_equal_jax(tiny,
                                                                   codecs):
    jm, tm = tiny
    rng = np.random.RandomState(2)
    for jmod, tmod in ((jm, tm), (codecs["jm"], codecs["tm"])):
        emb = rng.randn(2, 9, 16).astype(np.float32)
        want = jax_rvq_intermediate_results(jmod.qstate, jnp.asarray(emb),
                                            jmod.cfg.rvq, n_q=3)
        got = rvq_intermediate_results(tmod.qstate, torch.from_numpy(emb),
                                       tmod.cfg.rvq, n_q=3)
        np.testing.assert_array_equal(got["codes"].numpy(),
                                      np.asarray(want["codes"]))
        for k in ("quantized", "quantized_stack"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)
    x = rng.randn(1, 600).astype(np.float32)
    for kw in (dict(start=0), dict(start=0, depth=2), dict(start=4)):
        np.testing.assert_allclose(
            visualize.hierarchy_ablation(tm, x, **kw),
            jvisualize.hierarchy_ablation(jm, x, **kw), rtol=1e-4, atol=1e-4)
    assert not np.allclose(visualize.hierarchy_ablation(tm, x),
                           visualize.hierarchy_ablation(tm, x, depth=2))


def test_figures_are_written(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(600).astype(np.float32)
    visualize.reconstruction_figure(x, 0.9 * x, n_fft=64, win_length=64,
                                    hop_length=16,
                                    path=str(tmp_path / "rec.png"))
    items = [rng.randn(1, 3000) for _ in range(3)]
    flat = rng.randn(3000)
    flat[1000:2500] = 0.5
    visualize.data_distribution_figure(items, path=str(tmp_path / "d.png"))
    visualize.patients_distribution_figure(
        [{"x": v, "filename": f"n{i}.npz"} for i, v in enumerate(items)],
        grid=(1, 3), path=str(tmp_path / "p.png"))
    visualize.zero_runs_figure([flat], window=1000,
                               path=str(tmp_path / "z.png"))
    for name in ("rec", "d", "p", "z"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_trainer_evaluate_draws_the_figure_or_says_once(tmp_path,
                                                        monkeypatch, caplog):
    import importlib.util

    cfg = _train_config(tmp_path)
    rng = np.random.RandomState(3)
    val = [({"x": rng.randn(2, 600, 1).astype(np.float32)}, np.zeros(2))]
    trainer = Trainer(ConfigNamespace(cfg), [], val, str(tmp_path / "r"),
                      device="cpu")
    out = trainer.evaluate(1)
    assert np.isfinite(out["Loss"]) and (tmp_path / "r" / "1.png").exists()
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else find_spec(name, *a))
    with caplog.at_level(logging.WARNING):
        trainer.evaluate(2)
        trainer.evaluate(3)
    said = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(said) == 1
    assert not (tmp_path / "r" / "2.png").exists()


def test_bench_on_the_cpu_returns_its_keys(codecs):
    res = benchmark.bench(codecs["tm"], lm=codecs["tlm"], seconds=0.2,
                          bandwidth=1.5, iters=1)
    assert res["device"] == "cpu" and res["encode_rtf"] > 0
    for key in ("decode_s", "lm_batched_s", "lm_tokens_per_s",
                "ac_encode_s", "ac_decode_s", "ac_bytes"):
        assert res[key] > 0, key
    assert set(benchmark.bench(codecs["tm"], seconds=0.2, bandwidth=1.5,
                               iters=1)).isdisjoint({"lm_batched_s"})


def test_device_trace_holds_the_spans_of_its_block(tmp_path):
    """`device_trace` writes a trace file that names the spans opened in
    its block, and keeps their records, a span that raises included;
    outside the block spans are off again and record nothing."""
    profiling.reset()
    with device_trace(str(tmp_path / "trace")):
        for _ in range(3):
            with span("sin"):
                torch.sin(torch.ones(256)).sum()
        with pytest.raises(RuntimeError):
            with span("boom"):
                raise RuntimeError("x")
    with span("after"):
        torch.ones(8).add_(1)
    files = list((tmp_path / "trace").rglob("*.json"))
    assert files
    text = files[0].read_text()
    assert '"sin"' in text and '"boom"' in text and '"after"' not in text
    recs = profiling.records()
    assert [r.name for r in recs] == ["sin"] * 3 + ["boom"]
    assert all(r.end_ns >= r.start_ns for r in recs)
    profiling.reset()


# -- data: BWH and curation ---------------------------------------------------

def test_curation_and_bwh_equal_the_jax_modules(tmp_path):
    raw = tmp_path / "thorax"
    raw.mkdir()
    rng = np.random.RandomState(0)
    T = 200 * 60 * 8
    for i in range(4):
        sig = np.sin(np.arange(T) * 2 * np.pi * 0.3 / 200) \
            + 0.05 * rng.randn(T)
        if i == 1:
            sig[T // 2:T // 2 + 3000] = 0.25             # a flat interior
        np.savez(raw / f"n{i}.npz", data=sig.astype(np.float32), fs=200)
    x = np.load(raw / "n1.npz")["data"]
    np.testing.assert_array_equal(curation.sliding_std(x, 500),
                                  jcuration.sliding_std(x, 500))
    np.testing.assert_array_equal(curation.find_constant_spans(x, 1000),
                                  jcuration.find_constant_spans(x, 1000))
    assert curation.find_fns_to_ignore(str(raw), 1000) == \
        jcuration.find_fns_to_ignore(str(raw), 1000)
    outs = {}
    for name, mod in (("port", curation), ("jax", jcuration)):
        outs[name] = mod.curate_directory(
            str(raw), str(tmp_path / name / "thorax_clipped"), fs=200,
            window_sec=5.0, min_valid_hours=0.01,
            csv_path=str(tmp_path / f"{name}.csv"),
            blocklist_path=str(tmp_path / f"{name}.py"))
    assert outs["port"] == outs["jax"]
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    for f in sorted(os.listdir(tmp_path / "jax" / "thorax_clipped")):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "thorax_clipped" / f)["data"],
            np.load(tmp_path / "jax" / "thorax_clipped" / f)["data"])
    items = {}
    for name, mod in (("port", bwh), ("jax", jbwh)):
        root = str(tmp_path / name)
        val = mod.BwhDataset(root, mode="val", max_length=600,
                             rng=np.random.RandomState(1))
        train = mod.BwhDataset(root, mode="train", max_length=500,
                               rng=np.random.RandomState(2))
        assert train.build_cache() == 3
        items[name] = [val[0], train[0], train[1]]
    for a, b in zip(items["port"], items["jax"]):
        assert a["filename"] == b["filename"] and a["x"].shape == b["x"].shape
        np.testing.assert_array_equal(a["x"], b["x"])
    with pytest.raises(ValueError, match="thorax"):
        bwh.BwhDataset(str(tmp_path / "port"), channels={"abdominal": 1.0})


def test_new_modules_import_without_matplotlib_or_yaml():
    """The machine with the card has neither: the new modules import
    without them (the figure functions and YAML configs import lazily)."""
    import subprocess
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "sys.modules['yaml'] = None; "
            "import encodec_tpu_torch.tools.visualize, "
            "encodec_tpu_torch.tools.export, encodec_tpu_torch.tools.batch, "
            "encodec_tpu_torch.tools.benchmark, "
            "encodec_tpu_torch.train.lm_train, "
            "encodec_tpu_torch.utils.profiling, encodec_tpu_torch.data.bwh")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
