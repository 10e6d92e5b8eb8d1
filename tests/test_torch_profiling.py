"""The port's spans and counters (`encodec_tpu_torch.utils.profiling`) on
the CPU: off, a span is one shared no-op context; on, under a
`torch.profiler` in its active phase only, or under `tracing()`, each span
is the profiler's own range on the same host clock and keeps a record;
a tiny generator step and a tiny encode and decode record the span tree
the module's docstring lists, with no host sync on the CPU.

The card's side (the `sync.*` counters against CUDA's sync debug mode) is
in `tests/test_torch_cuda.py`.
"""

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from encodec_tpu_torch.models import build_model
from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                     make_train_steps)
from encodec_tpu_torch.utils import profiling
from encodec_tpu_torch.utils.profiling import span

BREATHING = dict(sample_rate=10, channels=1, causal=True,
                 model_norm="layer_norm", name="breathing_model",
                 ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
                 decoder_final_norm="none", shared_codebook=True,
                 kmeans_init=False, seed=3)
CODEC_24 = dict(sample_rate=24000, channels=1, causal=True,
                model_norm="weight_norm", ratios=[8, 5, 4, 2], bins=64,
                dimension=16, n_filters=4, kmeans_init=False)

# (name, parent) of each span, in the order they open
GEN_STEP_TREE = [("train.gen_step", None), ("train.forward", "train.gen_step"),
                 ("seanet.encoder", "train.forward"),
                 ("rvq.train", "train.forward"),
                 ("seanet.decoder", "train.forward"),
                 ("train.loss", "train.gen_step"),
                 ("train.backward", "train.gen_step"),
                 ("optim.adam", "train.gen_step")]
CODEC_TREE = [("codec.encode", None), ("codec.input", "codec.encode"),
              ("seanet.encoder", "codec.encode"),
              ("rvq.encode", "codec.encode"),
              ("codec.decode", None), ("rvq.decode", "codec.decode"),
              ("seanet.decoder", "codec.decode")]


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _tree(records):
    return [(r.name, r.parent) for r in records]


def test_off_is_one_shared_null_context_without_record_function(
        monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = span("a"), span("b")
    assert first is second
    with first:
        with second:
            profiling.count("sync.test")
    assert profiling.records() == []
    assert profiling.counters()["sync.test"] == 1


def test_only_the_profilers_active_phase_records():
    """The benchmark's window: one unit in the warm-up phase, then the
    active phase; spans before, in warm-up and after record nothing."""
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: None) as prof:
        with span("warmup"):
            torch.ones(4).add_(1)
        prof.step()
        with span("active"):
            with span("inner"):
                torch.ones(4).add_(1)
        prof.step()
    with span("after"):
        pass
    assert _tree(profiling.records()) == [("active", None),
                                          ("inner", "active")]


def test_spans_are_the_profilers_ranges_on_its_clock():
    """Each span is among the profiler's events by its name, and its
    record's host interval lies inside that event's, within 50 us (the
    median gap; every interval nested up to rounding)."""
    got = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(
                     (p.events(), p.profiler.kineto_results.trace_start_ns()))
                 ) as prof:
        prof.step()
        for i in range(20):
            with span(f"clock.{i}"):
                torch.ones(64).add_(1)
        prof.step()
    events, t0 = got[0]
    by_name = {e.name: e for e in events if e.name.startswith("clock.")}
    recs = profiling.records()
    assert [r.name for r in recs] == [f"clock.{i}" for i in range(20)]
    starts, ends = [], []
    for r in recs:
        e = by_name[r.name]
        starts.append((r.start_ns - t0) / 1e3 - e.time_range.start)
        ends.append(e.time_range.end - (r.end_ns - t0) / 1e3)
    assert min(starts + ends) > -5.0, (starts, ends)       # us, rounding
    assert statistics.median(starts) < 50.0, starts
    assert statistics.median(ends) < 50.0, ends


def test_records_counters_reset_and_the_cap(monkeypatch):
    with profiling.tracing():
        with span("outer"):
            profiling.count("sync.a", 2)
            with span("inner"):
                profiling.count("sync.b")
                profiling.count("calls")
    with span("off again"):
        profiling.count("sync.c")
    recs = profiling.records()
    assert _tree(recs) == [("outer", None), ("inner", "outer")]
    assert [r.syncs for r in recs] == [3, 1]
    assert all(r.end_ns >= r.start_ns for r in recs)
    if not torch.cuda.is_initialized():
        assert all(r.stream_ms is None for r in recs)
    c = profiling.counters()
    assert (c["sync.a"], c["sync.b"], c["sync.c"], c["calls"]) == (2, 1, 1, 1)
    assert "launch.lstm_scan" in c and "spans.dropped" not in c
    profiling.reset()
    assert profiling.records() == [] and "sync.a" not in profiling.counters()
    monkeypatch.setattr(profiling, "MAX_RECORDS", 2)
    profiling.enable()
    for name in "xyz":
        with span(name):
            pass
    profiling.enable(False)
    assert [r.name for r in profiling.records()] == ["x", "y"]
    assert profiling.counters()["spans.dropped"] == 1


def test_gen_step_records_its_span_tree_without_syncs():
    model = build_model([0.08], device="cpu", **BREATHING)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 600, 1)
                         .astype(np.float32))
    gen = make_train_steps(model.cfg, freq_loss_kwargs=dict(
        n_fft=64, win_length=64, hop_length=16, sampling_rate=10))[0]
    state = create_train_state(model, seed=0)
    w = LossWeights.make(commit=0.25)
    state, _ = gen(state, x, w)                  # off: nothing recorded
    assert profiling.records() == []
    with profiling.tracing():
        gen(state, x, w)
    recs = profiling.records()
    assert _tree(recs) == GEN_STEP_TREE
    assert all(r.syncs == 0 for r in recs)
    if not torch.cuda.is_initialized():
        assert all(r.stream_ms is None for r in recs)
    assert not any(k.startswith("sync.") for k in profiling.counters())


def test_encode_and_decode_record_their_span_tree_without_syncs():
    model = build_model([1.5], name="encodec_24khz", seed=0, device="cpu",
                        **CODEC_24)
    model.set_target_bandwidth(1.5)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 1, 2400)
                         .astype(np.float32) * 0.1)
    with profiling.tracing():
        model.decode(model.encode(x))
    recs = profiling.records()
    assert _tree(recs) == CODEC_TREE
    assert all(r.syncs == 0 for r in recs)
    assert not any(k.startswith("sync.") for k in profiling.counters())
