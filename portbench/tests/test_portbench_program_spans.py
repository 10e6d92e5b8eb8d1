"""The readers of the program's spans and counters (`lib/program_spans.py`
and the `program_span` / `program_counter` metrics) against fake records:
the per-unit arithmetic, and None where the records cannot stand for the
window (root spans that do not match its units, no records, no stream
times) or where the program keeps none."""

import typing as tp

import pytest

from portbench.lib import harness, program_spans, spec


class Rec(tp.NamedTuple):
    name: str
    parent: tp.Optional[str]
    start_ns: int
    end_ns: int
    stream_ms: tp.Optional[float]
    syncs: int


def _ctx(kind, units, work):
    return harness.MetricContext(kind, {}, {}, {}, None, units, work, {})


def _gen_step(syncs=10, adam=30.0, rvq=12.5):
    return [Rec("train.gen_step", None, 0, 9, 600.0, syncs),
            Rec("train.forward", "train.gen_step", 1, 5, 200.0, 8),
            Rec("rvq.train", "train.forward", 2, 3, rvq, 8),
            Rec("optim.adam", "train.gen_step", 6, 8, adam, 2)]


def _batch(syncs=1, enc=1.25, dec=0.5):
    return [Rec("codec.encode", None, 0, 4, 40.0, syncs),
            Rec("codec.input", "codec.encode", 0, 1, 0.5, syncs),
            Rec("rvq.encode", "codec.encode", 2, 3, enc, 0),
            Rec("codec.decode", None, 5, 9, 44.0, 0),
            Rec("rvq.decode", "codec.decode", 5, 6, dec, 0)]


TRAIN = ("optim_ms.train", "rvq_ms.train", "host_syncs.train")
CODEC = ("rvq_ms.codec", "host_syncs.codec")


def _read(name, m):
    return spec.reader(name)(m)


def test_per_unit_arithmetic(monkeypatch):
    recs = _gen_step() + _gen_step(syncs=10, adam=34.0, rvq=13.5) \
        + _gen_step(syncs=10, adam=32.0, rvq=14.5)
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    m = _ctx("train", 3, ["gen"] * 3)
    assert _read("optim_ms.train", m) == pytest.approx(32.0)
    assert _read("rvq_ms.train", m) == pytest.approx(13.5)
    assert _read("host_syncs.train", m) == 10
    assert all(_read(n, m) is None for n in CODEC)
    recs = _batch() * 12
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    m = _ctx("codec_batch", 12, ["batch"] * 12)
    assert _read("rvq_ms.codec", m) == pytest.approx(1.75)
    assert _read("host_syncs.codec", m) == 1
    assert all(_read(n, m) is None for n in TRAIN)


@pytest.mark.parametrize("kind,units,recs", [
    ("train", 3, _gen_step() * 2),                  # a root missing
    ("train", 2, _gen_step() * 3),                  # one too many
    ("codec_batch", 12, _batch() * 11),
    ("codec_batch", 2, _batch() + [r._replace(parent="other")
                                   for r in _batch()]),   # not roots
])
def test_none_when_the_root_spans_differ_from_the_units(monkeypatch, kind,
                                                        units, recs):
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    work = ["gen"] * units if kind == "train" else ["batch"] * units
    m = _ctx(kind, units, work)
    for name in TRAIN if kind == "train" else CODEC:
        assert _read(name, m) is None, name


def test_the_generator_calls_of_a_mix_are_the_train_roots(monkeypatch):
    disc = Rec("train.disc_step", None, 10, 12, 90.0, 4)
    recs = _gen_step() + _gen_step() + [disc]
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    m = _ctx("train", 2, ["gan_gen", "gen", "disc"])
    assert _read("host_syncs.train", m) == pytest.approx(12.0)
    assert _read("optim_ms.train", m) == pytest.approx(30.0)


@pytest.mark.parametrize("recs", [
    [],                                                     # no records
    [r._replace(stream_ms=None) for r in _gen_step()],      # the CPU
])
def test_none_without_records_or_stream_times(monkeypatch, recs):
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    m = _ctx("train", 1, ["gen"])
    assert all(_read(n, m) is None for n in TRAIN)


def test_a_program_that_keeps_no_records_reads_none(monkeypatch):
    from encodec_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    assert program_spans.program_records() == []
    for kind, names in (("train", TRAIN), ("codec_batch", CODEC)):
        m = _ctx(kind, 1, ["gen"] if kind == "train" else ["batch"])
        assert all(_read(n, m) is None for n in names)
