"""The correctness check catches each fault a cell can have: the harness
driven on the CPU at a tiny size (the look for a card skipped) over a
program broken underneath it, its limits the cell's own, sees `correct`
come out false. One cell runs on one chip, so no exchange between chips
can be left out."""

import pytest

from portbench.tests.test_portbench_run import run_tiny


def _break_gen_step(monkeypatch, wrap):
    from encodec_tpu_torch.train import trainer

    make = trainer.make_train_steps

    def broken(*args, **kwargs):
        gen_step, disc_step, eval_step, balanced = make(*args, **kwargs)
        return wrap(gen_step), disc_step, eval_step, balanced

    monkeypatch.setattr(trainer, "make_train_steps", broken)


TRAIN = ["breathing_default.recon"]


@pytest.mark.parametrize("cell", TRAIN + ["encodec_24khz.batch16"])
def test_sound_tiny_runs_are_correct(cell, capsys):
    line, _ = run_tiny(cell, capsys)
    assert line["correct"] is True, (cell, line["checks"])


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch, capsys):
    def wrap(gen_step):
        def step(state, x, weights, use_gan=False, keep_grads=False):
            _, metrics = gen_step(state, x, weights, use_gan, keep_grads)
            return state, metrics
        return step

    _break_gen_step(monkeypatch, wrap)
    line, _ = run_tiny(cell, capsys)
    assert line["correct"] is False
    change = [c for k, c in line["checks"].items() if k.startswith("change")]
    assert change and all(c["value"] > 0.5 for c in change)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch, capsys):
    def wrap(gen_step):
        def step(state, x, weights, use_gan=False, keep_grads=False):
            return gen_step(state, x[:x.shape[0] // 2], weights, use_gan,
                            keep_grads)
        return step

    _break_gen_step(monkeypatch, wrap)
    line, _ = run_tiny(cell, capsys)
    assert line["correct"] is False


@pytest.mark.parametrize("where", ["code", "audio"])
def test_an_answer_altered_where_it_is_produced(where, monkeypatch, capsys):
    from encodec_tpu_torch.models import model

    if where == "code":
        encode = model.EncodecModel.encode

        def altered(self, x):
            frames = encode(self, x)
            codes = frames[0][0].clone()
            codes[0, 0, 0] = (codes[0, 0, 0] + 1) % self.cfg.rvq.bins
            return [(codes, frames[0][1])] + frames[1:]

        monkeypatch.setattr(model.EncodecModel, "encode", altered)
    else:
        decode = model.EncodecModel.decode

        def altered(self, frames, pcm16=False):
            out = decode(self, frames, pcm16).clone()
            out[0, 0, 100] += 0.05 * out.abs().max()
            return out

        monkeypatch.setattr(model.EncodecModel, "decode", altered)
    line, _ = run_tiny("encodec_24khz.batch16", capsys)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if c["value"] > c["limit"]]
    assert failed and all(k.startswith(where) for k in failed)


@pytest.mark.parametrize("where", ["stages", "length"])
def test_less_served_than_the_traffic_asks(where, monkeypatch, capsys):
    """A program that serves 2 stages where 6 kbps asks for 8, or audio
    shorter than the clips, has served another answer (and a faster one)."""
    from encodec_tpu_torch.models import model

    if where == "stages":
        set_bw = model.EncodecModel.set_target_bandwidth

        def ignored(self, bandwidth):
            set_bw(self, min(self.cfg.target_bandwidths))

        monkeypatch.setattr(model.EncodecModel, "set_target_bandwidth",
                            ignored)
    else:
        decode = model.EncodecModel.decode

        def shortened(self, frames, pcm16=False):
            out = decode(self, frames, pcm16)
            return out[..., :out.shape[-1] // 2]

        monkeypatch.setattr(model.EncodecModel, "decode", shortened)
    line, _ = run_tiny("encodec_24khz.batch16", capsys)
    assert line["correct"] is False
    failed = {k for k, c in line["checks"].items()
              if c["value"] > c["limit"]}
    assert failed == ({"code_mean_gap", "audio_gap"} if where == "stages"
                      else {"audio_gap"})
    assert all(line["checks"][k]["value"] == 1.0 for k in failed)
