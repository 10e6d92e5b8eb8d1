"""The plain reference's GAN phase against the program's, at a tiny size
on the CPU: the GAN generator step and the discriminator step from the
same weights, batch, book and draws give the same losses and gradients.
No cell runs the GAN phase yet (PERF.md, Open questions): this holds the
reference ready for one."""

import statistics

import pytest
import torch

from portbench.lib import inputs, spec
from portbench.reference import rvq
from portbench.reference import seanet as ref_seanet
from portbench.reference import train as ref_train
from portbench.reference.arch import arch_from_config

TINY = {"config": {"model": {"filters": 8, "dimension": 16, "bins": 16}}}


def _gaps(prog: dict, ref: dict) -> float:
    med = statistics.median(v.norm().item() for v in ref.values())
    return max((prog[k] - ref[k]).norm().item()
               / max(ref[k].norm().item(), med) for k in ref)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from encodec_tpu_torch.quant import RVQState
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.steps import create_train_state

    cfg_file = spec.merge(spec.config("breathing_default"), TINY)
    cfg = cfg_file["config"]
    arch = arch_from_config(cfg_file)
    dev = torch.device("cpu")
    tr = Trainer(ConfigNamespace(cfg), None, None,
                 str(tmp_path_factory.mktemp("run")), device=dev)
    gen = inputs.device_generator(11, dev)
    inputs.fill_weights(tr.model.params, gen)
    tr.model.params = tr.model.params
    state = create_train_state(tr.model, tr.disc_cfg, seed=42)
    inputs.fill_weights(state.disc_params, gen)
    x = inputs.breathing(gen, 2, 30000, 10)[..., None].contiguous()
    with torch.no_grad():
        z = ref_seanet.encoder(state.params["encoder"], x.transpose(1, 2),
                               arch)
    books = rvq.drawn_books(z, arch["bins"], gen)
    state = state._replace(qstate=RVQState(
        *(t[None].clone() for t in books), inited=True))
    p0 = {k: v.clone() for k, v in ref_train.paths(
        {"params": state.params, "disc": state.disc_params}).items()}
    tree = ref_train.rebuild({"params": state.params,
                              "disc": state.disc_params}, p0)
    step = ref_train.Step(tree["params"], cfg, arch,
                          torch.Generator().manual_seed(42),
                          disc=tree["disc"], books=books)
    return tr, state, step, x, cfg


def test_gan_generator_step(setup):
    tr, state, step, x, cfg = setup
    w = tr.weights_for_epoch(100)
    _, m = tr.gen_step(state, x, w, use_gan=True, keep_grads=True)
    loss, clipped = step.gen_step(x, ref_train.weights_at(cfg, 100),
                                  gan=True, forced=m["codes"])
    assert loss == pytest.approx(m["loss"].item(), rel=1e-5)
    grads = ref_train.paths(m["grads"])
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = min(1.0, 0.1 / norm.item())
    assert _gaps({k: g * scale for k, g in grads.items()}, clipped) < 1e-3


def test_discriminator_step(setup):
    tr, state, step, x, cfg = setup
    _, md = tr.disc_step(state, x, tr.weights_for_epoch(100),
                         keep_grads=True)
    ref = ref_train.Step(step.tree, cfg, step.arch,
                         torch.Generator().manual_seed(42),
                         disc=step.disc_tree, books=step.books)
    loss, clipped = ref.disc_step(x, ref_train.weights_at(cfg, 100))
    assert loss == pytest.approx(md["loss_disc"].item(), rel=1e-5)
    grads = ref_train.paths(md["grads"], "")
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = min(1.0, 0.1 / norm.item())
    # the step's generator forward searches its own codes on each side
    # (the program does not return them to force); the program's own GAN
    # tests hold this gradient to 5e-3 (tests/test_torch_gan.py)
    assert _gaps({k: g * scale for k, g in grads.items()}, clipped) < 5e-3
