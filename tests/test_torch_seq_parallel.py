"""The data×seq training step (`distributed.seq_parallel`) on the CPU: the
port's step on a 2 x 2 data × seq mesh against its single-process step on
the same global batch and against JAX's 2-D-mesh step; the differentiable
collectives under `torch.autograd.gradcheck`; the refusals of sharded
time; `python -m encodec_tpu_torch.train` with `seq_parallel: 2`, saved
asynchronously and resumed.

One gloo world of 4 ranks per module (data 2 × seq 2; the rank functions
in `tests/test_torch_parallel_ranks.py`, a file store under the module's
temporary directory) runs every case (`seq_cases`) on its data rows of
the global batch (B=4 × T=1200, 2 rows per data rank, each seq rank
600 samples of them); while it runs, the test process runs the same cases
without a mesh and JAX's steps on `encodec_tpu.parallel.make_mesh_2d(2,
2)`. The model and discriminator are JAX's tiny ones
(`tests/test_train.py:311-352`).

Bounds. `tests/test_train.py:311-352`'s: losses rtol 1e-4; the parameters
rtol 2e-3, atol 2e-5 where the gradient is above its noise, within 2·lr
elsewhere (`tests/test_torch_parallel_train.py`: Adam's first update is
±lr·sign(g)); the codebook state and the balancer's rtol 2e-3, atol
2e-5. The gradient, leaf by leaf, within `GRAD_REL` = 2e-4 of its leaf's
plus the whole gradient's largest |value| (PR 14's data-parallel bound):
a leaf whose gradient came out `seq` times too large, the fault the
step's cotangent convention prevents, is off by 100% of itself. Measured
here: 6.6e-5 of that sum for the GAN generator step (each seq shard's
convs run at half the length, so oneDNN rounds otherwise), 5e-8 for the
discriminator. The four ranks' states are equal bit for bit, and their
generator states equal the single process's.
"""

import json

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.models import msstftd as jmsstftd
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu_torch.models import build_model, params_from_jax
from encodec_tpu_torch.models.zoo import msstftd_params_from_jax
from encodec_tpu_torch.train import load_checkpoint
from encodec_tpu_torch.train.trainer import state_to_device
from tests import test_torch_parallel_ranks as ranks
from tests.test_torch_parallel_train import (GRAD_REL, _above_noise, _close,
                                             _close_after_adam, _equal)
from tests.test_torch_train import (CONFIG, _close_grads, _leaves, _nights,
                                    _rel)

WORLD, DATA, SEQ = 4, 2, 2
SEQ_BF16_REL = 2e-2   # the bf16 steps' metrics (measured up to 5.4e-3)
TIE = 1e-3
MAIN_SIZES = (8, 4)   # training and validation items of the cut epochs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_steps(jm, jstate, disc_state):
    """JAX's steps on the 2 x 2 data × seq mesh (the first 4 of the 8
    virtual devices): the generator step, the chunked GAN generator and
    discriminator steps, the eval step."""
    mesh = jax_make_mesh_2d(DATA, SEQ)
    jw = JaxLossWeights.make(**ranks.WEIGHTS)
    gen, _, ev, _ = jax_make_train_steps(jm.cfg, freq_loss_kwargs=ranks.FL,
                                         mesh=mesh)
    gstate, gm = gen(jstate, jnp.asarray(ranks.batch(0, T=ranks.SEQ_T)), jw,
                     use_gan=False)
    em, codes, _ = ev(jstate, jnp.asarray(ranks.batch(6, T=ranks.SEQ_T)), jw)
    jcfg = jmsstftd.MSSTFTConfig(**ranks.DISC, time_chunk=7)
    gsteps = jax_make_train_steps(jm.cfg, jcfg, freq_loss_kwargs=ranks.FL,
                                  mesh=mesh)
    return {
        "gen": (gstate, gm),
        "eval": ({k: np.asarray(v) for k, v in em.items()},
                 np.asarray(codes)),
        "gan_chunked": gsteps[0](disc_state, jnp.asarray(
            ranks.batch(3, T=ranks.SEQ_T)), jw, use_gan=True),
        "disc_chunked": gsteps[1](disc_state, jnp.asarray(
            ranks.batch(4, T=ranks.SEQ_T)), jw)}


@pytest.fixture(scope="module")
def sq(tmp_path_factory):
    """The world-4 results, the single-process references and JAX's."""
    out = tmp_path_factory.mktemp("seq")
    jm = jax_build_model([0.08], seed=3, **ranks.TINY)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **ranks.TINY)
    params, qstate = params_from_jax(jax.tree.map(np.asarray, jm.params),
                                     tuple(np.asarray(q) for q in jm.qstate),
                                     tm.cfg)
    jstate, _, _ = jax_create_train_state(jm, seed=0)
    jgan, _, _ = jax_create_train_state(
        jm, jmsstftd.MSSTFTConfig(**ranks.DISC), seed=0)
    disc = msstftd_params_from_jax(jax.tree.map(np.asarray,
                                                jgan.disc_params))
    inputs = {"params": params, "qstate": qstate, "disc": disc}
    torch.save(inputs, out / "inputs.pt")
    _nights(out / "data")
    cfg = json.loads(json.dumps(CONFIG))
    cfg["dataset"].update(root=str(out / "data"), batch_size=4)
    cfg["common"]["max_epoch"] = 2
    cfg["checkpoint"]["async_save"] = True
    cfg["distributed"] = {"data_parallel": True, "seq_parallel": SEQ}
    (out / "seq_main_cfg.json").write_text(json.dumps(cfg))
    (out / "seq_main.json").write_text(json.dumps({
        "config": str(out / "seq_main_cfg.json"), "log_dir": str(out / "run"),
        "sizes": list(MAIN_SIZES)}))

    world = mp.spawn(ranks.run, args=(WORLD, str(out / "store"), str(out),
                                      "seq,seq_main,seq_bf16"),
                     nprocs=WORLD, join=False)
    # while the world runs: the single process and JAX's 2-D mesh
    ref = ranks.seq_cases(inputs)
    ref_bf16 = ranks.seq_bf16_cases(inputs)
    jax_res = _jax_steps(jm, jstate, jgan)
    while not world.join():
        pass
    got = [torch.load(out / f"seq_{r}.pt", weights_only=False)
           for r in range(WORLD)]
    main = [torch.load(out / f"seq_main_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    bf16 = [torch.load(out / f"seq_bf16_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return dict(out=out, got=got, main=main, ref=ref, jax=jax_res, tm=tm,
                bf16=bf16, ref_bf16=ref_bf16)


@pytest.mark.parametrize("case", ranks.SEQ_CASES)
def test_seq_step_equals_the_single_process_step(sq, case):
    """The 2 x 2 data × seq step against the port's single-process step on
    the same global batch: the losses, the gradient leaf by leaf, Adam's
    moments, the parameters, the codebooks, the discriminator and the
    balancer's state; the four ranks hold the same state, bit for bit,
    and the single process's generator state."""
    ref = sq["ref"][case]
    got = [sq["got"][r][case] for r in range(WORLD)]
    for k, v in ref["metrics"].items():
        if v.dim() == 0 and k != "freq_acc":
            bound = 2e-3 if k.endswith("grad_norm") else 1e-4
            assert _rel(got[0]["metrics"][k], v) <= bound, (
                k, got[0]["metrics"][k], v)
    for key in ("params", "qstate", "mu", "nu", "grads", "disc", "disc_mu",
                "balancer"):
        if key in ref:
            for r in range(1, WORLD):
                assert _equal(got[0][key], got[r][key]), (key, r)
    for r in range(WORLD):
        assert torch.equal(got[r]["rng"], ref["rng"])
    _close(got[0]["qstate"], ref["qstate"], f"{case} qstate")
    if "balancer" in ref:
        _close(got[0]["balancer"], ref["balancer"], f"{case} balancer")
    disc = case.startswith("disc")
    lr = ranks.WEIGHTS["disc_lr" if disc else "lr"]
    _close_after_adam(got[0]["disc" if disc else "params"],
                      ref["disc" if disc else "params"], f"{case} ",
                      _above_noise(ref["grads"]), lr, 1)
    _close_grads(got[0]["grads"], ref["grads"], GRAD_REL)
    _close_grads(got[0]["disc_mu" if disc else "mu"],
                 ref["disc_mu" if disc else "mu"], GRAD_REL)
    if not disc:
        _close_grads(got[0]["nu"], ref["nu"], 2 * GRAD_REL)


@pytest.mark.parametrize("case", ["kmeans_1", "gen", "gan_chunked"])
def test_seq_codes_equal_outside_tie_flags(sq, case):
    """The seq peers' codes are equal; the data ranks' codes in rank order
    are the single process's wherever the searches' margins flag no tie
    (after the k-means init on the rows gathered over `data`)."""
    ref = sq["ref"][case]
    by = {sq["got"][r]["coords"]: sq["got"][r][case]["codes"]
          for r in range(WORLD)}
    for d in range(DATA):
        assert torch.equal(by[(d, 0)], by[(d, 1)])
    codes = torch.cat([by[(d, 0)] for d in range(DATA)])
    K = codes.shape[1]
    safe = (ref["margins"] >= TIE).reshape(K, codes.shape[0], -1
                                           ).permute(1, 0, 2)
    assert bool(safe.float().mean() > 0.8)
    assert torch.equal(codes[safe], ref["codes"][safe])


@pytest.mark.parametrize("case", ["gan", "disc"])
def test_seq_bf16_step_runs_like_the_single_process_step(sq, case):
    """`compute_dtype=torch.bfloat16` under the 2 x 2 mesh (the halos,
    tail hand-offs and gathers carry float32 on the wire): the chunked GAN
    generator step and the discriminator step, every rank's losses and
    gradient norm within `SEQ_BF16_REL` of the single-process bf16 step's
    (the shards' convs round to bf16 at other shapes than the whole
    signal's: the gradient norm measured 5.4e-3 apart, the losses 2.1e-4),
    the ranks' states equal, masters float32."""
    want = sq["ref_bf16"][case]["metrics"]
    for r, res in enumerate(sq["bf16"]):
        got = res[case]
        for k, v in want.items():
            if v.dim() == 0 and v.is_floating_point() and float(v) != 0:
                assert _rel(got["metrics"][k], v) <= SEQ_BF16_REL, (r, k)
        key = "disc" if case == "disc" else "params"
        for (name, a), (_, b) in zip(_leaves(got[key]),
                                     _leaves(sq["bf16"][0][case][key])):
            assert a.dtype == torch.float32 and torch.equal(a, b), (r, name)


def test_seq_eval_step(sq):
    """The eval step: the metrics and the per-item losses within 1e-4, the
    codes (K2 on the gathered latents) at 99% of positions; x̂ gathered
    whole, equal on the seq peers bit for bit. (x̂ itself is not held
    element by element: a code flipped at a near-tie changes its samples
    by up to 1e-2 here.)"""
    ref = sq["ref"]["eval"]
    by = {sq["got"][r]["coords"]: sq["got"][r]["eval"] for r in range(WORLD)}
    for k, v in ref["metrics"].items():
        if v.dim() == 0 and k != "freq_acc":
            for r in range(WORLD):
                assert _rel(sq["got"][r]["eval"]["metrics"][k], v) <= 1e-4, k
    for k in ("l_t", "l_t_2"):
        got = torch.cat([by[(d, 0)]["metrics"][k] for d in range(DATA)])
        np.testing.assert_allclose(got.numpy(), ref["metrics"][k].numpy(),
                                   rtol=1e-4)
    codes = torch.cat([by[(d, 0)]["codes"] for d in range(DATA)])
    assert float((codes == ref["codes"]).float().mean()) >= 0.99
    for d in range(DATA):
        assert torch.equal(by[(d, 0)]["x_hat"], by[(d, 1)]["x_hat"])
    assert torch.cat([by[(d, 0)]["x_hat"] for d in range(DATA)]).shape \
        == ref["x_hat"].shape


@pytest.mark.parametrize("case", ["gen", "gan_chunked", "disc_chunked"])
def test_seq_step_matches_jax_2d_mesh(sq, case):
    """The port's data×seq step against JAX's step on its 2 x 2 data × seq
    mesh: losses within 1e-5 relative, the updated parameters within
    Adam's first-step bound (2e-5 where the port's gradient is above 1e-4
    of its leaf's and the whole gradient's largest |value|, 5e-3 in the
    GAN steps as `tests/test_torch_gan.py` holds them; 2·lr elsewhere)."""
    jstate, jm_ = sq["jax"][case]
    got = sq["got"][0][case]
    disc = case.startswith("disc")
    keys = (("loss_disc", "logits_real", "logits_fake") if disc else
            ("loss", "loss_l1", "loss_freq", "loss_commit")
            + (("loss_gen", "loss_feat") if case.startswith("gan") else ()))
    for k in keys:
        assert _rel(got["metrics"][k], jm_[k]) <= 1e-5, k
    if disc:
        want = msstftd_params_from_jax(jax.tree.map(np.asarray,
                                                    jstate.disc_params))
        have, lr = got["disc"], ranks.WEIGHTS["disc_lr"]
    else:
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               tuple(np.asarray(q) for q in jstate.qstate),
                               sq["tm"].cfg)[0]
        have, lr = got["params"], ranks.WEIGHTS["lr"]
    rel = 1e-4 if case == "gen" else 5e-3
    grads = {k: np.abs(v.numpy()) for k, v in _leaves(got["grads"])}
    top = max(float(g.max()) for g in grads.values())
    for k, a in _leaves(have):
        b = dict(_leaves(want))[k].numpy()
        err = np.abs(a.numpy() - b)
        g = grads[k]
        assert float(err[g > rel * (float(g.max()) + top)].max(
            initial=0)) <= 2e-5, k
        assert float(err.max()) <= 2 * lr, k


def test_seq_eval_matches_jax_2d_mesh(sq):
    """The eval step from the same state as JAX's on its 2-D mesh: losses
    within 1e-5 relative, codes equal at 99% of positions."""
    metrics, codes = sq["jax"]["eval"]
    by = {sq["got"][r]["coords"]: sq["got"][r]["eval"] for r in range(WORLD)}
    for k in ("loss", "loss_l1", "loss_freq", "loss_commit"):
        assert _rel(by[(0, 0)]["metrics"][k], metrics[k]) <= 1e-5, k
    ours = torch.cat([by[(d, 0)]["codes"] for d in range(DATA)]).numpy()
    assert ours.shape == codes.shape
    assert float((ours == codes).mean()) >= 0.99


@pytest.mark.parametrize("name", ["halo", "tail", "gather", "sum"])
def test_seq_collectives_pass_gradcheck(sq, name):
    """`torch.autograd.gradcheck` in float64 of each differentiable
    collective over a seq group of 2 (in each of the two groups of the
    world): the halo (rank 0's context from its own head), the transposed
    conv's tail hand-off, the gather along time (reduce-scatter backward)
    and the sum over the group (all-reduce backward)."""
    for r in range(WORLD):
        assert sq["got"][r]["gradcheck"][name] is True


@pytest.mark.parametrize("name,match", [
    ("non-causal", "requires a causal model"),
    ("time_group_norm", "time_group_norm"),
    ("audio_normalize", "audio_normalize"),
    ("remat", "model.remat"),
    ("length", "not a multiple of 2 shards x hop 10")])
def test_seq_refusals(sq, name, match):
    """Sharded time is exact only for causal, per-time-step normalized
    models on aligned lengths: each other case is a clear `ValueError`,
    and so is stage remat, whose recomputed region would rerun the halo
    exchanges."""
    for r in range(WORLD):
        msg = sq["got"][r]["refusals"][name]
        assert msg is not None and match in msg, (r, msg)


def test_train_main_runs_data_x_seq(sq):
    """`python -m encodec_tpu_torch.train` with `distributed.seq_parallel:
    2` in a world of 4: a 2 x 2 data × seq mesh; each rank's loaders take
    the data axis's rank and size (the seq peers load the same rows); the
    four ranks end each run with the same state; rank 0 alone wrote the
    run directory, and the asynchronously saved checkpoint loads equal to
    the state; the resumed run starts at epoch 2 on every rank and ends
    equal on every rank, with equal validation metrics."""
    main = sq["main"]
    coords = {r: sq["got"][r]["coords"] for r in range(WORLD)}
    for r, res in enumerate(main):
        assert res["rank"] == r and res["mesh"] == ("data", "seq")
        assert res["shards"] == [(coords[r][0], DATA)]
        assert res["start"] == 2
        assert _equal(res["params_1"], main[0]["params_1"])
        assert _equal(res["params_2"], main[0]["params_2"])
        assert res["val"] == main[0]["val"]
    assert "model.ckpt" in main[0]["files_1"]
    raw, epoch, _ = load_checkpoint(sq["out"] / "run" / "model.ckpt")
    assert epoch == 2
    assert _equal(state_to_device(raw, torch.device("cpu")).params,
                  main[0]["params_2"])
    assert not _equal(main[0]["params_1"], main[0]["params_2"])
    assert all(np.isfinite(v) for v in main[0]["val"].values()
               if isinstance(v, float))


def test_chunked_gan_sums_by_blocks_add_up_to_the_whole():
    """`msstftd_gan_sums_chunked(shard=(i, n))`: the blocks' sums of every
    term add up to the whole signal's within float32 rounding, with the
    whole signal's logit count on each; more blocks than chunks is a
    `ValueError`."""
    from encodec_tpu_torch.models import msstftd

    cfg = msstftd.MSSTFTConfig(**ranks.DISC)
    disc = msstftd.init_msstftd(torch.Generator().manual_seed(0), cfg,
                                torch.device("cpu"))
    x = torch.from_numpy(ranks.batch(8, B=2, T=ranks.SEQ_T))
    x_hat = torch.from_numpy(ranks.batch(9, B=2, T=ranks.SEQ_T))
    for i, sub in enumerate(disc["discs"]):
        whole = msstftd.msstftd_gan_sums_chunked(sub, x, x_hat, cfg, i,
                                                 chunk=7)
        for n in (2, 3):
            parts = [msstftd.msstftd_gan_sums_chunked(
                sub, x, x_hat, cfg, i, chunk=7, shard=(r, n))
                for r in range(n)]
            assert whole.keys() == parts[0].keys()
            for k, v in whole.items():
                if k == "n_logit":
                    assert all(float(p[k]) == float(v) for p in parts)
                    continue
                total = sum(p[k] for p in parts)
                np.testing.assert_allclose(total.detach().numpy(),
                                           v.detach().numpy(), rtol=1e-5,
                                           err_msg=f"{i} {k} {n}")
    with pytest.raises(ValueError, match="cannot be shared by 100 ranks"):
        msstftd.msstftd_gan_sums_chunked(disc["discs"][0], x, x_hat, cfg, 0,
                                         chunk=7, shard=(0, 100))

