"""Data-parallel training of the breathing tokenizer on `torch.distributed`,
on the CPU: the port's world-2 step against its single-process step on the
same global batch and against JAX's single-device step; checkpoints across
world sizes; asynchronous saves; the mesh refusals.

One gloo world of 2 ranks per module (`torch.multiprocessing.spawn`, the
rank functions in `tests/test_torch_parallel_ranks.py`, a file store under
the module's temporary directory) runs every step case
(`test_torch_parallel_ranks.dp_cases`) on its rows of the global batch
(B=4, 2 per rank) and then `python -m encodec_tpu_torch.train` with
`distributed.data_parallel: true` and `checkpoint.async_save: true`; the
test process runs the same cases without a mesh, and JAX's steps.

Tolerances. JAX's own mesh-against-single-device bounds
(`tests/test_train.py:252-262`): losses rtol 1e-4; parameters, the
codebook state, the discriminator and the balancer's state rtol 2e-3,
atol 2e-5. JAX holds them because XLA's partitioned step repeats the
single device's arithmetic almost exactly; here two ranks run the
convolutions and matmuls on half the rows, and the tiny random trunk
amplifies that rounding (documented in `tests/test_torch_train.py`: JAX's
own float32 gradient lies 2e-4 to 1.7e-3 of a leaf's largest |value| from
float64). Measured here: the gradient moved by up to 1.4e-4 of a leaf's
plus the whole gradient's largest |value| (the expiry case; 0.5e-4 in the
others), held to `GRAD_REL` = 2e-4 of that sum, twice the port's
JAX-parity bound, and its global norm by 1.4e-4 (1.1e-3 after a second
step), held to 2e-3 like the state.
Adam's first update is ±lr·sign(g), so a parameter whose gradient lies
within that rounding may move the other way: as in the port's JAX-parity
tests, parameters are held to rtol 2e-3, atol 2e-5 where the gradient is
above that noise and within 2·lr per step elsewhere (1 element in
thousands moved, measured). Adam's moments are held to the gradient
bound. Codes equal outside the searches' tie flags (top-2 margin < 1e-3,
the container writer's guard). The ranks' states are equal bit for bit,
and so are their generator states and the single process's. Against JAX:
`tests/test_torch_train.py`'s and `tests/test_torch_gan.py`'s step bounds
for the world-1 port.
"""

import json
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)
import jax.numpy as jnp

from encodec_tpu.models import msstftd as jmsstftd
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.train import LossWeights as JaxLossWeights
from encodec_tpu.train import create_train_state as jax_create_train_state
from encodec_tpu.train import make_train_steps as jax_make_train_steps
from encodec_tpu_torch import parallel
from encodec_tpu_torch.data import DataLoader
from encodec_tpu_torch.models import build_model, params_from_jax
from encodec_tpu_torch.models.zoo import msstftd_params_from_jax
from encodec_tpu_torch.train import (AsyncCheckpointer, LossWeights,
                                     create_train_state, load_checkpoint,
                                     make_train_steps, save_checkpoint)
from encodec_tpu_torch.train import __main__ as train_entry
from encodec_tpu_torch.train.optim import tree_leaves
from encodec_tpu_torch.train.trainer import state_to_device
from tests import test_torch_parallel_ranks as ranks
from tests.test_torch_train import (CONFIG, _close_grads, _leaves, _nights,
                                    _rel)

WORLD = 2
TIE = 1e-3
STEP_CASES = (["kmeans_1", "kmeans_2", "expire", "gen"]
              + [f"{k}_{r}" for r in ranks.ROUTES for k in ("gan", "disc")]
              + ["balanced_item", "balanced_batch"])
MAIN_SIZES = (8, 4)   # training and validation items of the cut epochs
GRAD_REL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _main_config(root, tmp, async_save):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["dataset"].update(root=str(root), batch_size=4)
    cfg["common"]["max_epoch"] = 2
    cfg["checkpoint"]["async_save"] = async_save
    cfg["distributed"] = {"data_parallel": True}
    path = tmp / f"main_{int(async_save)}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX-initialised tiny model, the world-2 results, the world-1
    references and JAX's steps."""
    out = tmp_path_factory.mktemp("dp")
    jm = jax_build_model([0.08], seed=3, **ranks.TINY)
    jm.qstate = jm.qstate._replace(
        cluster_size=jnp.full_like(jm.qstate.cluster_size, 50.0))
    tm = build_model([0.08], seed=3, device="cpu", **ranks.TINY)
    params, qstate = params_from_jax(jax.tree.map(np.asarray, jm.params),
                                     tuple(np.asarray(q) for q in jm.qstate),
                                     tm.cfg)
    jcfg = jmsstftd.MSSTFTConfig(**ranks.DISC)
    jstate, _, _ = jax_create_train_state(jm, jcfg, seed=0)
    disc = msstftd_params_from_jax(jax.tree.map(np.asarray,
                                                jstate.disc_params))
    inputs = {"params": params, "qstate": qstate, "disc": disc}
    torch.save(inputs, out / "inputs.pt")
    _nights(out / "data")
    (out / "main.json").write_text(json.dumps({
        "config": _main_config(out / "data", out, True),
        "log_dir": str(out / "run2"), "sizes": list(MAIN_SIZES)}))

    mp.spawn(ranks.run, args=(WORLD, str(out / "store"), str(out),
                              "train,main"), nprocs=WORLD, join=True)
    got = [torch.load(out / f"train_{r}.pt", weights_only=False)
           for r in range(WORLD)]
    main = [torch.load(out / f"main_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    ref = ranks.dp_cases(inputs)

    jw = JaxLossWeights.make(**ranks.WEIGHTS)
    jgen = jax_make_train_steps(jm.cfg, freq_loss_kwargs=ranks.FL)[0]
    jsteps = jax_make_train_steps(jm.cfg, jcfg, freq_loss_kwargs=ranks.FL)
    jax_res = {
        "gen": jgen(jax_create_train_state(jm, seed=0)[0],
                    jnp.asarray(ranks.batch(0)), jw, use_gan=False),
        "gan_plain": jsteps[0](jstate, jnp.asarray(ranks.batch(3)), jw,
                               use_gan=True),
        "disc_plain": jsteps[1](jstate, jnp.asarray(ranks.batch(4)), jw)}
    return dict(out=out, got=got, main=main, ref=ref, jax=jax_res, jm=jm,
                tm=tm, inputs=inputs)


def _close(a, b, what, rtol=2e-3, atol=2e-5):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys() and la, what
    for k in la:
        np.testing.assert_allclose(la[k].numpy(), lb[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what}{k}")


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _above_noise(*grads) -> dict:
    """Per leaf, the elements where every given gradient exceeds 1e-4 of
    its leaf's and the whole gradient's largest |value| (the port's
    JAX-parity noise level, `tests/test_torch_train.py`)."""
    masks = {}
    for tree in grads:
        leaves = dict(_leaves(tree))
        top = max(float(g.abs().max()) for g in leaves.values())
        for k, g in leaves.items():
            m = g.abs() > 1e-4 * (float(g.abs().max()) + top)
            masks[k] = m if k not in masks else masks[k] & m
    return masks


def _close_after_adam(a, b, what, masks, lr, steps):
    """Parameters after `steps` Adam steps: rtol 2e-3, atol 2e-5 where the
    steps' gradients are above their noise; within 2·lr per step
    elsewhere (Adam's first step is ±lr·sign(g), and a sign inside the
    rounding noise may differ)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys() == masks.keys() and la, what
    for k in la:
        m = masks[k]
        np.testing.assert_allclose(la[k][m].numpy(), lb[k][m].numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=f"{what}{k}")
        assert float((la[k] - lb[k]).abs().max()) <= 2 * lr * steps, k


@pytest.mark.parametrize("case", STEP_CASES)
def test_dp_step_equals_the_single_process_step(dp, case):
    """World 2 against the port's single-process step on the same global
    batch: the losses, the gradient, Adam's moments, the parameters, the
    codebooks, the discriminator and the balancer's state after the step;
    both ranks hold the same state, bit for bit, and the same generator
    state as the single process."""
    ref, r0, r1 = dp["ref"][case], dp["got"][0][case], dp["got"][1][case]
    for k, v in ref["metrics"].items():
        if v.dim() == 0:
            bound = 2e-3 if k.endswith("grad_norm") else 1e-4
            assert _rel(r0["metrics"][k], v) <= bound, (k, r0["metrics"][k],
                                                        v)
    for key in ("params", "qstate", "mu", "nu", "grads", "disc", "disc_mu",
                "balancer"):
        if key in ref:
            assert _equal(r0[key], r1[key]), key
    assert torch.equal(r0["rng"], ref["rng"])
    assert torch.equal(r1["rng"], ref["rng"])
    _close(r0["qstate"], ref["qstate"], f"{case} qstate")
    if "balancer" in ref:
        _close(r0["balancer"], ref["balancer"], f"{case} balancer")
    steps = [ref] if case != "kmeans_2" else [dp["ref"]["kmeans_1"], ref]
    disc = case.startswith("disc")
    lr = ranks.WEIGHTS["disc_lr" if disc else "lr"]
    _close_after_adam(r0["disc" if disc else "params"],
                      ref["disc" if disc else "params"], f"{case} ",
                      _above_noise(*(s["grads"] for s in steps)), lr,
                      len(steps))
    if case != "kmeans_2":
        # the second step's gradient is taken at parameters that moved
        # apart by the first step's sign flips: its losses, codebooks and
        # parameters are held, as three steps in a row are against JAX
        _close_grads(r0["grads"], ref["grads"], GRAD_REL)
        _close_grads(r0["disc_mu" if disc else "mu"],
                     ref["disc_mu" if disc else "mu"], GRAD_REL)
        if not disc:
            _close_grads(r0["nu"], ref["nu"], 2 * GRAD_REL)


@pytest.mark.parametrize("case", ["kmeans_1", "kmeans_2", "expire"])
def test_dp_codes_equal_outside_tie_flags(dp, case):
    """The ranks' codes in rank order are the single process's at every
    position the searches' margins do not flag (after the k-means init on
    the gathered rows, and with codes expired and replaced by rows drawn
    over the global batch: `expire` holds half the books' clusters at 0.5,
    below the threshold of 2)."""
    ref = dp["ref"][case]
    codes = torch.cat([dp["got"][r][case]["codes"] for r in range(WORLD)])
    K = codes.shape[1]
    safe = (ref["margins"] >= TIE).reshape(K, codes.shape[0], -1
                                           ).permute(1, 0, 2)
    assert bool(safe.float().mean() > 0.8)
    assert torch.equal(codes[safe], ref["codes"][safe])
    if case == "expire":
        assert int((ref["qstate"][2] < 2.0).sum()) >= 16



def test_dp_eval_step_metrics_and_codes(dp):
    ref = dp["ref"]["eval"]
    for k, v in ref["metrics"].items():
        if v.dim() == 0:
            for r in range(WORLD):
                assert _rel(dp["got"][r]["eval"]["metrics"][k], v) <= 1e-4, k
    codes = torch.cat([dp["got"][r]["eval"]["codes"] for r in range(WORLD)])
    assert codes.shape == ref["codes"].shape
    assert float((codes == ref["codes"]).float().mean()) >= 0.99


@pytest.mark.parametrize("case", ["gen", "gan_plain", "disc_plain"])
def test_dp_step_matches_jax(dp, case):
    """The world-2 step against JAX's single-device step on the global
    batch: losses within 1e-5 relative (5e-3 for the GAN step's gradient
    norm, `tests/test_torch_gan.py`'s bound) and the updated parameters
    within Adam's first-step bound (2e-5, or 2·lr where JAX's gradient is
    within its noise)."""
    jstate, jm_ = dp["jax"][case]
    got = dp["got"][0][case]
    disc = case.startswith("disc")
    keys = (("loss_disc", "logits_real", "logits_fake") if disc else
            ("loss", "loss_l1", "loss_freq", "loss_commit")
            + (("loss_gen", "loss_feat") if case == "gan_plain" else ()))
    for k in keys:
        assert _rel(got["metrics"][k], jm_[k]) <= 1e-5, k
    cfg = dp["tm"].cfg
    if disc:
        want = msstftd_params_from_jax(jax.tree.map(np.asarray,
                                                    jstate.disc_params))
        have, lr = got["disc"], ranks.WEIGHTS["disc_lr"]
    else:
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               tuple(np.asarray(q) for q in jstate.qstate),
                               cfg)[0]
        have, lr = got["params"], ranks.WEIGHTS["lr"]
    rel = 5e-3 if case == "gan_plain" else 1e-4
    grads = {k: np.abs(v.numpy()) for k, v in _leaves(got["grads"])}
    top = max(float(g.max()) for g in grads.values())
    for k, a in _leaves(have):
        b = dict(_leaves(want))[k].numpy()
        err = np.abs(a.numpy() - b)
        g = grads[k]
        assert float(err[g > rel * (float(g.max()) + top)].max(
            initial=0)) <= 2e-5, k
        assert float(err.max()) <= 2 * lr, k
    if case == "gen":
        for a, b in zip(got["qstate"], jstate.qstate[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4 * float(np.abs(b).max()))


def test_checkpoint_saved_at_world_2_resumes_at_world_1(dp):
    """The state written by rank 0 after the first step, loaded in one
    process, takes the same second step as the world-2 run."""
    raw, epoch, _ = load_checkpoint(dp["out"] / "w2.ckpt")
    assert epoch == 1
    state = state_to_device(raw, torch.device("cpu"))
    km = build_model([0.08], seed=3, device="cpu",
                     **dict(ranks.TINY, kmeans_init=True))
    gen = make_train_steps(km.cfg, freq_loss_kwargs=ranks.FL)[0]
    state, m = gen(state, torch.from_numpy(ranks.batch(2)),
                   LossWeights.make(**ranks.WEIGHTS))
    want = dp["got"][0]["kmeans_2"]
    assert _rel(m["loss"], want["metrics"]["loss"]) <= 1e-4
    _close(state.params, want["params"], "resumed params")
    _close(tuple(state.qstate[:3]), want["qstate"], "resumed qstate")
    assert torch.equal(state.rng, want["rng"])


def test_train_main_runs_data_parallel_with_async_saves(dp, tmp_path,
                                                        monkeypatch):
    """`python -m encodec_tpu_torch.train` at world 2 (gloo): both ranks
    ran the mesh path and end with the same state; rank 0 alone wrote the
    run directory, and its asynchronously saved checkpoint loads equal to
    that state; a world-1 run of the same config (the plain path) ends
    near it (bounds below)."""
    r0, r1 = dp["main"]
    assert (r0["rank"], r1["rank"], r0["world"], r0["mesh"]) == (0, 1, 2,
                                                                 True)
    assert _equal(r0["params"], r1["params"])
    assert "model.ckpt" in r0["files"] and "config.json" in r0["files"]
    raw, epoch, _ = load_checkpoint(dp["out"] / "run2" / "model.ckpt")
    assert epoch == 1
    assert _equal(state_to_device(raw, torch.device("cpu")).params,
                  r0["params"])

    build = train_entry.build_dataloaders

    def cut(config, *shard):
        train, val, mapping = build(config, *shard)
        train.dataset.size, val.dataset.size = MAIN_SIZES
        return train, val, mapping

    monkeypatch.setattr(train_entry, "build_dataloaders", cut)
    one = train_entry.main([
        "--config", _main_config(dp["out"] / "data", tmp_path, False),
        "--log_dir", str(tmp_path / "run1"), "--device", "cpu",
        "--max_epochs", "1"])
    assert one.mesh is None
    # two Adam steps (the test's steps are held element by element; here
    # no gradient is kept): every element within 2·lr per step, and all
    # but one in a thousand within rtol 2e-3, atol 2e-5
    lr, la, lb = 1e-3, dict(_leaves(r0["params"])), dict(_leaves(
        one.state.params))
    assert la.keys() == lb.keys()
    for k in la:
        d = (la[k] - lb[k]).abs()
        assert float(d.max()) <= 2 * lr * 2, k
        far = d > 2e-5 + 2e-3 * lb[k].abs()
        assert int(far.sum()) <= max(1, la[k].numel() // 1000), k
    val = one.evaluate(2, save_figure=False)
    # the fit's first step runs k-means (50 nearest-centroid passes over
    # the gathered rows, where a rounding-level difference can move a
    # row): 1.3e-3 relative measured after the epoch, held to 1e-2
    for k, v in val.items():
        if isinstance(v, float):
            assert abs(r0["val"][k] - v) <= 1e-2 * max(abs(v), 1.0), k


def test_async_save_equals_sync_and_snapshots_the_state(dp, tmp_path):
    """An asynchronous save loads equal to a synchronous save of the same
    state, and holds the state as it was when `save` returned, even if
    the caller then changes it in place."""
    state = create_train_state(dp["tm"], seed=0)
    ck = AsyncCheckpointer()
    ck.save(state, 7, tmp_path / "a.ckpt", extra={"k": 1})
    before = state.params["decoder"]["init_conv"]["b"].clone()
    state.params["decoder"]["init_conv"]["b"].add_(1.0)
    ck.wait()
    state.params["decoder"]["init_conv"]["b"].copy_(before)
    save_checkpoint(state, 7, tmp_path / "s.ckpt", extra={"k": 1})
    (a, ea, xa), (s, es, xs) = (load_checkpoint(tmp_path / "a.ckpt"),
                                load_checkpoint(tmp_path / "s.ckpt"))
    assert (ea, xa) == (es, xs) == (7, {"k": 1})
    la, ls = dict(_leaves(a)), dict(_leaves(s))
    assert la.keys() == ls.keys()
    for k in la:
        assert np.array_equal(np.asarray(la[k]), np.asarray(ls[k])), k


def test_async_writer_error_surfaces_at_wait_and_next_save(dp, tmp_path):
    state = create_train_state(dp["tm"], seed=0)
    ck = AsyncCheckpointer()
    ck.save(state, 1, tmp_path / "missing" / "m.ckpt")
    with pytest.raises(FileNotFoundError):
        ck.wait()
    ck.wait()                      # raised once
    ck.save(state, 1, tmp_path / "missing" / "m.ckpt")
    with pytest.raises(FileNotFoundError):
        ck.save(state, 2, tmp_path / "m.ckpt")
    ck.save(state, 2, tmp_path / "m.ckpt")
    ck.wait()
    assert load_checkpoint(tmp_path / "m.ckpt")[1] == 2


@pytest.mark.parametrize("name,match", [
    ("2d", "needs 4 devices but only 2"), ("1d", "needs 4 devices but only 2"),
    ("batch", "not divisible")])
def test_mesh_refusals_in_a_world_of_2(dp, name, match):
    """A mesh larger than the world, and a batch that does not split,
    are clear `ValueError`s (JAX's `make_mesh_2d` refusal); the world's
    collectives ran through gloo (host staging)."""
    msg = dp["got"][0]["refusals"][name]
    assert msg is not None and match in msg
    assert dp["got"][0]["transport"] == "host"


def test_a_batch_mean_without_dp_fails_the_step(dp):
    """A loss term taken as this rank's own mean (the time-domain L1 and
    L2 without `dp`) makes the ranks' losses differ: the step raises at
    its end, naming the metrics, instead of summing that term's gradient
    over the ranks."""
    for r in range(WORLD):
        msg = dp["got"][r]["unreduced"]
        assert msg is not None and "differ between the ranks" in msg
        assert "loss_l1" in msg and "loss_l2" in msg


def test_initialize_multihost_refusals(tmp_path, monkeypatch):
    """No distributed environment: a no-op (False). Several processes
    asked for and a failed handshake: a loud RuntimeError, never a quiet
    single-process run. A rank without its GPU raises."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "TORCHELASTIC_RUN_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.initialize_multihost() is False
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()                   # nobody listens: rank 1 cannot join
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        parallel.initialize_multihost(
            init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=1,
            backend="gloo", timeout_s=2)
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.local_device()


def test_data_loader_gives_each_rank_its_rows():
    """Each rank's rows of every global batch, from the same permutation;
    together the single process's batches. A batch that does not split
    over the ranks is refused."""
    ds = [{"x": np.full((1, 3), i, np.float32), "filename": str(i),
           "selected_channel": 0} for i in range(12)]
    whole = [b["x"][:, 0, 0] for b, _ in DataLoader(ds, 4, seed=5)]
    parts = [[b["x"][:, 0, 0] for b, _ in DataLoader(ds, 4, seed=5, rank=r,
                                                        world=2)]
             for r in range(2)]
    assert len(whole) == 3
    for i, w in enumerate(whole):
        assert np.array_equal(np.concatenate([parts[0][i], parts[1][i]]), w)
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ds, 3, rank=0, world=2)
