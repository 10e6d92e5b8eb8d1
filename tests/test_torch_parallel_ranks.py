"""Rank functions of the parallel tests (no tests here, and no JAX).

`tests/test_torch_parallel_train.py` and `tests/test_torch_parallel.py`
start one gloo world per module with `torch.multiprocessing.spawn`, which
re-imports this module in every rank: it imports torch and the port only.
Each rank initialises its process group from a file store under the
test's temporary directory (no port to collide on under xdist), runs one
thread, and writes its results to `<out>/<task>_<rank>.pt`, which the
parametrised test cases read. The same case functions run in the test
process without a mesh: the port's single-process reference on the global
batch.
"""

import json
import os
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from encodec_tpu_torch import parallel
from encodec_tpu_torch.losses import Balancer
from encodec_tpu_torch.models import build_model, msstftd
from encodec_tpu_torch.train import (LossWeights, create_train_state,
                                     make_train_steps, save_checkpoint)
from encodec_tpu_torch.train.optim import tree_map

# the tiny model of tests/test_torch_train.py and the discriminator of
# tests/test_torch_gan.py
TINY = dict(sample_rate=10, channels=1, causal=True, model_norm="layer_norm",
            name="breathing_model", ratios=[5, 2, 1], bins=32, dimension=16,
            n_filters=4, decoder_final_norm="none", shared_codebook=True,
            kmeans_init=False)
FL = dict(n_fft=64, win_length=64, hop_length=16, sampling_rate=10)
WEIGHTS = dict(lr=1e-3, freq=0.25, l2=0.01, commit=0.25, codebook=1.0,
               disc_lr=1e-3)
DISC = dict(filters=2, n_ffts=(64, 32), hop_lengths=(16, 8),
            win_lengths=(64, 32))
ROUTES = ("plain", "chunked", "remat")
GLOBAL_B = 4


def batch(seed: int, B: int = GLOBAL_B, T: int = 600) -> np.ndarray:
    """`tests/test_torch_train.py`'s seeded breathing-like batch."""
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 10.0
    sig = np.sin(2 * np.pi * 0.3 * t)[None, :, None] + 0.05 * rng.randn(B, T, 1)
    return sig.astype(np.float32)


def init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    parallel.initialize_multihost(init_method=f"file://{store}",
                                  world_size=world, rank=rank,
                                  backend="gloo", timeout_s=120)


def run(rank: int, world: int, store: str, out: str, tasks: str) -> None:
    """The spawn target: each of the comma-separated `tasks` (keys of
    `TASKS`, functions of the output directory returning a results dict)
    in turn, in one world."""
    init(rank, world, store)
    for task in tasks.split(","):
        result = TASKS[task](out)
        torch.save(result, os.path.join(out, f"{task}_{rank}.pt"))
    # on an error the rank raises at once and spawn ends the others
    dist.barrier()
    dist.destroy_process_group()


def _detach(tree):
    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _record(state, metrics) -> dict:
    keep = {k: v for k, v in metrics.items() if k not in ("grads",)}
    out = {"params": _detach(state.params),
           "qstate": _detach(tuple(state.qstate[:3])),
           "mu": _detach(state.opt_state.mu), "nu": _detach(state.opt_state.nu),
           "rng": state.rng.clone(),
           "metrics": {k: v.detach().clone() for k, v in keep.items()
                       if isinstance(v, torch.Tensor)}}
    if state.disc_params is not None:
        out["disc"] = _detach(state.disc_params)
        out["disc_mu"] = _detach(state.disc_opt_state.mu)
    if state.balancer_state is not None:
        out["balancer"] = _detach(state.balancer_state)
    if "grads" in metrics:
        out["grads"] = _detach(metrics["grads"])
    return out


def dp_cases(inputs: dict, mesh=None, ckpt: tp.Optional[str] = None) -> dict:
    """Every data-parallel case on `inputs` (`test_torch_parallel_train`'s
    seeded models): with `mesh`, on this rank's rows; without, the
    single-process step on the global batch. With `ckpt`, the state after
    the first k-means step is written there (by rank 0)."""
    rows = ((lambda a: torch.from_numpy(np.ascontiguousarray(
        parallel.shard_batch(mesh, a)))) if mesh is not None
        else torch.from_numpy)
    w = LossWeights.make(**WEIGHTS)
    res = {}

    # the first batch's k-means init and expiry, then a second step
    km = build_model([0.08], seed=3, device="cpu",
                     **dict(TINY, kmeans_init=True))
    steps = make_train_steps(km.cfg, freq_loss_kwargs=FL, mesh=mesh)
    state = create_train_state(km, seed=0)
    for i in (1, 2):
        state, m = steps[0](state, rows(batch(i)), w, keep_grads=True)
        res[f"kmeans_{i}"] = _record(state, m)
        res[f"kmeans_{i}"]["codes"] = m["codes"].clone()
        res[f"kmeans_{i}"]["margins"] = m["margins"].clone()
        if i == 1 and ckpt is not None and (mesh is None
                                            or dist.get_rank() == 0):
            save_checkpoint(state, 1, ckpt)

    # the JAX-initialised tiny model with half its clusters below the
    # expiry threshold: those codes are replaced by rows drawn over the
    # global batch
    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params = inputs["params"]
    sizes = inputs["qstate"].cluster_size.clone()
    sizes[:, ::2] = 0.5
    tm.qstate = inputs["qstate"]._replace(cluster_size=sizes)
    gen = make_train_steps(tm.cfg, freq_loss_kwargs=FL, mesh=mesh)[0]
    state, m = gen(create_train_state(tm, seed=0), rows(batch(7)), w,
                   keep_grads=True)
    res["expire"] = _record(state, m)
    res["expire"]["codes"] = m["codes"].clone()
    res["expire"]["margins"] = m["margins"].clone()

    # the JAX-initialised tiny model (every cluster at 50: nothing expires)
    tm.qstate = inputs["qstate"]
    gen = make_train_steps(tm.cfg, freq_loss_kwargs=FL, mesh=mesh)[0]
    state = create_train_state(tm, seed=0)
    state, m = gen(state, rows(batch(0)), w, keep_grads=True)
    res["gen"] = _record(state, m)
    ev = make_train_steps(tm.cfg, freq_loss_kwargs=FL, mesh=mesh)[2]
    em, codes, _ = ev(state, rows(batch(6)), w)
    res["eval"] = {"metrics": {k: v.clone() for k, v in em.items()},
                   "codes": codes.clone()}

    # the GAN phase: the GAN generator step and the discriminator step by
    # the three routes, and the balanced step (per item and whole batch)
    for route in ROUTES:
        cfg = msstftd.MSSTFTConfig(
            **DISC, time_chunk=7 if route == "chunked" else None)
        steps = make_train_steps(tm.cfg, cfg, freq_loss_kwargs=FL,
                                 disc_remat=route == "remat", mesh=mesh)
        state = create_train_state(tm, cfg, seed=0)._replace(
            disc_params=inputs["disc"])
        s1, m = steps[0](state, rows(batch(3)), w, use_gan=True,
                         keep_grads=True)
        res[f"gan_{route}"] = _record(s1, m)
        s2, m = steps[1](state, rows(batch(4)), w, keep_grads=True)
        res[f"disc_{route}"] = _record(s2, m)
    for per_item in (True, False):
        bal = Balancer(weights={"l_t": 1.0, "l_f": 1.0},
                       per_batch_item=per_item)
        steps = make_train_steps(tm.cfg, freq_loss_kwargs=FL, balancer=bal,
                                 mesh=mesh)
        state = create_train_state(tm, seed=0, balancer=bal)
        state, m = steps[3](state, rows(batch(5)), w, keep_grads=True)
        res[f"balanced_{'item' if per_item else 'batch'}"] = _record(state,
                                                                     m)
    return res


def task_train(out: str) -> dict:
    """The data-parallel steps at world 2, a checkpoint written after the
    first, and the mesh refusals."""
    mesh = parallel.make_mesh()
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = dp_cases(inputs, mesh, ckpt=os.path.join(out, "w2.ckpt"))
    refusals = {}
    for name, fn in (("2d", lambda: parallel.make_mesh_2d(2, 2)),
                     ("1d", lambda: parallel.make_mesh(4)),
                     ("batch", lambda: parallel.shard_batch(
                         mesh, np.zeros((3, 1))))):
        try:
            fn()
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    res["refusals"] = refusals
    res["transport"] = parallel.comm.transport()
    res["unreduced"] = unreduced_step(inputs, mesh)
    return res


def unreduced_step(inputs: dict, mesh) -> tp.Optional[str]:
    """A generator step whose time-domain losses skip `dp` (each rank's
    own mean, as an unreduced `.mean()` would be): the error it raises,
    or None."""
    from encodec_tpu_torch.train import steps as steps_mod

    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params, tm.qstate = inputs["params"], inputs["qstate"]
    gen = make_train_steps(tm.cfg, freq_loss_kwargs=FL, mesh=mesh)[0]
    reduced = steps_mod.total_loss
    steps_mod.total_loss = lambda *args: reduced(*args[:5])
    try:
        gen(create_train_state(tm, seed=0), torch.from_numpy(
            np.ascontiguousarray(parallel.shard_batch(mesh, batch(0)))),
            LossWeights.make(**WEIGHTS))
    except RuntimeError as e:
        return str(e)
    finally:
        steps_mod.total_loss = reduced
    return None


def task_main(out: str) -> dict:
    """`python -m encodec_tpu_torch.train` at world 2 (gloo, `--device
    cpu`) on the test's JSON config with asynchronous saves; its
    loaders' virtual epochs cut as the test's world-1 run cuts them."""
    from encodec_tpu_torch.train import __main__ as entry

    with open(os.path.join(out, "main.json")) as fh:
        spec = json.load(fh)
    build = entry.build_dataloaders

    def cut(config, *shard):
        train, val, mapping = build(config, *shard)
        train.dataset.size, val.dataset.size = spec["sizes"]
        return train, val, mapping

    entry.build_dataloaders = cut
    trainer = entry.main(["--config", spec["config"], "--log_dir",
                          spec["log_dir"], "--device", "cpu",
                          "--max_epochs", "1"])
    return {"rank": trainer.rank, "world": parallel.comm.world(),
            "mesh": trainer.mesh is not None,
            "val": trainer.evaluate(2, save_figure=False),
            "params": _detach(trainer.state.params),
            "files": sorted(os.listdir(spec["log_dir"]))}


def task_paths(out: str) -> dict:
    """tp, sp and pp on `test_torch_parallel`'s inputs: the codebook
    sharded over every rank (and over a 2 x 2 data × model mesh), time
    sharded over every rank, the LM's layers over every rank."""
    from encodec_tpu_torch.models.lm import LMConfig
    from encodec_tpu_torch.quant import RVQConfig
    from encodec_tpu_torch.train.lm_train import create_lm_train_state

    inp = torch.load(os.path.join(out, "paths.pt"), weights_only=False)
    world = dist.get_world_size()
    res = {}
    # tp
    mesh = parallel.make_mesh(axis_name="model")
    for name in ("x", "tie", "dup"):
        res[f"tp_{name}"] = parallel.nearest_codebook_tp(
            inp[f"tp_{name}"][0], inp[f"tp_{name}"][1], mesh)
    rcfg = RVQConfig(**inp["rvq_cfg"])
    res["tp_rvq"] = parallel.rvq_encode_tp(inp["rvq_state"], inp["rvq_x"],
                                           rcfg, mesh)
    mesh2 = parallel.make_mesh_2d(2, world // 2, ("data", "model"))
    res["tp_rvq_2d"] = parallel.rvq_encode_tp(
        inp["rvq_state"], inp["rvq_x2"], RVQConfig(**inp["rvq_cfg2"]),
        mesh2, batch_axis="data")
    # sp
    seq = parallel.make_mesh(axis_name="seq")
    for name, (model, x) in inp["sp_models"].items():
        params, qstate, cfg = model
        res[f"sp_enc_{name}"] = parallel.seanet_encode_sp(
            params["encoder"], x, cfg.seanet, seq)
        res[f"sp_codes_{name}"] = parallel.encode_sp(params, qstate, x, cfg,
                                                     seq)
        res[f"sp_dec_{name}"] = parallel.seanet_decode_sp(
            params["decoder"], inp["sp_z"][name], cfg.seanet, seq)
        res[f"sp_audio_{name}"] = parallel.decode_sp(
            params, qstate, res[f"sp_codes_{name}"], cfg, seq)
    try:
        parallel.seanet_encode_sp(*inp["sp_short"], seq)
        res["sp_short"] = None
    except ValueError as e:
        res["sp_short"] = str(e)
    # pp
    pipe = parallel.make_mesh(axis_name="pipe")
    lcfg = LMConfig(**inp["lm_cfg"])
    stacked, other = parallel.stack_lm_layers(inp["lm_params"], world)
    stage = parallel.shard_stacked_layers(stacked, pipe)
    for m in (4, 8):
        res[f"pp_fwd_{m}"] = parallel.lm_forward_batch_pp(
            stage, other, inp["lm_inputs"], lcfg, pipe, m)
    res["pp_logits"] = parallel.lm_forward_batch_pp(
        stacked, other, inp["lm_inputs"], lcfg, pipe, 2, offset=5,
        return_logits=True)
    try:
        parallel.lm_forward_batch_pp(stage, other, inp["lm_inputs"][:7],
                                     lcfg, pipe, 4)
        res["pp_bad_batch"] = None
    except ValueError as e:
        res["pp_bad_batch"] = str(e)
    opt, opt_state = create_lm_train_state((stage, other), lr=1e-2)
    step = parallel.make_lm_pp_train_step(lcfg, opt, pipe, n_microbatches=4)
    params, nll = (stage, other), []
    for i in range(3):
        params, opt_state, m = step(params, opt_state, inp["lm_codes"],
                                    keep_grads=i == 0)
        nll.append(m["nll"])
        if i == 0:
            res["pp_grads"] = _detach(m["grads"])
            res["pp_grad_norm"] = m["grad_norm"]
    res["pp_nll"] = torch.stack(nll)
    res["pp_params"] = _detach(params)
    return res


TASKS = {"train": task_train, "main": task_main, "paths": task_paths}
