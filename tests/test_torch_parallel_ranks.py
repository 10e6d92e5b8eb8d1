"""Rank functions of the parallel tests (no tests here, and no JAX).

`tests/test_torch_parallel_train.py`, `tests/test_torch_parallel.py` and
`tests/test_torch_seq_parallel.py` start one gloo world per module with
`torch.multiprocessing.spawn`, which
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


# -- the data×seq step (tests/test_torch_seq_parallel.py) -----------------

SEQ_T = 1200          # 2 seq shards x hop 10 divide it
SEQ_CASES = ("kmeans_1", "gen", "gan_plain", "gan_chunked", "gan_remat",
             "disc_plain", "disc_chunked", "disc_remat", "balanced_item",
             "balanced_batch")


def seq_cases(inputs: dict, mesh=None) -> dict:
    """The data×seq cases on `inputs` (the JAX-initialised tiny model and
    discriminator), B=4 x T=1200: with `mesh` (data x seq), this rank's
    data rows, whole in time; without, the single-process step on the
    global batch."""
    rows = ((lambda a: torch.from_numpy(np.ascontiguousarray(
        parallel.shard_batch(mesh, a, "data")))) if mesh is not None
        else torch.from_numpy)
    w = LossWeights.make(**WEIGHTS)
    res = {}

    def keep(name, state, m):
        res[name] = _record(state, m)
        for k in ("codes", "margins"):
            if k in m:
                res[name][k] = m[k].clone()

    km = build_model([0.08], seed=3, device="cpu",
                     **dict(TINY, kmeans_init=True))
    steps = make_train_steps(km.cfg, freq_loss_kwargs=FL, mesh=mesh)
    state, m = steps[0](create_train_state(km, seed=0),
                        rows(batch(1, T=SEQ_T)), w, keep_grads=True)
    keep("kmeans_1", state, m)

    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    tm.params, tm.qstate = inputs["params"], inputs["qstate"]
    gen, _, ev, _ = make_train_steps(tm.cfg, freq_loss_kwargs=FL, mesh=mesh)
    state, m = gen(create_train_state(tm, seed=0), rows(batch(0, T=SEQ_T)),
                   w, keep_grads=True)
    keep("gen", state, m)
    em, codes, x_hat = ev(create_train_state(tm, seed=0),
                          rows(batch(6, T=SEQ_T)), w)
    res["eval"] = {"metrics": {k: v.clone() for k, v in em.items()},
                   "codes": codes.clone(), "x_hat": x_hat.clone()}
    for route in ROUTES:
        cfg = msstftd.MSSTFTConfig(
            **DISC, time_chunk=7 if route == "chunked" else None)
        steps = make_train_steps(tm.cfg, cfg, freq_loss_kwargs=FL,
                                 disc_remat=route == "remat", mesh=mesh)
        state = create_train_state(tm, cfg, seed=0)._replace(
            disc_params=inputs["disc"])
        s1, m = steps[0](state, rows(batch(3, T=SEQ_T)), w, use_gan=True,
                         keep_grads=True)
        keep(f"gan_{route}", s1, m)
        s2, m = steps[1](state, rows(batch(4, T=SEQ_T)), w, keep_grads=True)
        keep(f"disc_{route}", s2, m)
    for per_item in (True, False):
        bal = Balancer(weights={"l_t": 1.0, "l_f": 1.0},
                       per_batch_item=per_item)
        steps = make_train_steps(tm.cfg, freq_loss_kwargs=FL, balancer=bal,
                                 mesh=mesh)
        state = create_train_state(tm, seed=0, balancer=bal)
        state, m = steps[3](state, rows(batch(5, T=SEQ_T)), w,
                            keep_grads=True)
        keep(f"balanced_{'item' if per_item else 'batch'}", state, m)
    return res


class _Scatter(torch.autograd.Function):
    """A replicated tensor's slice `r` of `n` along dim 1 (backward: the
    sum over the ranks of the zero-padded cotangents: the whole cotangent
    on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.shape = group, x.shape
        n, r = parallel.comm.world(group), parallel.comm.rank(group)
        per = x.shape[1] // n
        return x[:, r * per:(r + 1) * per].clone()

    @staticmethod
    def backward(ctx, g):
        n, r = parallel.comm.world(ctx.group), parallel.comm.rank(ctx.group)
        full = g.new_zeros(ctx.shape)
        per = ctx.shape[1] // n
        full[:, r * per:(r + 1) * per] = g
        return parallel.comm.all_reduce(full, "sum", ctx.group), None


class _Share(torch.autograd.Function):
    """The identity, whose backward takes this rank's share of a
    replicated output's cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / parallel.comm.world(ctx.group), None


def seq_gradchecks(group) -> dict:
    """`torch.autograd.gradcheck` in float64 of the halo, the tail
    hand-off, the gather and the sum over `group`: each wrapped as a
    function of a replicated input (sliced per rank) to a replicated
    output (gathered), so every rank checks the whole Jacobian."""
    comm = parallel.comm
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 2 * comm.world(group), 3, generator=gen,
                    dtype=torch.float64, requires_grad=True)

    def halo(x):
        y = _Scatter.apply(x, group)
        prime = y[:, :1].flip(1) * 0.5 if comm.rank(group) == 0 else None
        ctx = comm.halo(y[:, -1:] * 3.0, prime, group)
        return _Share.apply(comm.gather_time(torch.cat([ctx, y], 1),
                                             group), group)

    def tail(x):
        y = _Scatter.apply(x, group).transpose(1, 2)      # time last
        out = comm.tail_handoff(y * 2.0, y[..., -1:].square(), group)
        return _Share.apply(comm.gather_time(out, group, dim=2), group)

    def gather(x):
        y = _Scatter.apply(x, group)
        return _Share.apply(comm.gather_time(y.sin(), group), group)

    def total(x):
        y = _Scatter.apply(x, group)
        return _Share.apply(comm.sum_over(y.square().sum(1), group), group)

    out = {}
    for name, fn in (("halo", halo), ("tail", tail), ("gather", gather),
                     ("sum", total)):
        # a failure returns False on every rank alike (the same Jacobians),
        # so the ranks stay in step
        out[name] = bool(torch.autograd.gradcheck(
            fn, (x,), eps=1e-6, atol=1e-8, raise_exception=False))
    return out


def seq_refusals(mesh) -> dict:
    """What the data×seq step refuses, each message (None: no error)."""
    import dataclasses

    tm = build_model([0.08], seed=3, device="cpu", **TINY)
    cfg, sn = tm.cfg, tm.cfg.seanet
    bad = {"non-causal": dataclasses.replace(
               cfg, seanet=dataclasses.replace(sn, causal=False)),
           "time_group_norm": dataclasses.replace(
               cfg, seanet=dataclasses.replace(sn, norm="time_group_norm")),
           "audio_normalize": dataclasses.replace(cfg, normalize=True),
           "remat": dataclasses.replace(
               cfg, seanet=dataclasses.replace(sn, remat=True))}
    out = {}
    for name, c in bad.items():
        try:
            make_train_steps(c, freq_loss_kwargs=FL, mesh=mesh)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    gen = make_train_steps(cfg, freq_loss_kwargs=FL, mesh=mesh)[0]
    x = torch.from_numpy(np.ascontiguousarray(parallel.shard_batch(
        mesh, batch(0, T=SEQ_T + 10), "data")))
    try:
        gen(create_train_state(tm, seed=0), x, LossWeights.make(**WEIGHTS))
        out["length"] = None
    except ValueError as e:
        out["length"] = str(e)
    return out


def seq_bf16_cases(inputs: dict, mesh=None) -> dict:
    """The bf16 data×seq steps (`compute_dtype=torch.bfloat16`): a GAN
    generator step and a discriminator step by the chunked route, B=4 x
    T=1200, on the tiny model with weight norm in place of layer norm (in
    bf16 the layer norm over 4 channels moves the step's gradient by tens
    of percent, `tests/test_torch_precision.py`) and `inputs`'
    discriminator; with `mesh`, this rank's data rows, without, the
    single-process step on the global batch."""
    rows = ((lambda a: torch.from_numpy(np.ascontiguousarray(
        parallel.shard_batch(mesh, a, "data")))) if mesh is not None
        else torch.from_numpy)
    w = LossWeights.make(**WEIGHTS)
    tm = build_model([0.08], seed=3, device="cpu",
                     **dict(TINY, model_norm="weight_norm"))
    tm.qstate = tm.qstate._replace(
        cluster_size=torch.full_like(tm.qstate.cluster_size, 50.0))
    cfg = msstftd.MSSTFTConfig(**DISC, time_chunk=7)
    gen, disc, _, _ = make_train_steps(tm.cfg, cfg, freq_loss_kwargs=FL,
                                       compute_dtype=torch.bfloat16,
                                       mesh=mesh)
    state = create_train_state(tm, cfg, seed=0)._replace(
        disc_params=inputs["disc"])
    s1, m = gen(state, rows(batch(3, T=SEQ_T)), w, use_gan=True)
    s2, dm = disc(state, rows(batch(4, T=SEQ_T)), w)
    return {"gan": _record(s1, m), "disc": _record(s2, dm)}


def task_seq_bf16(out: str) -> dict:
    """The bf16 cases on a 2 x 2 mesh."""
    mesh = parallel.make_mesh_2d(2, dist.get_world_size() // 2)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    return seq_bf16_cases(inputs, mesh)


def task_seq(out: str) -> dict:
    """The data×seq cases on a 2 x 2 mesh, the collectives' gradchecks on
    its seq axis, and the refusals."""
    mesh = parallel.make_mesh_2d(2, dist.get_world_size() // 2)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = seq_cases(inputs, mesh)
    res["gradcheck"] = seq_gradchecks(mesh.get_group("seq"))
    res["refusals"] = seq_refusals(mesh)
    res["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("seq"))
    return res


def task_seq_main(out: str) -> dict:
    """`python -m encodec_tpu_torch.train` with `distributed.seq_parallel:
    2` (gloo, `--device cpu`) and asynchronous saves, one epoch; then a
    resume of its run directory for a second epoch."""
    from encodec_tpu_torch.train import __main__ as entry

    with open(os.path.join(out, "seq_main.json")) as fh:
        spec = json.load(fh)
    build = entry.build_dataloaders
    shards = []

    def cut(config, *shard):
        shards.append(shard)
        train, val, mapping = build(config, *shard)
        train.dataset.size, val.dataset.size = spec["sizes"]
        return train, val, mapping

    entry.build_dataloaders = cut
    try:
        first = entry.main(["--config", spec["config"], "--log_dir",
                            spec["log_dir"], "--device", "cpu",
                            "--max_epochs", "1"])
        res = {"rank": first.rank, "shards": list(shards),
               "mesh": tuple(first.mesh.mesh_dim_names),
               "params_1": _detach(first.state.params),
               "files_1": sorted(os.listdir(spec["log_dir"]))}
        dist.barrier()
        again = entry.main(["--config", spec["config"], "--resume_from",
                            spec["log_dir"], "--device", "cpu",
                            "--max_epochs", "2"])
    finally:
        entry.build_dataloaders = build
    res.update(start=again.start_epoch, params_2=_detach(again.state.params),
               val=again.evaluate(2, save_figure=False))
    return res


TASKS = {"train": task_train, "main": task_main, "paths": task_paths,
         "seq": task_seq, "seq_main": task_seq_main,
         "seq_bf16": task_seq_bf16}
