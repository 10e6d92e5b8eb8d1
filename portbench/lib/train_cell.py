"""The driver of a training cell (`traffic.kind: train`).

Set-up builds the program's `Trainer` from the configuration file (its
`config`: the experiment YAML as run), draws the generator's weights (and
the discriminator's) from the seed on the card, makes `pool` batches of
`batch` × `length` seeded nights there and a trained-looking book (rows
of the plain encoder's latents of the first batch,
`reference.rvq.drawn_books`, handed to both sides in place of the first
step's k-means, whose rounding flips would part the two at once), and
then drives the trainer's own
step calls (`gen_step`, `disc_step`) through the traffic's `mix`: a cycle
of iterations, each a list of calls on one batch (`[["gen"]]`: the
generator step of an epoch without the GAN phase; `[["gan_gen"], ["gen",
"disc"]]`: the GAN phase's coin flip as a strict alternation). The first
`check.steps` iterations, on rows that all differ, are the correctness
check's and the warm-up. The
window then goes on with the same trainer state, batch after batch of the
pool, one iteration in flight, and closes after a whole cycle once
`--seconds` have passed.

`train_step_ms`: the window's seconds over its iterations, ×1000.
`train_peak_gib`: `max_memory_allocated` over the window.

The check (once the window has closed and the program's state is freed):
the plain reference (`reference/train.py`) runs the same first iterations
from the same weights, batches and draws. Compared:
- `loss_gap`: the largest |program − reference| / |reference| of each
  generator step's loss;
- `grad_gap`: the first step's clipped gradient as Adam holds it
  (μ₁ / (1 − b1)), leaf by leaf: |‖program‖ − ‖reference‖| over the
  reference leaf's norm or the median leaf's, whichever is larger; the
  worst leaf;
- `code_gap`, `code1_gap`: the reference takes the program's codes (its
  `gen_step(keep_grads=True)` returns them) in place of its own searches
  and reads how far each lies from its own nearest book row (the widest
  distance gap over the latents' mean squared norm, float64), over every
  generator step, and at the first;
- `change_gap`: the same of each leaf's change over the check's steps
  (and of the book's norm after them), leaving out the leaves whose first reference
  gradient is under a thousandth of the median leaf's (those Adam moves
  by rounding alone) and those no step of the check moves.

`--control tf32`: the reference computed with TF32 on stands in the
program's place; `--control half`: the reference on half of each batch's
rows (the mean over them) does, and `--control frozen` the reference
whose steps return their state unchanged (two of the faults the check
must catch); the window is not run. Every number is
printed on standard error (`readings`) with what it is made of; the
workload's `check.limits` names those compared.
"""

from __future__ import annotations

import json
import shutil
import statistics
import sys
import tempfile
import time
import typing as tp

import torch
from torch.profiler import record_function

from ..reference import rvq
from ..reference import seanet as ref_seanet
from ..reference import train as ref_train
from ..reference.arch import arch_from_config
from . import harness, inputs, launches, trace

B1 = 0.8


def _norms(tree, prefix: str = "") -> tp.Dict[str, float]:
    return {k: torch.linalg.vector_norm(v.float()).item()
            for k, v in ref_train.paths(tree, prefix).items()}


def _leaf_gap(prog: dict, ref: dict, keep: tp.Iterable[str]) -> float:
    keep = [k for k in keep if k in ref]
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def readings(losses: tp.List[float], grads: dict, change: dict,
             codes: tp.Optional[list] = None,
             code_gaps: tp.Optional[list] = None) -> dict:
    return {"losses": losses, "grads": grads, "change": change,
            "codes": codes or [], "code_gaps": code_gaps or [0.0]}


def _median_leaf_gap(prog: dict, ref: dict, keep: tp.Iterable[str]
                     ) -> float:
    keep = [k for k in keep if k in ref]
    med = statistics.median(ref[k] for k in keep)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                             for k in keep)


def compare(prog: dict, ref: dict) -> dict:
    """Every number the check can compare (see the module's docstring);
    the workload's `check.limits` names those it does."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    med = statistics.median(ref["grads"].values())
    keep = [k for k in ref["change"] if k == "books.embed"
            or ref["grads"].get(k, 0.0) >= 1e-3 * med]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "code_gap": max(ref["code_gaps"]),
            "code1_gap": ref["code_gaps"][0],
            "grad_gap": _leaf_gap(prog["grads"], ref["grads"], ref["grads"]),
            "grad_median_gap": _median_leaf_gap(prog["grads"], ref["grads"],
                                                ref["grads"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
            "change_median_gap": _median_leaf_gap(prog["change"],
                                                  ref["change"], keep)}


def details(prog: dict, ref: dict) -> dict:
    """What the numbers are made of, for the record: each step's loss gap,
    the worst leaves."""
    med = statistics.median(ref["grads"].values())

    def worst(kind):
        return sorted(((abs(prog[kind][k] - ref[kind][k])
                        / max(ref[kind][k], med if kind == "grads" else 0.0,
                              1e-30), k) for k in ref[kind]
                       if k in prog[kind]), reverse=True)[:3]

    return {"loss_gaps": [abs(p - r) / abs(r) for p, r in
                          zip(prog["losses"], ref["losses"])],
            "losses": ref["losses"], "worst_grads": worst("grads"),
            "worst_change": worst("change")}


def reference_readings(p0: dict, batches, cfg_file: dict, epoch: int,
                       calls: tp.List[tp.List[str]], device, books: tuple, tf32: bool = False,
                       half: bool = False, frozen: bool = False,
                       forced: tp.Optional[list] = None) -> dict:
    """The reference's readings over the check's iterations `calls` (one
    batch each) from the weights `p0` (by path, on the CPU); with `tf32`
    in TF32, with `half` on the first half of each batch's rows only (the
    controls), with `frozen` returning its state unchanged (a fault).
    `forced`: the codes of each generator call ([B, K, T']) to take in
    place of its own searches; the widest gap of them is read."""
    cfg = cfg_file["config"]
    arch = arch_from_config(cfg_file)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        tree = ref_train.rebuild(_tree_of(p0), {k: v.to(device)
                                                for k, v in p0.items()})
        gen = torch.Generator().manual_seed(cfg["common"]["seed"])
        step = ref_train.Step(
            tree["params"], cfg, arch, gen, disc=tree.get("disc"),
            books=rvq.Books(*(b.to(device) for b in books)),
            frozen=frozen)
        w = ref_train.weights_at(cfg, epoch)
        losses, grads, seen, codes = [], {}, set(), []
        for x, names in zip(batches, calls):
            x = x[:x.shape[0] // 2] if half else x
            x = x.to(device)
            for call in names:
                if call == "disc":
                    loss, clipped = step.disc_step(x, w)
                    prefix = "disc."
                else:
                    loss, clipped = step.gen_step(
                        x, w, gan=call == "gan_gen",
                        forced=None if forced is None
                        else forced[len(codes)])
                    codes.append(step.codes)
                    prefix = ""
                losses.append(loss)
                if prefix not in seen:
                    seen.add(prefix)
                    grads.update({prefix + k: torch.linalg.vector_norm(
                        g).item() for k, g in clipped.items()})
        change = {k: torch.linalg.vector_norm(
                      v - p0["params." + k].to(device)).item()
                  for k, v in step.leaves.items()}
        change.update({"disc." + k: torch.linalg.vector_norm(
                           v - p0["disc." + k].to(device)).item()
                       for k, v in step.disc_leaves.items()})
        change["books.embed"] = torch.linalg.vector_norm(
            step.books.embed).item()
        return readings(losses, grads, change, codes,
                        [g for g in step.code_gaps])
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


def _tree_of(flat: dict):
    """A nested tree of dicts (list indices as keys) from dotted paths."""
    root: dict = {}
    for path in flat:
        node = root
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = None
    return _lists(root)


def _lists(node):
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_lists(node[str(i)]) for i in range(len(node))]
        return {k: _lists(v) for k, v in node.items()}
    return node


def run(r: harness.Run) -> harness.Outcome:
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.steps import create_train_state

    dev = r.device
    on_card = dev.type == "cuda"
    if on_card:
        from encodec_tpu_torch.kernels import build
        build.build_all()
    traffic, check = r.workload["traffic"], r.workload["check"]
    cfg = r.config["config"]
    steps = check["steps"]
    log_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        trainer = Trainer(ConfigNamespace(cfg), None, None, log_dir,
                          device=dev)
    finally:
        # the trainer writes only its config snapshot there
        shutil.rmtree(log_dir, ignore_errors=True)
    gen = inputs.device_generator(r.seed, dev)
    inputs.fill_weights(trainer.model.params, gen)
    trainer.model.params = trainer.model.params
    state = create_train_state(trainer.model, trainer.disc_cfg,
                               seed=cfg["common"]["seed"], clip=trainer.clip)
    if state.disc_params is not None:
        inputs.fill_weights(state.disc_params, gen)
    p0 = {k: v.detach().cpu().clone() for k, v in ref_train.paths(
        {"params": state.params, "disc": state.disc_params or {}}).items()}
    B, T = traffic["batch"], traffic["length"]
    pool = max(traffic["pool"], steps)
    batches = [inputs.breathing(gen, B, T, cfg["model"]["sample_rate"])
               [..., None].contiguous() for _ in range(pool)]
    epoch = traffic["epoch"]
    weights = trainer.weights_for_epoch(epoch)
    mix = traffic["mix"]
    check_calls = [mix[i % len(mix)] for i in range(steps)]
    from encodec_tpu_torch.quant import RVQState
    arch = arch_from_config(r.config)
    with torch.no_grad():
        z = ref_seanet.encoder(
            ref_train.rebuild(state.params, {
                k[len("params."):]: v.to(dev) for k, v in p0.items()
                if k.startswith("params.")})["encoder"],
            batches[0].transpose(1, 2), arch)
    drawn = rvq.drawn_books(z, arch["bins"], gen)
    del z
    state = state._replace(qstate=RVQState(
        *(t[None].clone() for t in drawn), inited=True))
    books = tuple(t.cpu() for t in drawn)

    if r.control is not None:
        del trainer, state
        cpu_batches = [b.cpu() for b in batches]
        del batches
        prog = reference_readings(p0, cpu_batches, r.config, epoch,
                                  check_calls, dev, books,
                                  tf32=r.control == "tf32",
                                  half=r.control == "half",
                                  frozen=r.control == "frozen")
        # half the rows give codes of half the rows: nothing to force
        ref = reference_readings(
            p0, cpu_batches, r.config, epoch, check_calls, dev, books,
            forced=None if r.control == "half" else prog["codes"])
        return _outcome(r, {}, prog, ref, 0, 0, 0)

    calls = {
        "gen": lambda s, x, keep: trainer.gen_step(s, x, weights,
                                                   keep_grads=keep),
        "gan_gen": lambda s, x, keep: trainer.gen_step(
            s, x, weights, use_gan=True, keep_grads=keep),
        "disc": lambda s, x, keep: trainer.disc_step(s, x, weights),
    }
    box = {"state": state}
    del state
    losses: tp.List[float] = []
    grads: tp.Dict[str, float] = {}
    codes: tp.List[torch.Tensor] = []

    def iterate(i: int, keep: bool = False) -> None:
        x = batches[i % pool]
        for call in mix[i % len(mix)]:
            box["state"], m = calls[call](box["state"], x, keep)
            if not keep:
                continue
            if "codes" in m:
                codes.append(m["codes"].cpu())
            m.pop("grads", None)
            s = box["state"]
            if call == "disc":
                losses.append(m["loss_disc"].item())
                if not any(k.startswith("disc.") for k in grads):
                    grads.update({k: v / (1 - B1) for k, v in _norms(
                        s.disc_opt_state.mu, "disc.").items()})
            else:
                losses.append(m["loss"].item())
                if not any(not k.startswith("disc.") for k in grads):
                    grads.update({k: v / (1 - B1)
                                  for k, v in _norms(s.opt_state.mu).items()})

    # the check's iterations: the warm-up, and the readings the reference
    # follows
    for i in range(steps):
        iterate(i, keep=True)
    s = box["state"]
    change = {k: torch.linalg.vector_norm(v - p0["params." + k].to(dev)
                                          ).item()
              for k, v in ref_train.paths(s.params).items()}
    if s.disc_params is not None:
        change.update({k: torch.linalg.vector_norm(v - p0[k].to(dev)).item()
                       for k, v in ref_train.paths(s.disc_params,
                                                   "disc.").items()})
    change["books.embed"] = torch.linalg.vector_norm(
        s.qstate.embed[0]).item()
    del s
    prog = readings(losses, grads, change, codes)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0

    cycle = len(mix)
    start = steps
    ctx = None
    if r.trace:
        counted: dict = {}

        def warm() -> None:
            iterate(start)

        def window() -> None:
            counted["before"] = launches.counts()
            with record_function("portbench.window"):
                for i in range(start + 1, start + 1 + r.workload["trace"]
                               ["iterations"]):
                    with record_function("portbench.step"):
                        iterate(i)
                with record_function("portbench.sync"):
                    sync()
            counted["after"] = launches.counts()

        # only the discriminator's calls run 2-D convs
        tr = trace.record(warm, window, sync, shapes=any(
            c != "gen" for it in mix for c in it))
        n = r.workload["trace"]["iterations"]
        work = [c for i in range(start + 1, start + 1 + n)
                for c in mix[i % cycle]]
        ctx = harness.MetricContext(
            "train", arch_from_config(r.config), traffic, r.config, tr, n,
            work, launches.delta(counted["before"], counted["after"]))
        measured, done, peak = {}, n + 1, peak_setup
    else:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        setup_s = t0 - r.t_start
        prev = None
        i = start
        marks = []
        while True:
            with record_function("portbench.step"):
                iterate(i)
            ev = None
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
            if prev is not None:
                with record_function("portbench.sync"):
                    prev.synchronize()
                marks.append(time.perf_counter())
            prev = ev
            i += 1
            if (i - start) % cycle == 0 and \
                    time.perf_counter() - t0 >= r.seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        marks.append(t0 + window_s)
        print("iteration ends (s) " + json.dumps(
            [round(m - t0, 4) for m in marks]), file=sys.stderr)
        done = i - start
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        measured = {"setup_s": setup_s,
                    "train_step_ms": 1e3 * window_s / done,
                    "train_peak_gib": peak / 2 ** 30}
        peak = max(peak, peak_setup)

    del box, trainer, calls
    cpu_batches = [b.cpu() for b in batches[:steps]]
    del batches
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_readings(p0, cpu_batches, r.config, epoch, check_calls,
                             dev, books, forced=prog["codes"])
    return _outcome(r, measured, prog, ref, done, peak, 0, ctx)


def _outcome(r, measured, prog, ref, done, peak, failed, ctx=None):
    limits = r.workload["check"]["limits"]
    nums = compare(prog, ref)
    print("readings " + json.dumps(dict(nums, **details(prog, ref))),
          file=sys.stderr)
    return harness.Outcome(
        measured=measured,
        checks={k: (v, limits[k]) for k, v in nums.items() if k in limits},
        attempted=done, failed=failed, memory_peak_bytes=peak,
        metric_context=ctx)
