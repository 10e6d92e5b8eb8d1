#!/usr/bin/env python3
"""Step 1 of a fresh state at 2 rows per data rank: rounding or a fault?

    python3 probes/kmeans_f5.py [--world 2] [--rows 2]
    python3 probes/kmeans_f5.py --device cpu --night 3000   # a dry run

One card. gan.yaml's model as written on 4 h nights (the nights of
`chip_smoke.seq_world`), B = world x rows. The first generator step (the
lazy k-means init of the shared book, then the eight training stages)
runs twice, both with cuDNN's deterministic algorithms:

1. a gloo world of `--world` ranks on cuda:0, data `world` x seq 1 (the
   data-parallel step), each rank on its `--rows` rows;
2. one process on the whole batch.

Each records what its k-means saw (the gathered latents, the generator's
state) and what the step left (losses, the book). Then, in this process:

- the step-1 loss gap and the book rows that moved by more than 1e-3;
- the latents' difference between the two runs (each rank's encoder on
  its rows against the encoder on the whole batch);
- replays: the single-process RVQ (`quant.rvq_forward`, no `dp`) on each
  run's latents from the same generator state must give that run's book
  (exactly for the process's own, to the data-parallel sums' rounding for
  the world's): then the gap comes from the latents alone, and not from
  how the data-parallel RVQ draws or reduces;
- k-means iteration by iteration on both latents from the same seeds:
  every assignment that differs, with its float64 margin (world 1's
  squared distances to the two rows, latents and means as that iteration
  had them) against the change the runs' measured differences can make
  (2|dx||e_a - e_b| + 2|x - e_a||de_a| + 2|x - e_b||de_b| plus the second
  order terms, dx and de the latents' and the means' differences at that
  iteration). An assignment whose margin sits below that change is
  rounding; one above it is not;
- for each moved row, the differing assignments that involved it.

Prints the card's name and power limit first and a JSON summary last.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MOVED = 1e-3            # a book row "moved" (the seq checks' measure)


def record_kmeans(rec: list) -> None:
    """Wrap `quant.rvq._kmeans` so each call appends its input and the
    generator's state to `rec`."""
    from encodec_tpu_torch.quant import rvq

    orig = rvq._kmeans

    def spy(samples, num_clusters, num_iters, generator=None, init_idx=None,
            plain=False):
        gstate = None if generator is None else generator.get_state().clone()
        out = orig(samples, num_clusters, num_iters, generator, init_idx,
                   plain)
        rec.append({"samples": samples.detach().cpu().clone(),
                    "gstate": gstate, "means": out[0].detach().cpu().clone(),
                    "counts": out[1].detach().cpu().clone()})
        return out

    rvq._kmeans = spy


def step_one(torch, tr, x, rec: list) -> dict:
    """The first generator step; its scalar losses, book and k-means
    record."""
    s1, m = tr.gen_step(tr.state, x, tr.weights_for_epoch(1))
    return {"losses": {k: float(v) for k, v in m.items()
                       if hasattr(v, "dim") and v.dim() == 0},
            "qstate": [t.detach().cpu() for t in s1.qstate[:3]],
            "rng0": tr.state.rng.clone(), "kmeans": rec}


def rank_main(rank: int, world: int, store: str, base: str) -> None:
    """One rank of the data-parallel world (data `world` x seq 1)."""
    import os

    import torch
    import torch.distributed as dist

    from encodec_tpu_torch import parallel
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.train import ConfigNamespace, Trainer

    torch.set_num_threads(2)
    ref = torch.load(Path(base) / "ref.pt", weights_only=False)
    dev = torch.device(ref["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        os.environ["LOCAL_RANK"] = "0"
    set_fp32_policy()
    torch.backends.cudnn.deterministic = True
    parallel.initialize_multihost(init_method=f"file://{store}",
                                  world_size=world, rank=rank,
                                  backend="gloo", timeout_s=600)
    mesh = parallel.make_mesh_2d(world, 1)
    tr = Trainer(ConfigNamespace(ref["config"]), [], [],
                 str(Path(base) / f"w{rank}"), device=dev, mesh=mesh)
    rec: list = []
    record_kmeans(rec)
    x = parallel.shard_batch(mesh, ref["x"], "data").to(dev)
    out = step_one(torch, tr, x, rec)
    if rank == 0:
        torch.save(out, Path(base) / "world.pt")
    dist.barrier()
    dist.destroy_process_group()


def kmeans_trace(torch, samples, init_idx, bins: int, iters: int) -> list:
    """`quant.rvq._kmeans`'s loop, keeping each iteration's means (before
    its search) and assignments."""
    from encodec_tpu_torch.quant.rvq import _one_hot, _search

    means = samples[init_idx]
    trace = []
    for _ in range(iters):
        idx = _search(samples, means, False)
        trace.append((means, idx))
        one_hot = _one_hot(idx, bins, samples.dtype)
        counts = one_hot.sum(0)
        new_means = (one_hot.t() @ samples) / counts.clamp(min=1.0)[:, None]
        means = torch.where((counts == 0)[:, None], means, new_means)
    return trace, means


def stage_trace(torch, cfg, flat, means, counts, gen, parts: int) -> list:
    """`quant.rvq_forward`'s training stages after the k-means init of a
    shared book, as written in `quant.rvq._stage_train`, with each EMA sum
    over the rows taken as `parts` row blocks added in order (what
    `parts` data ranks' `dp.sum` computes; 1: the single process's one
    product; each block's searches run alone too, as on its rank).
    Returns per stage (book entering it, residual, assignments,
    cluster sizes after the update, expired rows) and the final book."""
    from encodec_tpu_torch.quant.rvq import _draw, _one_hot, _search

    e, ea, cs = means, means.clone(), counts
    residual = flat
    N = flat.shape[0]
    blk = N // parts
    out = []
    for _ in range(cfg.n_q):
        x = residual
        # each block searched alone, at a rank's row count
        idx = torch.cat([_search(x[p * blk:(p + 1) * blk], e, False)
                         for p in range(parts)])
        one_hot = _one_hot(idx, cfg.bins, x.dtype)
        quantized = e[idx]
        cs_new = cs * cfg.decay + one_hot.sum(0) * (1 - cfg.decay)
        embed_sum = one_hot[:blk].t() @ x[:blk]
        for p in range(1, parts):
            embed_sum = embed_sum + (one_hot[p * blk:(p + 1) * blk].t()
                                     @ x[p * blk:(p + 1) * blk])
        ea_new = ea * cfg.decay + embed_sum * (1 - cfg.decay)
        n = cs_new.sum()
        smoothed = (cs_new + cfg.epsilon) / (n + cfg.bins * cfg.epsilon) * n
        e_out = ea_new / smoothed[:, None]
        expired = (cs_new < cfg.threshold_ema_dead_code)[:, None]
        replacement = x[_draw(N, cfg.bins, gen, x.device)]
        e_out = torch.where(expired, replacement, e_out)
        ea_new = torch.where(expired, replacement * smoothed[:, None], ea_new)
        out.append((e, x, idx, cs_new, expired[:, 0]))
        residual = residual - (x + (quantized - x))
        e, ea, cs = e_out, ea_new, cs_new
    return out, e


def flips(torch, trace1, trace2, x1, x2) -> list:
    """Every assignment that differs between the two traces: (iteration,
    sample, row in world 1, row in world 2, f64 margin, bound, measured
    shift)."""
    out = []
    for it, ((m1, i1), (m2, i2)) in enumerate(zip(trace1, trace2)):
        n = torch.nonzero(i1 != i2).flatten()
        if not n.numel():
            continue
        xs1 = x1[it] if isinstance(x1, list) else x1
        xs2 = x2[it] if isinstance(x2, list) else x2
        x1d, x2d = xs1.double(), xs2.double()
        dx = (x2d - x1d).norm(dim=1)
        a, b = i1[n].long(), i2[n].long()
        e1, e2 = m1.double(), m2.double()
        xa = x1d[n]

        def d(x, e, r):
            return (x - e[r]).square().sum(1)

        margin = d(xa, e1, b) - d(xa, e1, a)
        shift = margin - (d(x2d[n], e2, b) - d(x2d[n], e2, a))
        dea = (e2[a] - e1[a]).norm(dim=1)
        deb = (e2[b] - e1[b]).norm(dim=1)
        bound = (2 * dx[n] * (e1[a] - e1[b]).norm(dim=1)
                 + 2 * (xa - e1[a]).norm(dim=1) * dea
                 + 2 * (xa - e1[b]).norm(dim=1) * deb
                 + (dx[n] + dea).square() + (dx[n] + deb).square())
        for j in range(n.numel()):
            out.append((it, int(n[j]), int(a[j]), int(b[j]),
                        float(margin[j]), float(bound[j]), float(shift[j])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--night", type=int, default=None,
                    help="samples per night (default: 4 h at 10 Hz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    import chip_smoke
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build
    from encodec_tpu_torch.quant import RVQState, rvq_forward
    from encodec_tpu_torch.quant.rvq import _draw
    from encodec_tpu_torch.train import ConfigNamespace, Trainer

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("kmeans_f5: no CUDA device", file=sys.stderr)
        return 2
    set_fp32_policy()
    torch.backends.cudnn.deterministic = True
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi)
        t0 = time.perf_counter()
        build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s")
    B = args.world * args.rows
    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    config = chip_smoke.gan_config(str(base / "data"))
    night = args.night or chip_smoke.SEQ_NIGHT
    x = np.stack([chip_smoke.breathing_signal(night, 3000 + i)
                  for i in range(B)])[..., None]
    xt = torch.from_numpy(x)
    torch.save({"config": config, "x": xt, "device": str(dev)},
               base / "ref.pt")
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(args.world, str(base / "store"), str(base)),
             nprocs=args.world, join=True)
    w2 = torch.load(base / "world.pt", weights_only=False)
    print(f"world {args.world} (gloo, data {args.world} x seq 1, "
          f"{args.rows} rows per rank): {time.perf_counter() - t0:.1f} s")

    tr = Trainer(ConfigNamespace(config), [], [], str(base / "one"),
                 device=dev)
    rec: list = []
    record_kmeans(rec)
    w1 = step_one(torch, tr, xt.to(dev), rec)
    cfg = tr.model.cfg.rvq
    q0 = tr.state.qstate

    # the step-1 gap
    gaps = {k: abs(w2["losses"][k] - v) / abs(v)
            for k, v in w1["losses"].items() if k.startswith("loss") and v}
    worst = max(gaps, key=gaps.get)
    e1, e2 = w1["qstate"][0][0], w2["qstate"][0][0]
    row_move = (e2 - e1).abs().amax(-1)
    moved = torch.nonzero(row_move > MOVED).flatten().tolist()
    print(f"step 1: losses max rel {gaps[worst]:.3e} ({worst}; bound 1e-4); "
          + ", ".join(f"{k} {g:.2e}" for k, g in sorted(gaps.items()))
          + f"; {len(moved)} book rows of {e1.shape[0]} moved by more than "
          f"{MOVED:g}: {moved}")

    # the k-means inputs: each rank's encoder vs the whole batch's
    k1, k2 = w1["kmeans"][0], w2["kmeans"][0]
    same_draw = bool(torch.equal(k1["gstate"], k2["gstate"]))
    z1, z2 = k1["samples"].to(dev), k2["samples"].to(dev)
    dz = (z2 - z1).abs()
    rel = float(dz.max() / z1.abs().max())
    print(f"k-means input [{z1.shape[0]} x {z1.shape[1]}]: max|dz| "
          f"{float(dz.max()):.3e} (median {float(dz.median()):.3e}, "
          f"{rel:.2e} of max|z|), rows that differ "
          f"{int((dz.amax(1) > 0).sum())} of {z1.shape[0]}; the two runs' "
          f"generator states before k-means equal: {same_draw}")

    # replays: the plain RVQ on each run's latents from the same state
    def replay(z, gstate):
        g = torch.Generator()
        g.set_state(gstate)
        st = RVQState(*(t.clone() for t in q0[:3]), inited=q0.inited)
        with torch.no_grad():
            _, _, commit, new = rvq_forward(
                st, z.reshape(B, -1, z.shape[1]), cfg, n_q=cfg.n_q,
                training=True, generator=g)
        return float(commit.mean()), new.embed[0].cpu()

    c1, r1 = replay(z1, w1["rng0"])
    c2, r2 = replay(z2, w2["rng0"])
    own1 = float((r1 - e1).abs().max())
    own2 = float((r2 - e2).abs().max())
    commit_gap = abs(c2 - c1) / abs(c1)
    print(f"replays (quant.rvq_forward without dp from the step's "
          f"generator state): world 1's latents give its book max|d| "
          f"{own1:.3e}; world {args.world}'s gathered latents give the "
          f"world's book max|d| {own2:.3e}; the replays' commit gap "
          f"{commit_gap:.3e} (the steps' loss_commit gap "
          f"{gaps.get('loss_commit', 0.0):.3e})")

    # k-means iteration by iteration from the same seeds
    g = torch.Generator()
    g.set_state(k1["gstate"])
    init_idx = _draw(z1.shape[0], cfg.bins, g, dev)
    with torch.no_grad():
        t1, m1 = kmeans_trace(torch, z1, init_idx, cfg.bins,
                              cfg.kmeans_iters)
        t2, m2 = kmeans_trace(torch, z2, init_idx, cfg.bins,
                              cfg.kmeans_iters)
    exact = (bool(torch.equal(m1.cpu(), k1["means"]))
             and bool(torch.equal(m2.cpu(), k2["means"])))
    fl = flips(torch, t1, t2, z1, z2)
    by_iter: dict = {}
    for f in fl:
        by_iter[f[0]] = by_iter.get(f[0], 0) + 1
    above = [f for f in fl if f[4] > f[5]]
    print(f"k-means trace equals both recorded runs bit for bit: {exact}; "
          f"{len(fl)} differing assignments over {cfg.kmeans_iters} "
          f"iterations (first at iteration "
          f"{min(by_iter) if by_iter else None}; per iteration "
          f"{dict(sorted(by_iter.items()))}); margins above their bound: "
          f"{len(above)}")
    for f in fl[:40]:
        print(f"  iter {f[0]:2d} sample {f[1]:5d} rows {f[2]:4d} -> "
              f"{f[3]:4d}: f64 margin {f[4]:.3e}, bound {f[5]:.3e}, "
              f"measured shift {f[6]:.3e}")
    # the eight training stages after the k-means init, each run's sums
    # in its own order, from the same generator state
    def stages(z, m, counts, parts):
        g = torch.Generator()
        g.set_state(k1["gstate"])
        _draw(z.shape[0], cfg.bins, g, dev)          # the k-means seeds
        with torch.no_grad():
            return stage_trace(torch, cfg, z, m.to(dev), counts.to(dev), g,
                               parts)

    s1t, b1 = stages(z1, m1, k1["counts"], 1)
    s2t, b2 = stages(z2, m2, k2["counts"], args.world)
    stage_exact = (bool(torch.equal(b1.cpu(), e1))
                   and bool(torch.equal(b2.cpu(), e2)))
    sfl = flips(torch, [(t[0], t[2]) for t in s1t],
                [(t[0], t[2]) for t in s2t],
                [t[1] for t in s1t], [t[1] for t in s2t])
    exp = []
    for k, (a, b) in enumerate(zip(s1t, s2t)):
        for r in torch.nonzero(a[4] != b[4]).flatten().tolist():
            exp.append((k, r, float(a[3][r]), float(b[3][r])))
    s_above = [f for f in sfl if f[4] > f[5]]
    thr = cfg.threshold_ema_dead_code
    e_above = [x for x in exp if abs(x[2] - thr) > abs(x[2] - x[3])]
    print(f"training stages replayed with each run's summation order (the "
          f"EMA sums over {args.world} row blocks for the world): both "
          f"books bit for bit: {stage_exact}; the books entering each stage "
          f"differ by max|d| " + ", ".join(
              f"{float((a[0] - b[0]).abs().max()):.2e}"
              for a, b in zip(s1t, s2t)))
    print(f"  {len(sfl)} differing stage assignments (per stage "
          + str([sum(f[0] == k for f in sfl) for k in range(cfg.n_q)])
          + f"), margins above their bound: {len(s_above)}; "
          f"{len(exp)} differing expiries (cluster size against the "
          f"threshold {thr:g}), margins above the difference: {len(e_above)}")
    for f in sfl[:40]:
        print(f"  stage {f[0]} position {f[1]:5d} rows {f[2]:4d} -> "
              f"{f[3]:4d}: f64 margin {f[4]:.3e}, bound {f[5]:.3e}, "
              f"measured shift {f[6]:.3e}")
    for k, r, ca, cb in exp:
        print(f"  stage {k} row {r:4d} expired in one run only: cluster "
              f"size {ca!r} (world 1) vs {cb!r} (world {args.world}), "
              f"|size - {thr:g}| {abs(ca - thr):.3e}, difference "
              f"{abs(ca - cb):.3e}")
    fl = fl + [(f"s{f[0]}",) + f[1:] for f in sfl]
    above = above + s_above + e_above
    km_move = (m2 - m1).abs().amax(-1).cpu()
    rows = []
    for r in moved:
        mine = [f for f in fl if r in (f[2], f[3])]
        mine_exp = [x for x in exp if x[1] == r]
        ratio = max((f[4] / f[5] for f in mine if f[5] > 0), default=None)
        rows.append({"row": r, "moved": float(row_move[r]),
                     "kmeans_moved": float(km_move[r]),
                     "flips": len(mine), "expiries": len(mine_exp),
                     "first_iter": min((str(f[0]) for f in mine),
                                       default=None),
                     "max_margin": max((f[4] for f in mine), default=None),
                     "max_margin_over_bound": ratio})
        print(f"  row {r:4d}: moved {float(row_move[r]):.3e} after the step "
              f"({float(km_move[r]):.3e} after k-means); {len(mine)} "
              f"differing assignments and {len(mine_exp)} differing "
              f"expiries involve it, first at (k-means iteration, or s and "
              f"the stage) "
              f"{rows[-1]['first_iter']}, max f64 margin "
              f"{rows[-1]['max_margin']}, max margin/bound {ratio}")
    verdict = ("rounding" if exact and stage_exact and same_draw
               and not above and own1 == 0.0
               else "not shown to be rounding")
    print(f"verdict: {verdict}")
    print(json.dumps({"loss_gap": gaps[worst], "loss_key": worst,
                      "moved_rows": len(moved), "dz_max": float(dz.max()),
                      "dz_rel": rel, "same_draw": same_draw,
                      "replay_own": own1, "replay_world": own2,
                      "replay_commit_gap": commit_gap,
                      "kmeans_flips": len(fl) - len(sfl),
                      "stage_flips": len(sfl), "expiry_flips": len(exp),
                      "stage_exact": stage_exact,
                      "above_bound": len(above),
                      "rows": rows, "verdict": verdict}))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
