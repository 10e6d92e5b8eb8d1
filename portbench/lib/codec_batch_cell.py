"""The driver of a batch-coding cell (`traffic.kind: codec_batch`).

Set-up builds the program's model with the configuration file's factory
(`program.factory` in `encodec_tpu_torch.models`), draws its weights from
the seed on the card and its codebooks from the plain encoder's latents of
the first batch, book by book, each from rows of the residual the books
before it leave, drawn from the seed (a gaussian book far from the
latents would give every position the same code), sets
the traffic's bandwidth, and makes `pool` batches of `batch` seeded clips
of `length` samples, handed over from the host as a caller's loader
would. It warms up on the first batch.

The window is a closed loop with one caller: batch after batch of the
pool, each `model.encode` and then `model.decode`, timed on the host from
the hand-off to the synchronize that ends the decode. It closes at the
end of the first batch that ends after `--seconds`.

`audio_s_per_s`: the seconds of audio of every batch over the window's
seconds. `batch_p95_ms`: the 95th percentile (nearest rank) of every
batch's time.

The check: for each batch of the pool, one of its first `check.per_clip`
passes, drawn from the seed, keeps its codes and audio; once the window
has closed and the model is freed, `reference.codec.judge` reads them,
holding the codes to the stages of the traffic's bandwidth and the audio
to the clips' length (the widest gaps over the kept batches, the means and shares over all
of them). Every reading is printed on standard error (`readings`); the
workload's `check.limits` names those compared.

`--control tf32`: the program's own TF32 mode (`set_precision('high')`)
serves the window instead, as the control.
"""

from __future__ import annotations

import json
import math
import random
import statistics
import sys
import time
import typing as tp

import torch
from torch.profiler import record_function

from ..reference import codec as ref_codec
from ..reference import rvq
from ..reference.arch import arch_from_config
from ..reference.train import paths, rebuild
from . import harness, inputs, launches, trace


def _books(z: torch.Tensor, shape: tuple, gen: torch.Generator
           ) -> torch.Tensor:
    """Books `shape` [n, bins, D] from latents `z` [B, T, D]: book k's rows
    drawn from the residual of the books before it."""
    residual = z.reshape(-1, shape[-1])
    books = []
    for _ in range(shape[0]):
        idx = torch.randint(0, residual.shape[0], (shape[1],),
                            generator=gen, device=gen.device)
        book = residual[idx]
        books.append(book)
        residual = residual - book[rvq.nearest(residual, book)]
    return torch.stack(books)


def run(r: harness.Run) -> harness.Outcome:
    import encodec_tpu_torch.models as models
    from encodec_tpu_torch.quant import RVQState

    dev = r.device
    on_card = dev.type == "cuda"
    if on_card:
        from encodec_tpu_torch.kernels import build
        build.build_all()
    traffic, check = r.workload["traffic"], r.workload["check"]
    arch = arch_from_config(r.config)
    program = r.config["program"]
    model = getattr(models, program["factory"])(
        device=dev, **program.get("kwargs", {}))
    gen = inputs.device_generator(r.seed, dev)
    inputs.fill_weights(model.params, gen)
    p0 = {k: v.detach().clone() for k, v in paths(model.params).items()}
    model.params = model.params
    B, L = traffic["batch"], traffic["length"]
    sr = arch["sample_rate"]
    pool = [inputs.audio(gen, B, L, sr)[:, None] for _ in range(
        traffic["pool"])]
    ref_params = rebuild(model.params, p0)
    shape = tuple(model.qstate.embed.shape)
    books = _books(ref_codec.latents(ref_params, pool[0], arch), shape, gen)
    model.qstate = RVQState(books.clone(), books.clone(),
                            torch.zeros(shape[:2], device=dev), True)
    model.set_target_bandwidth(traffic["bandwidth_kbps"])
    if r.control == "tf32":
        model.set_precision("high")
    host = [x.cpu() for x in pool]
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    rng = random.Random(r.seed)
    keep_at = {p + len(host) * rng.randrange(check["per_clip"])
               for p in range(len(host))}
    kept: tp.Dict[int, tuple] = {}

    def one(i: int) -> float:
        x = host[i % len(host)]
        with record_function("portbench.batch"):
            t0 = time.perf_counter()
            with record_function("portbench.encode"):
                frames = model.encode(x)
            with record_function("portbench.decode"):
                out = model.decode(frames)
            with record_function("portbench.sync"):
                sync()
            t = time.perf_counter() - t0
        if i in keep_at:
            kept[i] = (frames[0][0], out)
        return t

    one(0)
    one(1)
    kept.clear()
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ctx = None
    measured: dict = {}
    if r.trace:
        n = r.workload["trace"]["batches"]
        counted: dict = {}

        def window() -> None:
            counted["before"] = launches.counts()
            with record_function("portbench.window"):
                for i in range(n):
                    one(i)
            counted["after"] = launches.counts()

        tr = trace.record(lambda: one(n), window, sync)
        ctx = harness.MetricContext(
            "codec_batch", arch, traffic, r.config, tr, n, ["batch"] * n,
            launches.delta(counted["before"], counted["after"]))
        done = n
    else:
        t0 = time.perf_counter()
        setup_s = t0 - r.t_start
        times = []
        i = 0
        while True:
            times.append(one(i))
            i += 1
            if time.perf_counter() - t0 >= r.seconds and \
                    i >= len(host) * check["per_clip"]:
                break
        window_s = time.perf_counter() - t0
        done = i
        times.sort()
        measured = {
            "setup_s": setup_s,
            "audio_s_per_s": done * B * L / sr / window_s,
            "batch_p95_ms": 1e3 * times[math.ceil(0.95 * done) - 1]}
    if on_card:
        peak = max(peak, torch.cuda.max_memory_allocated())

    served = {i: (c.cpu(), a.cpu()) for i, (c, a) in kept.items()}
    del kept, model
    if on_card:
        torch.cuda.empty_cache()
    n_q = ref_codec.stages(arch, traffic["bandwidth_kbps"])
    got = [ref_codec.judge(ref_params, books, arch, pool[i % len(pool)],
                           n_q, codes.to(dev), audio.to(dev))
           for i, (codes, audio) in sorted(served.items())]
    # the widest gaps are the worst batch's; the means and shares are over
    # every kept batch (all of one size)
    nums = {k: (max if k in ("code_gap", "audio_gap") else
                statistics.fmean)([g[k] for g in got]) for k in got[0]}
    print("readings " + json.dumps(nums), file=sys.stderr)
    limits = check["limits"]
    return harness.Outcome(
        measured=measured,
        checks={k: (v, limits[k]) for k, v in nums.items() if k in limits},
        attempted=done, failed=len(keep_at - set(served)),
        memory_peak_bytes=peak,
        metric_context=ctx)
