#!/usr/bin/env python3
"""The reduced-precision modes on the card: a margin audit and a bf16
training audit.

    python3 probes/precision_audit.py [--part codec|train|fits|all] [--out F]
    python3 probes/precision_audit.py --fit gan|default --batch 32
    python3 probes/precision_audit.py --device cpu --seconds 0.5 \
        --night 3000 --batch 2 --steps 2        # a dry run of the code

(a) codec: `EncodecModel.set_precision` ('high': TF32 convolutions and
matmuls; 'fast': bf16 conv trunks) against 'highest' on the full-size
24 kHz and 48 kHz models (seeded weights, `kmeans_init=False`) and a
synthesized 10 s signal (speech-like: a gliding pitch with ten harmonics,
amplitude-modulated at a syllable rate, plus noise; stereo at 48 kHz).
The method of the JAX package's `tests/margin_audit.py::audit_precision`
and `probes/fast_writer.py`: per mode, the latents and every stage's K1
margin at the most stages; then per served bandwidth (a prefix of the
stages):
- the latents' drift from 'highest' (max and median |dz|);
- the positions whose codes differ from 'highest''s, split by the tie
  flags (a K1 margin under 1e-3 at some stage, the mode's own margins);
- the smallest guard threshold that flags every position where the mode's
  codes differ from the 'highest' writer's (its guarded codes), and per
  threshold of a grid the positions where the mode's guarded codes (the
  flagged ones re-resolved in float64 from the mode's own latents, as the
  writer does) still differ from the 'highest' writer's: a threshold
  certifies the mode when none do;
- that the writer refuses 'high' and 'fast' (no threshold certifies
  either; `stream.compress.REFUSED_MODES`);
- 24 kHz: codes streamed at 'high' in 80 ms chunks against the offline
  codes at 'high';
- a 10 s request's encode + decode ms in each mode (host clock, warm).

(b) train: gan.yaml as written at B=16 on 4 h nights from one common
state (a float32 first step with the k-means init), `--steps` steps of the
generator, the GAN generator and the discriminator step, each in float32
and in bf16 (`common.compute_dtype: bfloat16`) on the same batches: each
loss term's relative gap per step, the codes of the first step that
differ outside the tie flags, ms per step and peak GiB. Then, each in a
process of its own (`--fit`), whether gan.yaml at B=32 and default.yaml
at B=32 fit in bf16 without remat: an out-of-memory ends that process and
is reported as a row.

Prints the card's name and power limit first and a JSON summary last.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TIE = 1e-3
ARGS = argparse.Namespace(device="cuda", night=None)


def sync(torch) -> None:
    if ARGS.device == "cuda":
        torch.cuda.synchronize()


def peak_gib(torch) -> float:
    if ARGS.device != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2 ** 30


def reset_peak(torch) -> None:
    if ARGS.device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


GRID = (1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1, 2e-1, 5e-1, 1.0, 2.0)
MODES = ("highest", "high", "fast")


def speech_like(seconds: float, sr: int, channels: int, seed: int
                ) -> np.ndarray:
    """`[channels, n]` float32: a pitch gliding around 90-210 Hz with ten
    harmonics, amplitude-modulated at 3-5 Hz (syllables) and 0.4 Hz
    (phrases), plus noise at -30 dB."""
    rng = np.random.RandomState(seed)
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    out = []
    for _ in range(channels):
        f0 = 150 + 60 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voiced = sum(np.sin(h * phase + rng.uniform(0, 6)) / h
                     for h in range(1, 11))
        syl = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t
                                + rng.uniform(0, 6)))
        phrase = 0.6 + 0.4 * np.sin(2 * np.pi * 0.4 * t + rng.uniform(0, 6))
        sig = 0.25 * syl * phrase * voiced / np.abs(voiced).max()
        out.append(sig + 0.01 * rng.randn(n))
    return np.clip(np.stack(out), -0.99, 0.99).astype(np.float32)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# (a) the codec
# ---------------------------------------------------------------------------

def chain(torch, model, wav: np.ndarray, mode: str) -> dict:
    """The model's encoder and K1 chain at every stage in `mode`: latents
    `[P, D]`, codes and margins `[P, K]` over the positions P of every
    segment."""
    from encodec_tpu_torch.device import precision_scope
    from encodec_tpu_torch.models.model import encode_frame_margins

    model.set_precision(mode)
    zs, cs, ms = [], [], []
    with precision_scope(mode), torch.inference_mode():
        _, groups = model.segment_groups(torch.from_numpy(wav[None]))
        for _, stacked in groups:
            codes, _, z, margins = encode_frame_margins(
                model.infer_params, model.qstate, stacked, model.cfg,
                model.cfg.rvq.n_q, compute_dtype=model.compute_dtype)
            zs.append(z.reshape(-1, z.shape[-1]))
            cs.append(codes.permute(0, 2, 1).reshape(-1, codes.shape[1]))
            ms.append(margins.permute(0, 2, 1).reshape(-1, codes.shape[1]))
    model.set_precision("highest")
    return {"z": torch.cat(zs).cpu().numpy(),
            "codes": torch.cat(cs).cpu().numpy(),
            "margins": torch.cat(ms).cpu().numpy()}


def f64_codes(model, z: np.ndarray, block: int = 96) -> np.ndarray:
    """The writer's float64 chain (`resolve_ties_f64`) at every position."""
    from encodec_tpu_torch.quant import resolve_ties_f64

    return np.concatenate([
        resolve_ties_f64(model.qstate, z[i:i + block], model.cfg.rvq,
                         model.cfg.rvq.n_q)
        for i in range(0, z.shape[0], block)])


def request_ms(torch, model, wav: np.ndarray, mode: str, n: int = 5
               ) -> float:
    model.set_precision(mode)
    x = torch.from_numpy(wav[None])
    model.decode(model.encode(x))
    sync(torch)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        model.decode(model.encode(x))
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    model.set_precision("highest")
    return float(np.median(times))


def stream_vs_offline(torch, model, wav: np.ndarray, bw: float) -> dict:
    """Codes streamed at 'high' in 80 ms chunks against the offline codes
    at 'high', by the offline tie flags."""
    from encodec_tpu_torch.models import StreamingCodec
    from encodec_tpu_torch.quant import num_quantizers_for_bandwidth

    hop = model.cfg.seanet.hop_length
    chunk = model.sample_rate * 80 // 1000
    n_q = num_quantizers_for_bandwidth(model.cfg.rvq, model.frame_rate, bw)
    model.set_target_bandwidth(bw)
    model.set_precision("high")
    offline = model.encode(torch.from_numpy(wav[None]))[0][0][0].cpu()
    codec = StreamingCodec(model)
    x = torch.from_numpy(wav[None])
    n_full = x.shape[-1] - x.shape[-1] % hop
    parts, t = [], 0
    while t < n_full:
        end = min(t + (2 * chunk if t == 0 else chunk), n_full)
        parts.append(codec.encode_chunk(x[:, :, t:end]))
        t = end
    if n_full < x.shape[-1]:
        parts.append(codec.encode_finish(x[:, :, n_full:]))
    streamed = torch.cat(parts, -1)[0].cpu()
    model.set_precision("highest")
    flags = chain(torch, model, wav, "high")["margins"][:, :n_q].min(1) < TIE
    diff = (streamed != offline).any(0).numpy()
    return {"bw": bw, "positions": int(diff.size), "differ": int(diff.sum()),
            "outside_flags": int((diff & ~flags).sum())}


def audit_model(torch, model, wav: np.ndarray, label: str) -> dict:
    from encodec_tpu_torch.quant import num_quantizers_for_bandwidth
    from encodec_tpu_torch.stream import compress

    t0 = time.perf_counter()
    ch = {m: chain(torch, model, wav, m) for m in MODES}
    f64 = {m: f64_codes(model, ch[m]["z"]) for m in MODES}
    hi = ch["highest"]
    zmax = float(np.abs(hi["z"]).max())
    rep = {"model": label, "positions": int(hi["z"].shape[0]),
           "max_abs_z": zmax, "modes": {}}
    print(f"{label}: {hi['z'].shape[0]} positions, max|z| {zmax:.4g}, "
          f"min K1 margin at 'highest' {float(hi['margins'].min()):.3e} "
          f"[{time.perf_counter() - t0:.1f} s for the chains and their "
          "float64 resolutions]")
    for mode in ("high", "fast"):
        lo = ch[mode]
        dz = np.abs(lo["z"] - hi["z"])
        mrep = {"dz_max": float(dz.max()), "dz_median": float(np.median(dz)),
                "bandwidths": {}}
        print(f"  {mode}: latent drift from 'highest' max {dz.max():.3e} "
              f"median {np.median(dz):.3e} ({dz.max() / zmax:.2e} of "
              f"max|z|)")
        worst_t = 0.0
        for bw in model.target_bandwidths:
            K = num_quantizers_for_bandwidth(model.cfg.rvq, model.frame_rate,
                                             bw)
            c_hi, c_lo = hi["codes"][:, :K], lo["codes"][:, :K]
            m_hi = hi["margins"][:, :K].min(1)
            m_lo = lo["margins"][:, :K].min(1)
            parity = np.where((m_hi < TIE)[:, None], f64["highest"][:, :K],
                              c_hi)
            flips = (c_lo != c_hi).any(1)
            in_flags = flips & ((m_lo < TIE) | (m_hi < TIE))
            off = (c_lo != parity).any(1)
            t_star = float(m_lo[off].max()) if off.any() else 0.0
            worst_t = max(worst_t, t_star)
            grid = {}
            for thr in GRID:
                guarded = np.where((m_lo < thr)[:, None],
                                   f64[mode][:, :K], c_lo)
                grid[thr] = (int((guarded != parity).any(1).sum()),
                             int((m_lo < thr).sum()))
            cert = next((thr for thr in GRID if grid[thr][0] == 0), None)
            row = {"n_q": K, "flips": int(flips.sum()),
                   "flips_in_flags": int(in_flags.sum()),
                   "flips_outside_flags": int((flips & ~in_flags).sum()),
                   "off_parity_writer": int(off.sum()),
                   "smallest_flagging_threshold": t_star,
                   "certifying_threshold": cert,
                   "grid": {str(k): v for k, v in grid.items()}}
            mrep["bandwidths"][str(bw)] = row
            print(f"    {bw:g} kbps (n_q {K}): codes differ from 'highest' "
                  f"at {row['flips']} of {c_hi.shape[0]} positions "
                  f"({row['flips_in_flags']} inside the 1e-3 tie flags, "
                  f"{row['flips_outside_flags']} outside); from the "
                  f"'highest' writer at {row['off_parity_writer']}; every "
                  f"one flagged from a threshold above {t_star:.3e}; "
                  f"guarded at threshold t, positions still off the "
                  f"'highest' writer / flagged: " + ", ".join(
                      f"{k:g}: {v[0]}/{v[1]}" for k, v in grid.items())
                  + f"; certifying threshold {cert}")
        mrep["smallest_flagging_threshold"] = worst_t
        rep["modes"][mode] = mrep
    # the writer refuses the modes that no threshold certifies
    reg = {model.name: lambda pretrained=True: model}
    refused = {}
    for mode in ("high", "fast"):
        model.set_precision(mode)
        try:
            compress(model, wav, models=reg)
            refused[mode] = False
        except RuntimeError as exc:
            refused[mode] = str(exc).startswith(
                f"refusing to write .ecdc at set_precision({mode!r})")
        model.set_precision("highest")
    rep["writer_refuses"] = refused
    print("  the writer refuses: " + ", ".join(
        f"{m} {v}" for m, v in refused.items()))
    model.set_target_bandwidth(model.target_bandwidths[-1])
    rep["request_ms"] = {m: request_ms(torch, model, wav, m) for m in MODES}
    print(f"  a {wav.shape[-1] / model.sample_rate:g} s request's encode + "
          f"decode at {model.target_bandwidths[-1]:g} kbps, ms (host clock, "
          f"median of 5, warm): " + ", ".join(
              f"{m} {v:.2f}" for m, v in rep["request_ms"].items()))
    if model.cfg.seanet.causal:
        rep["stream_high"] = [stream_vs_offline(torch, model, wav, bw)
                              for bw in (6.0, 24.0)]
        print("  streamed at 'high' (80 ms chunks) vs offline at 'high': "
              + "; ".join(f"{r['bw']:g} kbps: {r['differ']} of "
                          f"{r['positions']} positions differ, "
                          f"{r['outside_flags']} outside the tie flags"
                          for r in rep["stream_high"]))
    return rep


def part_codec(torch, seconds: float) -> list:
    from encodec_tpu_torch.models import (encodec_model_24khz,
                                          encodec_model_48khz)

    out = []
    for name, factory, ch in (("24 kHz", encodec_model_24khz, 1),
                              ("48 kHz", encodec_model_48khz, 2)):
        model = factory(kmeans_init=False, device=ARGS.device)
        wav = speech_like(seconds, model.sample_rate, ch,
                          seed=24 if ch == 1 else 48)
        out.append(audit_model(torch, model, wav, name))
        del model
        reset_peak(torch)
    return out


# ---------------------------------------------------------------------------
# (b) bf16 training
# ---------------------------------------------------------------------------

def nights(torch, B: int, seed: int, dev):
    import chip_smoke
    x = np.stack([chip_smoke.breathing_signal(
        ARGS.night or chip_smoke.SEQ_NIGHT, seed * 100 + i)
                  for i in range(B)])[..., None]
    return torch.from_numpy(x).to(dev)


def scalars(m) -> dict:
    return {k: float(v) for k, v in m.items()
            if hasattr(v, "dim") and v.dim() == 0}


def part_train(torch, steps: int, B: int = 16) -> dict:
    import chip_smoke
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.optim import tree_leaves

    dev = torch.device(ARGS.device)
    tmp = tempfile.TemporaryDirectory()
    cfg = chip_smoke.gan_config(tmp.name)
    cfg16 = copy.deepcopy(cfg)
    cfg16["common"]["compute_dtype"] = "bfloat16"
    trainers = {"fp32": Trainer(ConfigNamespace(cfg), [], [],
                                tmp.name + "/a", device=dev),
                "bf16": Trainer(ConfigNamespace(cfg16), [], [],
                                tmp.name + "/b", device=dev)}
    tr32 = trainers["fp32"]
    w = tr32.weights_for_epoch(61)       # commit and the GAN terms on
    s0, _ = tr32.gen_step(tr32.state, nights(torch, B, 1, dev), w)
    sync(torch)
    rep: dict = {"B": B, "steps": steps, "kinds": {}}
    for kind in ("gen", "gan", "disc"):
        runs = {}
        for prec, tr in trainers.items():
            reset_peak(torch)
            s, losses, ms, first = s0, [], [], None
            for i in range(steps):
                x = nights(torch, B, 10 + i, dev)
                sync(torch)
                t0 = time.perf_counter()
                if kind == "disc":
                    s, m = tr.disc_step(s, x, w)
                else:
                    s, m = tr.gen_step(s, x, w, use_gan=kind == "gan",
                                       keep_grads=i == 0)
                sync(torch)
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and kind != "disc":
                    first = (m["codes"].cpu(), m["margins"].cpu())
                losses.append(scalars(m))
                del m, x
            masters = all(t.dtype == torch.float32 for t in tree_leaves(
                (s.params, s.opt_state.mu, s.opt_state.nu, s.disc_params,
                 s.disc_opt_state.mu, s.disc_opt_state.nu)))
            runs[prec] = {"losses": losses, "ms": ms, "first": first,
                          "peak_gib": peak_gib(torch), "masters_f32": masters}
            del s
        keys = [k for k in runs["fp32"]["losses"][0]
                if k.startswith("loss") or k.startswith("logits")]
        gaps = [{k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-30) for k in keys}
                for a, b in zip(runs["fp32"]["losses"],
                                runs["bf16"]["losses"])]
        krep = {"gaps": gaps,
                "ms": {p: runs[p]["ms"] for p in runs},
                "peak_gib": {p: runs[p]["peak_gib"] for p in runs},
                "masters_f32": runs["bf16"]["masters_f32"]}
        if runs["fp32"]["first"] is not None:
            (c32, m32), (c16, m16) = runs["fp32"]["first"], \
                runs["bf16"]["first"]
            diff = (c32 != c16).any(1).reshape(-1)
            flags = ((m32 < TIE) | (m16 < TIE)).any(0)
            krep["codes"] = {"positions": int(diff.numel()),
                             "differ": int(diff.sum()),
                             "outside_flags": int((diff & ~flags).sum())}
        rep["kinds"][kind] = krep
        med = {p: float(np.median(runs[p]["ms"][1:])) for p in runs}
        print(f"train {kind} x {steps} from the common state, B={B}: ms per "
              f"step (median of steps 2-{steps}) fp32 {med['fp32']:.1f}, "
              f"bf16 {med['bf16']:.1f}; peak GiB fp32 "
              f"{runs['fp32']['peak_gib']:.2f}, bf16 "
              f"{runs['bf16']['peak_gib']:.2f}; bf16 masters and Adam "
              f"float32: {krep['masters_f32']}"
              + (f"; step 1's codes differ at {krep['codes']['differ']} of "
                 f"{krep['codes']['positions']} positions, "
                 f"{krep['codes']['outside_flags']} outside the tie flags"
                 if "codes" in krep else ""))
        for i, g in enumerate(gaps):
            print(f"    step {i + 1}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in g.items()))
    tmp.cleanup()
    return rep


def fit_child(torch, which: str, B: int) -> None:
    """One process: `which`.yaml as written in bf16 at batch B without
    remat: the first step (k-means), then (gan) a GAN generator step and a
    discriminator step. An out-of-memory ends the process."""
    import chip_smoke
    from encodec_tpu_torch.kernels import build
    from encodec_tpu_torch.train import ConfigNamespace, Trainer

    if ARGS.device == "cuda":
        build.build_all()
    dev = torch.device(ARGS.device)
    tmp = tempfile.TemporaryDirectory()
    cfg = (chip_smoke.gan_config if which == "gan"
           else chip_smoke.train_config)(tmp.name)
    cfg["common"]["compute_dtype"] = "bfloat16"
    cfg["dataset"]["batch_size"] = B
    tr = Trainer(ConfigNamespace(cfg), [], [], tmp.name + "/r", device=dev)
    w = tr.weights_for_epoch(61 if which == "gan" else 31)
    out = {"which": which, "B": B, "ms": {}, "gib": {}}
    s = tr.state
    kinds = ["gen 1", "gen"] + (["gan", "disc"] if which == "gan" else [])
    for kind in kinds:
        print(f"FITSTEP {kind}", flush=True)
        x = nights(torch, B, 7, dev)
        sync(torch)
        reset_peak(torch)
        t0 = time.perf_counter()
        if kind == "disc":
            s, _ = tr.disc_step(s, x, w)
        else:
            s, _ = tr.gen_step(s, x, w, use_gan=kind == "gan")
        sync(torch)
        out["ms"][kind] = (time.perf_counter() - t0) * 1e3
        out["gib"][kind] = peak_gib(torch)
        del x
    print("FIT " + json.dumps(out))
    tmp.cleanup()


def fits(B: int) -> list:
    rows = []
    for which in ("gan", "default"):
        t0 = time.perf_counter()
        extra = ["--device", ARGS.device] + (
            ["--night", str(ARGS.night)] if ARGS.night else [])
        proc = subprocess.run([sys.executable, __file__, "--fit", which,
                               "--batch", str(B), *extra],
                              capture_output=True, text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("FIT ")]
        row = {"which": which, "B": B, "rc": proc.returncode,
               "s": time.perf_counter() - t0}
        if proc.returncode == 0 and line:
            row.update(json.loads(line[-1][4:]), fits=True)
        else:
            row["fits"] = False
            row["oom"] = "OutOfMemoryError" in proc.stderr
            row["at"] = [ln[8:] for ln in proc.stdout.splitlines()
                         if ln.startswith("FITSTEP ")][-1:]
            row["err"] = [ln[:300] for ln in
                          proc.stderr.strip().splitlines()[-1:]]
        rows.append(row)
        print(f"fit {which}.yaml as written, bf16, B={B}, no remat: "
              + ("fits; ms per step " + ", ".join(
                  f"{k} {v:.1f}" for k, v in row["ms"].items())
                 + "; peak GiB " + ", ".join(
                     f"{k} {v:.2f}" for k, v in row["gib"].items())
                 if row["fits"] else
                 f"does not fit (exit {row['rc']}, out of memory: "
                 f"{row['oom']}, in the step {row['at']}: {row['err']})"))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", default="all",
                    choices=("codec", "train", "fits", "all"))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fit", choices=("gan", "default"))
    ap.add_argument("--batch", type=int, default=32,
                    help="the batch of the --fit runs")
    ap.add_argument("--train_batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--night", type=int, default=None,
                    help="samples per night (default: 4 h at 10 Hz)")
    ap.add_argument("--out", help="also write the whole summary, every "
                    "bandwidth and step, as JSON to this file")
    args = ap.parse_args()
    ARGS.device, ARGS.night = args.device, args.night

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("precision_audit: no CUDA device", file=sys.stderr)
        return 2
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build

    set_fp32_policy()
    if args.fit:
        fit_child(torch, args.fit, args.batch)
        return 0
    if args.device == "cuda":
        print(smi())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s")
    summary: dict = {}
    if args.part in ("codec", "all"):
        t0 = time.perf_counter()
        summary["codec"] = part_codec(torch, args.seconds)
        print(f"codec audit: {time.perf_counter() - t0:.1f} s")
    if args.part in ("train", "fits", "all"):
        # the batches that may not fit first, each in a process of its own,
        # while this process holds no memory on the card
        t0 = time.perf_counter()
        reset_peak(torch)
        summary["fits"] = fits(args.batch)
        if args.part != "fits":
            summary["train"] = part_train(torch, args.steps,
                                          args.train_batch)
        print(f"train audit: {time.perf_counter() - t0:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, default=str))
    print(json.dumps({"codec": [
        {"model": r["model"], **{m: {
            "dz_max": v["dz_max"],
            "threshold": v["smallest_flagging_threshold"]}
            for m, v in r["modes"].items()},
         "writer_refuses": r["writer_refuses"]}
        for r in summary.get("codec", [])],
        "fits": [{k: r.get(k) for k in ("which", "B", "fits", "gib")}
                 for r in summary.get("fits", [])]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
