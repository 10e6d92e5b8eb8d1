"""Training steps: the generator step (with or without the GAN terms), the
balanced generator step, the discriminator step and the eval step.

Port of `encodec_tpu/train/steps.py` (`LossWeights`, `TrainState`,
`create_train_state`, `make_train_steps`). Behavioral reference:
encodec/train.py:39-188 — generator loss = w_l1·L1 + w_freq·spectral +
w_l2·L2 + (w_commit + w_codebook)·commit (+ w_g·l_g + w_feat·l_feat in the
GAN phase), Adam(β=0.8, 0.9) with global-norm clip 0.1 for the generator
and the discriminator alike (`train/optim.py`), the discriminator trained
with the DAC LSGAN loss.

The GAN terms take one of JAX's three routes: the chunked discriminator
(`disc_cfg.time_chunk`: `models.msstftd.msstftd_gan_sums_chunked`, O(chunk)
memory), `disc_remat` (each resolution under `torch.utils.checkpoint`), or
the plain whole-signal forward. Gradients are taken for the generator's
leaves only in the generator step (the real signal's branch builds no
graph) and for the discriminator's only in the discriminator step, whose
generator forward runs without a graph and whose quantizer update is
dropped, as JAX's is.

On the card every kernel of the path runs inside the step: K3's saving
forward and its backward kernel for the four LSTM layers, K1 for every
RVQ search (and every k-means iteration of the first batch), the plain K3
launch in the discriminator step's generator forward, K2 in the eval step.
The discriminator's convs are cuDNN's. `plain=True` runs every plain twin
instead (the reference the kernels are held to on the card).

Data parallelism (`mesh=`, JAX's `make_train_steps(mesh=)`): each rank
passes its rows of the global batch (`parallel.shard_batch`) and a state
identical on every rank. The steps hand `dp`, a `parallel.comm.
DataParallel` over the mesh's `data` axis (`ops.batch_reduce.LOCAL`
without a mesh), to every loss, the balancer and the quantizer: every loss
is a mean over the global batch (JAX's SPMD semantics), the quantizer's
statistics and draws see the global rows (`quant.rvq`), the balancer's
norms are global, and the gradients are summed over ranks in flat buckets
(`comm.all_reduce_tree`) before the clip and Adam, so the clip sees the
global norm and every rank takes the same update: the step equals the
single-process step on the whole batch, to float rounding. The scalar
metrics are global, hence equal on every rank, and each step ends by
checking that they are (`dp.check_replicated`: a loss term that missed
`dp` raises); the codes and margins of `keep_grads` and eval's per-item
losses are the rank's own rows.

Data × seq (`mesh=` with a `data` and a `seq` axis, JAX's 2-D mesh
step): the batch is split over `data` as above and time over `seq`. Each
rank passes its data rows, whole in time (the seq peers pass the same
rows); `models.forward_train(seq=)` runs the conv trunks on this rank's
time shard (`parallel.sp`), gathers the token-rate features for the
LSTM (K3's saving forward and backward kernels, on every seq rank) and
the RVQ (K1, on the whole latents, its statistics and draws reduced over
`data` only through `dp`), and gathers `x_hat`. The losses then see the
whole signal of the rank's rows. By route:
- the L1/L2, spectral, commit and balanced terms, and the GAN terms by
  the whole-signal and `disc_remat` routes, run replicated on every seq
  rank;
- the chunked GAN route (`disc_cfg.time_chunk`) shares the chunks: each
  seq rank sums its block of them, and the sums of every resolution are
  added over seq (one `comm.sum_over`) and then over data (`dp.sum`).

The convention that makes this step the single-process step:
- every cotangent that crosses a sharded or replicated boundary is
  partial, this rank's share: the true cotangent is the sum over the seq
  ranks. Each seq collective's backward is its forward's adjoint under
  that rule: a halo's cotangent goes back to the rank that sent it, a
  gather's backward is a reduce-scatter (`comm.gather_time`), the slice
  of a replicated tensor passes its zero-padded cotangent, a sum over seq
  has an all-reduce backward (`comm.sum_over`);
- a replicated loss counts once in total: every rank computes the same
  loss, and its backward starts from `1/seq` (`_grads(..., share)`;
  the balanced step scales its cotangents alike). A chunked GAN sum is
  not replicated but shared, and the all-reduce backward of `sum_over`
  gives each block back the whole of its weight;
- `dp`'s data reductions keep their identity backward (each data rank
  holds the global loss over data);
- every parameter gradient is summed over all data×seq ranks
  (`comm.all_reduce_tree` over the world) before the clip and Adam.
So the world's gradient is the single process's, leaf by leaf; a leaf fed
by a complete cotangent on every seq rank would come out `seq` times too
large, which the CPU tests' gradient bound catches. The scalar metrics
must come out equal on every rank of the world (`dp.check_replicated`).
Sharded time is refused where it is not exact
(`parallel.sp.check_seq_parallel`: a non-causal model, time group norm,
`audio_normalize`, `model.remat`, a length that is not a multiple of
seq × hop). Stage remat is refused rather than sharded, because its
recomputed region would rerun the per-layer halo exchanges (no collective
runs in a recomputed region: the chunked GAN route's bodies hold none, and
`disc_remat` runs replicated). A seq axis of one rank runs the
data-parallel step.

Mixed precision (`compute_dtype=torch.bfloat16`, JAX's `make_train_steps(
compute_dtype=)`): every step (generator, GAN generator by its three
routes, discriminator, balanced, eval) runs the SEANet conv trunks and the
discriminator's conv stack in bf16, each conv casting its weights from the
float32 masters (`ops.conv`, `ops.conv2d`). The float32 islands are JAX's:
the LSTM recurrence (K3 and its backward), the RVQ (K1's searches, the EMA
statistics), the STFT, the logits, every loss and feature-map sum, the
master parameters and the Adam state. No autocast wraps a step. Under a
mesh the same casts run on every rank; the seq exchanges carry float32 on
the wire (`parallel.comm`).

Tracing (`utils.profiling`): the generator and discriminator steps are
the spans `train.gen_step` and `train.disc_step`, each holding
`train.forward`, `train.loss`, `train.backward` and the optimizer's
`optim.adam`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses.balancer import Balancer, balance, init_balancer_state
from ..losses.gan import disc_loss, total_loss
from ..losses.spectrogram import reconstruction_loss
from ..models.model import EncodecConfig, forward_train
from ..ops.batch_reduce import LOCAL, BatchReduce
from ..models.msstftd import (MSSTFTConfig, init_msstftd, msstftd_forward,
                              msstftd_gan_sums_chunked, msstftd_num_fmaps,
                              msstftd_sub_forward)
from ..ops.conv import spectral_norm_update_tree
from ..parallel import comm
from ..parallel.sp import check_seq_parallel
from ..quant import RVQState
from ..utils.profiling import span
from .optim import AdamState, adam_update, init_adam, tree_leaves, tree_map

COMPUTE_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                  "bfloat16": torch.bfloat16}


def resolve_compute_dtype(compute_dtype) -> torch.dtype:
    """torch.float32 (also for None) or torch.bfloat16, from a dtype or its
    name (`common.compute_dtype` in a config); anything else raises."""
    if compute_dtype is None:
        return torch.float32
    if compute_dtype in (torch.float32, torch.bfloat16):
        return compute_dtype
    if str(compute_dtype) in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[str(compute_dtype)]
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}: "
                     "float32 or bfloat16")


DISC_SEED_OFFSET = 1 << 20


def _f32(v) -> float:
    return float(np.float32(v))


class LossWeights(tp.NamedTuple):
    """Per-step loss weights and learning rates, rounded to float32 as the
    JAX package holds them."""
    l1: float
    l2: float
    freq: float
    commit: float
    codebook: float
    gen: float
    feat: float
    lr: float
    disc_lr: float

    @classmethod
    def make(cls, *, l1=1.0, l2=0.0, freq=1.0, commit=0.0, codebook=0.0,
             gen=3.0, feat=3.0, lr=1e-4, disc_lr=3e-4):
        return cls(*(_f32(v) for v in
                     (l1, l2, freq, commit, codebook, gen, feat, lr, disc_lr)))


class TrainState(tp.NamedTuple):
    """JAX's `TrainState` fields: `params` (unfolded weight norm),
    `qstate`, `opt_state` (`AdamState`), the discriminator's parameters
    and `AdamState` and the balancer's EMA state (None when unused), and
    `rng`, the state of the CPU `torch.Generator` the steps draw from
    (uint8)."""
    params: tp.Any
    qstate: RVQState
    opt_state: AdamState
    disc_params: tp.Any
    disc_opt_state: tp.Any
    balancer_state: tp.Any
    rng: torch.Tensor


def create_train_state(model, disc_cfg: tp.Optional[MSSTFTConfig] = None,
                       seed: int = 0, clip: tp.Optional[float] = 0.1,
                       balancer: tp.Optional[Balancer] = None) -> TrainState:
    """A fresh `TrainState` for an `EncodecModel`: its parameters (copied)
    and quantizer state, zero Adam moments, and the steps' generator seeded
    with `seed`; with `disc_cfg`, a discriminator drawn from a generator of
    its own (seeded with `seed + DISC_SEED_OFFSET`: JAX splits its key in
    two) and its zero Adam moments; with `balancer`, its EMA state. (`clip`
    shapes nothing here; it is taken for JAX's signature.)"""
    params = tree_map(lambda t: t.detach().clone(), model.params)
    device = model.qstate.embed.device
    disc = disc_opt = None
    if disc_cfg is not None:
        disc = init_msstftd(
            torch.Generator().manual_seed(seed + DISC_SEED_OFFSET), disc_cfg,
            device)
        disc_opt = init_adam(disc)
    return TrainState(
        params=params, qstate=model.qstate, opt_state=init_adam(params),
        disc_params=disc, disc_opt_state=disc_opt,
        balancer_state=(init_balancer_state(balancer, device)
                        if balancer is not None else None),
        rng=torch.Generator().manual_seed(seed).get_state())


def _grads(outputs, params, grad_outputs=None) -> tp.Any:
    """The gradient of `outputs` (with cotangents `grad_outputs`) for every
    leaf of `params` (zeros where they do not depend on it), as a tree
    shaped like `params`."""
    leaves = tree_leaves(params)
    flat = torch.autograd.grad(outputs, leaves, grad_outputs=grad_outputs,
                               allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, flat)}
    return tree_map(lambda p: by_leaf[id(p)], params)


def _with_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _chunk_sums(subs, disc_cfg: MSSTFTConfig, batch: torch.Tensor,
                x_hat: torch.Tensor, dp: BatchReduce, seq=None,
                compute_dtype: torch.dtype = torch.float32) -> list:
    """Each sub-discriminator's chunked GAN sums over the global batch, all
    reduced in one exchange. Under `seq` (a process group) this rank sums
    its block of the chunks, and the blocks' sums are first added over seq
    (`comm.sum_over`, all-reduce backward); the logit counts are the whole
    signal's on every seq rank and are added over data only."""
    shard = (0, 1) if seq is None else (comm.rank(seq), comm.world(seq))
    per = [msstftd_gan_sums_chunked(sub, batch, x_hat, disc_cfg, i,
                                    chunk=disc_cfg.time_chunk, shard=shard,
                                    compute_dtype=compute_dtype)
           for i, sub in enumerate(subs)]
    keys = [[k for k in sums if k != "n_logit"] for sums in per]
    shared = torch.cat([sums[k].reshape(-1)
                        for sums, ks in zip(per, keys) for k in ks])
    if seq is not None:
        shared = comm.sum_over(shared, seq)
    flat = dp.sum(torch.cat([shared] + [sums["n_logit"].reshape(1)
                                        for sums in per]))
    out, at = [], 0
    for sums, ks in zip(per, keys):
        got = {}
        for k in ks:
            n = sums[k].numel()
            got[k] = flat[at:at + n].reshape(sums[k].shape)
            at += n
        out.append(got)
    for got, n_logit in zip(out, flat[at:]):
        got["n_logit"] = n_logit
    return out


def gan_terms(disc_params, disc_cfg: MSSTFTConfig, batch: torch.Tensor,
              x_hat: torch.Tensor, disc_remat: bool = False,
              dp: BatchReduce = LOCAL, seq=None,
              compute_dtype: torch.dtype = torch.float32):
    """The generator's GAN terms `(l_g, l_feat)` by JAX's route for the
    config: the chunked discriminator (`disc_cfg.time_chunk`), each
    resolution recomputed in the backward (`disc_remat`), or the whole
    signal. The real signal's branch builds no graph; `dp` reduces the
    batch means; under `seq` the chunked route shares the chunks over its
    ranks (`_chunk_sums`), the other two run replicated. The conv stacks
    run in `compute_dtype`; the feature-map means are float32."""
    n_subs = len(disc_params["discs"])
    n_feat = n_subs * msstftd_num_fmaps(disc_cfg)
    l_g = l_feat = batch.new_zeros(())
    if disc_cfg.time_chunk:
        for sums in _chunk_sums(disc_params["discs"], disc_cfg, batch,
                                x_hat, dp, seq, compute_dtype):
            l_g = l_g + sums["lg_fake"] / sums["n_logit"]
            # mean|real - fake| / mean|real| per layer: the counts cancel
            l_feat = l_feat + (sums["feat_diff"] / sums["feat_real"]).sum()
        return l_g / n_subs, l_feat / n_feat
    if disc_remat:
        for i, sub in enumerate(disc_params["discs"]):
            def one(x_hat, i=i, sub=sub):
                logits_fake, fmap_fake = msstftd_sub_forward(
                    sub, x_hat, disc_cfg, i, compute_dtype)
                with torch.no_grad():
                    _, fmap_real = msstftd_sub_forward(sub, batch, disc_cfg,
                                                       i, compute_dtype)
                diff = torch.stack([(fr.float() - ff.float()).abs().mean()
                                    for fr, ff in zip(fmap_real, fmap_fake)])
                real = torch.stack([fr.float().abs().mean()
                                    for fr in fmap_real])
                return (1.0 - logits_fake).square().mean(), diff, real
            # the ranks' means are combined outside the recomputed region,
            # so no collective runs in the backward
            lg, diff, real = checkpoint(one, x_hat, use_reentrant=False)
            diff, real = dp.mean(diff), dp.mean(real)
            lf = batch.new_zeros(())
            for j in range(diff.shape[0]):
                lf = lf + diff[j] / real[j]
            l_g = l_g + dp.mean(lg)
            l_feat = l_feat + lf
        return l_g / n_subs, l_feat / n_feat
    with torch.no_grad():
        _, fmap_real = msstftd_forward(disc_params, batch, disc_cfg,
                                       compute_dtype)
    logits_fake, fmap_fake = msstftd_forward(disc_params, x_hat, disc_cfg,
                                             compute_dtype)
    lg = total_loss(fmap_real, logits_fake, fmap_fake, batch, x_hat, dp)
    return lg["l_g"], lg["l_feat"]


def disc_losses(disc_params, disc_cfg: MSSTFTConfig, batch: torch.Tensor,
                x_hat: torch.Tensor, disc_remat: bool = False,
                dp: BatchReduce = LOCAL, seq=None,
                compute_dtype: torch.dtype = torch.float32):
    """The discriminator's LSGAN loss and its mean logits on the real and
    the fake signal, `(loss, logits_real, logits_fake)`, by the same three
    routes as `gan_terms` (and the same sharing under `seq`), the conv
    stacks in `compute_dtype`."""
    subs = disc_params["discs"]
    if disc_cfg.time_chunk or disc_remat:
        loss = lr_mean = lf_mean = batch.new_zeros(())
        chunked = (_chunk_sums(subs, disc_cfg, batch, x_hat, dp, seq,
                               compute_dtype)
                   if disc_cfg.time_chunk else None)
        for i, sub in enumerate(subs):
            if chunked is not None:
                sums = chunked[i]
                n = sums["n_logit"]
                l_i = (sums["sq_fake"] + sums["lg_real"]) / n
                lr_i, lf_i = sums["sum_real"] / n, sums["sum_fake"] / n
            else:
                def one(i=i, sub=sub):
                    lr, _ = msstftd_sub_forward(sub, batch, disc_cfg, i,
                                                compute_dtype)
                    lf, _ = msstftd_sub_forward(sub, x_hat, disc_cfg, i,
                                                compute_dtype)
                    return (lf.square().mean(), (1.0 - lr).square().mean(),
                            lr.mean(), lf.mean())
                sq_f, sq_r, lr_i, lf_i = checkpoint(one, use_reentrant=False)
                l_i = dp.mean(sq_f) + dp.mean(sq_r)
                lr_i, lf_i = dp.mean(lr_i), dp.mean(lf_i)
            loss = loss + l_i
            lr_mean = lr_mean + lr_i
            lf_mean = lf_mean + lf_i
        return loss / len(subs), lr_mean / len(subs), lf_mean / len(subs)
    logits_real, _ = msstftd_forward(disc_params, batch, disc_cfg,
                                     compute_dtype)
    logits_fake, _ = msstftd_forward(disc_params, x_hat, disc_cfg,
                                     compute_dtype)
    return (disc_loss(logits_real, logits_fake, dp),
            sum(dp.mean(lg.mean()) for lg in logits_real) / len(logits_real),
            sum(dp.mean(lg.mean()) for lg in logits_fake) / len(logits_fake))


def make_train_steps(model_cfg: EncodecConfig,
                     disc_cfg: tp.Optional[MSSTFTConfig] = None, *,
                     n_q: tp.Optional[int] = None,
                     freq_loss_kwargs: tp.Optional[dict] = None,
                     balancer: tp.Optional[Balancer] = None,
                     clip: tp.Optional[float] = 0.1,
                     compute_dtype=None, disc_remat: bool = False,
                     plain: bool = False, mesh=None):
    """Build `(gen_step, disc_step, eval_step, balanced_gen_step)`, as JAX's
    `make_train_steps` (`balanced_gen_step` is None without a balancer).

    gen_step(state, batch [B, T, C], weights, use_gan=False,
             keep_grads=False) → (new_state, metrics); with `keep_grads`,
        `metrics` also holds "grads" (the gradient tree, before clipping),
        "codes" [B, K, T'] and "margins" [K, B·T'] (each stage's top-2
        search margins).
    disc_step(state, batch, weights, keep_grads=False) → (new_state,
        metrics); with `keep_grads`, "grads" (the discriminator's).
    eval_step(state, batch, weights) → (metrics, codes [B, K, T'], x_hat)
    balanced_gen_step(state, batch, weights, keep_grads=False) →
        (new_state, metrics)

    `batch` is a float32 tensor on the parameters' device. The steps are
    functional: `state` is not modified. `disc_remat=True` recomputes each
    STFT resolution's GAN terms in the backward (less memory, the same
    values); `disc_cfg.time_chunk` supersedes it.

    `mesh` (a `DeviceMesh` with a "data" axis): each step is the
    data-parallel step on this rank's rows of the global batch (see the
    module's docstring). A mesh of one rank runs the same code and gives
    the plain step's bits. With a "seq" axis too (`parallel.make_mesh_2d`),
    time is sharded over it: the data×seq step, its convention in the
    module's docstring; what cannot be sharded raises `ValueError` here
    or, for the length, at the step.

    `compute_dtype` (`torch.bfloat16` or "bfloat16"; None or float32 is
    the float32 step): the conv trunks' dtype in every step (see the
    module's docstring)."""
    compute_dtype = resolve_compute_dtype(compute_dtype)
    n_q = n_q or model_cfg.rvq.n_q
    fl_kwargs = dict(alpha=0.01, bandwidth=None, sampling_rate=10, n_fft=512)
    fl_kwargs.update(freq_loss_kwargs or {})

    group = None if mesh is None else mesh.get_group("data")
    seq = None
    if mesh is not None and "seq" in (mesh.mesh_dim_names or ()) \
            and mesh.size(mesh.mesh_dim_names.index("seq")) > 1:
        seq = mesh.get_group("seq")
        check_seq_parallel(model_cfg, comm.world(seq))
    dp = LOCAL if mesh is None else comm.DataParallel(group)
    # a replicated loss's share on each seq rank (its gradient counts once)
    share = None if seq is None else 1.0 / comm.world(seq)

    def freq_loss(x, x_hat):
        return reconstruction_loss(x[..., 0], x_hat[..., 0], dp=dp,
                                   **fl_kwargs)

    def reduce_grads(grads):
        """Each rank's gradient is its rows' (and its shard's) share of the
        global loss's: their sum over the world is the whole batch's."""
        if mesh is None:
            return grads
        return comm.all_reduce_tree(grads, group if seq is None else None)

    def scaled(t: torch.Tensor) -> tp.Optional[torch.Tensor]:
        """The cotangent of a replicated loss `t` on this rank (None: 1)."""
        return None if share is None else t * share

    def gen_step(state: TrainState, batch: torch.Tensor,
                 weights: LossWeights, use_gan: bool = False,
                 keep_grads: bool = False):
        if use_gan and (disc_cfg is None or state.disc_params is None):
            raise ValueError("use_gan needs a discriminator config and "
                             "state")
        with span("train.gen_step"):
            return _gen_step(state, batch, weights, use_gan, keep_grads)

    def _gen_step(state, batch, weights, use_gan, keep_grads):
        generator = torch.Generator()
        generator.set_state(state.rng)
        # the spectral-norm power iteration (the identity without it)
        params_in = spectral_norm_update_tree(state.params)
        params = _with_grad(params_in)
        margins: tp.Optional[list] = [] if keep_grads else None
        with torch.enable_grad():
            with span("train.forward"):
                x_hat, codes, commit, new_qstate = forward_train(
                    params, state.qstate, batch, model_cfg, n_q, generator,
                    training=True, plain=plain, dp=dp, seq=seq,
                    margins=margins, compute_dtype=compute_dtype)
            with span("train.loss"):
                commit_mean = commit.mean()
                freq = freq_loss(batch, x_hat)
                losses_g = total_loss(None, None, None, batch, x_hat, dp)
                loss = (losses_g["l_1"] * weights.l1
                        + freq["total_loss"] * weights.freq
                        + losses_g["l_2"] * weights.l2
                        + commit_mean * weights.commit
                        + commit_mean * weights.codebook)
                if use_gan:
                    l_g, l_feat = gan_terms(state.disc_params, disc_cfg,
                                            batch, x_hat, disc_remat, dp, seq,
                                            compute_dtype)
                    loss = loss + l_g * weights.gen + l_feat * weights.feat
            with span("train.backward"):
                grads = reduce_grads(_grads(loss, params,
                                            scaled(torch.ones_like(loss))))
        new_params, new_opt, grad_norm = adam_update(
            grads, state.opt_state, params_in, weights.lr, clip)
        metrics = {
            "loss": loss.detach(),
            "loss_l1": losses_g["l_1"].detach(),
            "loss_l2": losses_g["l_2"].detach(),
            "loss_freq": freq["total_loss"].detach(),
            "loss_freq_l1": freq["l1_loss"].detach(),
            "loss_freq_l2": freq["l2_loss"].detach(),
            "freq_acc": freq["acc"],
            "loss_commit": commit_mean.detach(),
            "grad_norm": grad_norm,
        }
        if use_gan:
            metrics.update(loss_gen=l_g.detach(), loss_feat=l_feat.detach())
        dp.check_replicated(metrics)
        if keep_grads:
            metrics.update(grads=grads, codes=codes,
                           margins=torch.stack(margins))
        return state._replace(params=new_params, qstate=new_qstate,
                              opt_state=new_opt,
                              rng=generator.get_state()), metrics

    def balanced_gen_step(state: TrainState, batch: torch.Tensor,
                          weights: LossWeights, keep_grads: bool = False):
        """Balanced waveform losses (l_t, l_f) through the balancer, the
        commit loss's gradient plainly weighted; one backward carries both
        cotangents (JAX: one vjp)."""
        generator = torch.Generator()
        generator.set_state(state.rng)
        params = _with_grad(state.params)
        with torch.enable_grad():
            x_hat, _, commit, new_qstate = forward_train(
                params, state.qstate, batch, model_cfg, n_q, generator,
                training=True, plain=plain, dp=dp, seq=seq,
                compute_dtype=compute_dtype)
            commit_mean = commit.mean()
        loss_fns = {
            "l_t": lambda y: dp.mean((batch - y).abs().mean()),
            "l_f": lambda y: freq_loss(batch, y)["total_loss"],
        }
        cot, losses, new_bal, bal_metrics = balance(
            balancer, loss_fns, x_hat, state.balancer_state, dp)
        # the commit scalar feeds both the commit and the codebook weights
        # (the reference passes one loss under both names, vq.py:114)
        w_commit = commit_mean.new_tensor(weights.commit + weights.codebook)
        if share is not None:
            cot, w_commit = scaled(cot), scaled(w_commit)
        grads = reduce_grads(_grads((x_hat, commit_mean), params,
                                    (cot, w_commit)))
        new_params, new_opt, grad_norm = adam_update(
            grads, state.opt_state, state.params, weights.lr, clip)
        zero = commit_mean.new_zeros(())
        metrics = {f"loss_{k}": v for k, v in losses.items()}
        metrics.update(bal_metrics)
        metrics.update(loss_commit=commit_mean.detach(),
                       loss=losses["l_t"] + losses["l_f"],
                       loss_l1=losses["l_t"], loss_l2=zero,
                       loss_freq=losses["l_f"], freq_acc=zero,
                       grad_norm=grad_norm)
        dp.check_replicated(metrics)
        if keep_grads:
            metrics["grads"] = grads
        return state._replace(params=new_params, qstate=new_qstate,
                              opt_state=new_opt, rng=generator.get_state(),
                              balancer_state=new_bal), metrics

    def disc_step(state: TrainState, batch: torch.Tensor,
                  weights: LossWeights, keep_grads: bool = False):
        if disc_cfg is None or state.disc_params is None:
            raise ValueError("disc_step needs a discriminator config and "
                             "state")
        with span("train.disc_step"):
            return _disc_step(state, batch, weights, keep_grads)

    def _disc_step(state, batch, weights, keep_grads):
        generator = torch.Generator()
        generator.set_state(state.rng)
        disc_in = spectral_norm_update_tree(state.disc_params)
        # the generator's forward as JAX runs it (training mode, its own
        # draws), without a graph; its quantizer update is dropped
        with torch.no_grad(), span("train.forward"):
            x_hat, _, _, _ = forward_train(
                state.params, state.qstate, batch, model_cfg, n_q, generator,
                training=True, plain=plain, dp=dp, seq=seq,
                compute_dtype=compute_dtype)
        disc = _with_grad(disc_in)
        with torch.enable_grad():
            with span("train.loss"):
                loss, lr_mean, lf_mean = disc_losses(
                    disc, disc_cfg, batch, x_hat, disc_remat, dp, seq,
                    compute_dtype)
            with span("train.backward"):
                grads = reduce_grads(_grads(loss, disc,
                                            scaled(torch.ones_like(loss))))
        new_disc, new_opt, grad_norm = adam_update(
            grads, state.disc_opt_state, disc_in, weights.disc_lr, clip)
        metrics = {"loss_disc": loss.detach(),
                   "logits_real": lr_mean.detach(),
                   "logits_fake": lf_mean.detach(),
                   "disc_grad_norm": grad_norm}
        dp.check_replicated(metrics)
        if keep_grads:
            metrics["grads"] = grads
        return state._replace(disc_params=new_disc, disc_opt_state=new_opt,
                              rng=generator.get_state()), metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor,
                  weights: LossWeights):
        x_hat, codes, commit, _ = forward_train(
            state.params, state.qstate, batch, model_cfg, n_q, training=False,
            plain=plain, dp=dp, seq=seq, compute_dtype=compute_dtype)
        freq = freq_loss(batch, x_hat)
        losses_g = total_loss(None, None, None, batch, x_hat, dp)
        loss = (losses_g["l_1"] * weights.l1
                + freq["total_loss"] * weights.freq
                + losses_g["l_2"] * weights.l2
                + commit.mean() * weights.commit)
        metrics = {
            "loss": loss, "loss_l1": losses_g["l_1"],
            "loss_l2": losses_g["l_2"], "loss_freq": freq["total_loss"],
            "freq_acc": freq["acc"], "loss_commit": commit.mean(),
            "l_t": losses_g["l_t"], "l_t_2": losses_g["l_t_2"],
        }
        dp.check_replicated(metrics)
        return metrics, codes, x_hat

    return (gen_step, disc_step, eval_step,
            balanced_gen_step if balancer is not None else None)


