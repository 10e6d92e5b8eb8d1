"""Pipeline parallelism for the entropy-model transformer (GPipe over ranks).

Port of `encodec_tpu/parallel/pp.py` (`stack_lm_layers`,
`shard_stacked_layers`, `lm_forward_batch_pp`, `make_lm_pp_train_step`).
The LM's L layers split into S = ranks of the `pipe` axis stages of L/S
layers (stage s holds layers `[s·L/S, (s+1)·L/S)`); the batch splits into
M microbatches. Where JAX runs one program (a `lax.scan` over S+M-1 ticks
with a `ppermute` per tick, and autodiff for the reverse schedule), torch
runs the schedule by hand:
- forward: stage 0 runs the replicated prologue (embeddings, input norm,
  positions); each stage runs its layers on microbatch m and sends the
  activations to the next stage (`comm.send` / `comm.recv`);
- the last stage runs the head on all M outputs, and the logits (or
  probabilities) are broadcast to every rank;
- training: the last stage's loss is backpropagated through the head,
  then the microbatches go backward in reverse, each stage sending its
  inputs' cotangents upstream; stage 0 finally backpropagates through the
  prologue. The replicated prologue's and head's gradients are summed over
  the stages (only the stage that used them has any), the clip sees the
  global norm over every stage's layers, and the update is the port's
  optax-equal Adam (`train.lm_train`).

The forward is the offline `lm_forward_batch` split into pieces, so it
agrees with it to float rounding (a different grouping of the batch).
Only a 1-D `pipe` mesh is supported.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..models.lm import LMConfig, _transformer_layer, lm_head, lm_prologue
from ..train.optim import adam_update, tree_leaves, tree_map
from . import comm


def stack_lm_layers(params: dict, n_stages: int) -> tp.Tuple[dict, dict]:
    """Split LM params into (stacked trunk, replicated rest): the per-layer
    dicts (`params["layers"]`, a length-L list) stacked leaf-wise into
    `[S, L/S, ...]` tensors (stage, then layer within the stage), and the
    embeddings, input norm and heads unchanged."""
    layers = params["layers"]
    L = len(layers)
    if L % n_stages != 0:
        raise ValueError(
            f"num_layers={L} not divisible by n_stages={n_stages}")
    stacked = tree_map(lambda *xs: torch.stack(xs).reshape(
        (n_stages, L // n_stages) + xs[0].shape), *layers)
    other = {k: v for k, v in params.items() if k != "layers"}
    return stacked, other


def shard_stacked_layers(stacked: dict, mesh,
                         axis_name: str = "pipe") -> dict:
    """This rank's stage of the stacked trunk, `[1, L/S, ...]` leaves."""
    r = mesh.get_local_rank(axis_name)
    return tree_map(lambda v: v[r:r + 1].clone(), stacked)


def _stage_layers(local: dict) -> tp.List[dict]:
    """The `[1, L/S, ...]` stage as a list of per-layer dicts."""
    n = tree_leaves(local)[0].shape[1]
    return [tree_map(lambda v, j=j: v[0, j], local) for j in range(n)]


def _apply_stage(layers: tp.List[dict], x: torch.Tensor, mask: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    zero = x.new_zeros((x.shape[0], 1, x.shape[-1]))
    for layer in layers:
        x, _ = _transformer_layer(layer, x, zero, mask, num_heads)
    return x


def _local_stage(stacked: dict, group) -> dict:
    """Accept the whole `[S, ...]` stack or this rank's `[1, ...]` stage."""
    lead = tree_leaves(stacked)[0].shape[0]
    if lead == comm.world(group) and lead > 1:
        r = comm.rank(group)
        return tree_map(lambda v: v[r:r + 1], stacked)
    return stacked


def _microbatches(B: int, n_microbatches: tp.Optional[int], S: int) -> int:
    M = n_microbatches if n_microbatches is not None else S
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    return M


def _pipeline_forward(layers, x_mb: tp.List[torch.Tensor], mask,
                      cfg: LMConfig, group, keep_graph: bool):
    """Run the M microbatches through this stage. Returns (inputs,
    outputs) per microbatch; the inputs received from the previous stage
    are leaves that require a gradient when `keep_graph`."""
    r, S = comm.rank(group), comm.world(group)
    ins, outs = [], []
    for m, xm in enumerate(x_mb):
        if r > 0:
            xm = comm.recv(xm, r - 1, group)
            if keep_graph:
                xm.requires_grad_(True)
        out = _apply_stage(layers, xm, mask, cfg.num_heads)
        if r + 1 < S:
            comm.send(out, r + 1, group)
        ins.append(xm)
        outs.append(out)
    return ins, outs


def lm_forward_batch_pp(stacked: dict, other: dict, indices: torch.Tensor,
                        cfg: LMConfig, mesh,
                        n_microbatches: tp.Optional[int] = None,
                        axis_name: str = "pipe", offset: int = 0,
                        return_logits: bool = False) -> torch.Tensor:
    """Pipelined `lm_forward_batch`: `indices` `[B, K, T]` (shifted codes,
    the same on every rank) → `[B, card, K, T]` probabilities (logits with
    `return_logits`) on every rank. `stacked` is `stack_lm_layers`' stack
    or this rank's stage (`shard_stacked_layers`); the batch splits into
    `n_microbatches` (default: the pipeline depth)."""
    group = mesh.get_group(axis_name)
    S, r = comm.world(group), comm.rank(group)
    B, K, T = indices.shape
    M = _microbatches(B, n_microbatches, S)
    layers = _stage_layers(_local_stage(stacked, group))
    with torch.no_grad():
        x, mask = lm_prologue(other, indices, cfg, offset)
        _, outs = _pipeline_forward(layers, list(x.chunk(M)), mask, cfg,
                                    group, keep_graph=False)
        card = other["linears"]["w"].shape[-1]
        head = (lm_head(other, torch.cat(outs), K, return_logits)
                if r == S - 1 else x.new_empty((B, card, K, T)))
        return comm.broadcast(head, S - 1, group)


def make_lm_pp_train_step(cfg: LMConfig, opt, mesh,
                          n_microbatches: tp.Optional[int] = None,
                          axis_name: str = "pipe"):
    """The pipelined LM training step: `step(params, opt_state, codes) ->
    (params, opt_state, metrics)` with `params = (stage, other)`, `stage`
    this rank's `[1, L/S, ...]` layers (`shard_stacked_layers`) and
    `other` the replicated rest; `opt_state` from
    `train.lm_train.create_lm_train_state((stage, other))`. The metrics
    (`nll`, `bits_per_code`, `grad_norm` over every stage) are the same
    on every rank; `step(..., keep_grads=True)` also returns "grads", the
    `(stage, other)` gradient before the clip."""
    from ..train.lm_train import B1, B2, EPS, shift_codes

    group = mesh.get_group(axis_name)
    S, r = comm.world(group), comm.rank(group)

    def step(params, opt_state, codes: torch.Tensor,
             keep_grads: bool = False):
        stage, other = params
        stage = tree_map(lambda t: t.detach().requires_grad_(True), stage)
        other = tree_map(lambda t: t.detach().requires_grad_(True), other)
        codes = codes.long()
        B, K, T = codes.shape
        M = _microbatches(B, n_microbatches, S)
        layers = _stage_layers(stage)
        with torch.enable_grad():
            x, mask = lm_prologue(other, shift_codes(codes), cfg)
            x_leaf = x.detach().requires_grad_(True)
            ins, outs = _pipeline_forward(layers, list(x_leaf.chunk(M)),
                                          mask, cfg, group, keep_graph=True)
            if r == S - 1:
                ends = [o.detach().requires_grad_(True) for o in outs]
                logits = lm_head(other, torch.cat(ends), K,
                                 return_logits=True)
                loss = F.cross_entropy(logits, codes)
                torch.autograd.backward(loss)
                cots = [e.grad for e in ends]
            else:
                loss = x.new_zeros(())
            # the microbatches backward in reverse, cotangents upstream
            for m in reversed(range(M)):
                if r < S - 1:
                    cot = comm.recv(outs[m], r + 1, group)
                else:
                    cot = cots[m]
                torch.autograd.backward(outs[m], cot)
                if r > 0:
                    comm.send(ins[m].grad, r - 1, group)
            if r == 0:
                torch.autograd.backward(x, x_leaf.grad)
        grad = (lambda t: torch.zeros_like(t) if t.grad is None else t.grad)
        g_stage = tree_map(grad, stage)
        # the prologue's gradient lives on stage 0, the head's on the last
        g_other = comm.all_reduce_tree(tree_map(grad, other), group)
        sq = sum(g.square().sum() for g in tree_leaves(g_stage))
        norm = (comm.all_reduce(sq, "sum", group)
                + sum(g.square().sum() for g in tree_leaves(g_other))).sqrt()
        grads = raw = (g_stage, g_other)
        if opt.clip:
            # optax's clip_by_global_norm with the norm over every stage
            grads = tree_map(lambda g: torch.where(
                norm < opt.clip, g, g / norm * opt.clip), grads)
        with torch.no_grad():
            new_params, opt_state, _ = adam_update(
                grads, opt_state, tree_map(torch.Tensor.detach,
                                           (stage, other)),
                opt.lr, clip=None, b1=B1, b2=B2, eps=EPS)
        loss = comm.broadcast(loss.detach(), S - 1, group)
        metrics = {"nll": loss, "bits_per_code": loss / math.log(2.0),
                   "grad_norm": norm.detach()}
        if keep_grads:
            metrics["grads"] = raw
        return new_params, opt_state, metrics

    return step
