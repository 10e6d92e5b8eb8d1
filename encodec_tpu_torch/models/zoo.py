"""Load reference (PyTorch) EnCodec state dicts into the port's parameters.

Mirrors `encodec_tpu/models/torch_zoo.py` (the walkers over the reference
module tree `encoder.model.{i}...`, `decoder.model.{i}...`,
`quantizer.vq.layers.{k}._codebook...`, and `load_pretrained` with the
sha256-prefix check). Values may be numpy arrays or tensors. The port keeps
torch weight layout, so conv weights (or `weight_g`/`weight_v`, old or
parametrization keys) are taken as they are.

Only a local `repository` is read: the port never downloads checkpoints.

`params_from_jax` takes the JAX package's own parameter tree (as a JAX-
trained `.ckpt` holds it, numpy leaves) to the port's parameters, without
JAX: the transposes of `encodec_tpu/models/torch_zoo.py`'s
`torch_state_from_params`, copied here, then the loader above.
`train_state_from_jax` carries a whole JAX `TrainState` across (params,
quantizer state and the Adam moments, the moments through the same
layout mapping), so the port's trainer resumes a JAX run.

The entropy-coding LM: `lm_params_from_state` reads the reference
`LMModel` state dict (`torch_zoo.py::lm_params_from_torch`), and
`lm_params_from_jax` takes the JAX package's LM tree (numpy leaves), which
has the port's layout already.
"""

from __future__ import annotations

import hashlib
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..quant import RVQConfig, RVQState
from .seanet import SEANetConfig

State = tp.Mapping[str, tp.Any]


def _get(state: State, key: str) -> torch.Tensor:
    v = state[key]
    if isinstance(v, torch.Tensor):
        return v.detach().to(device="cpu", dtype=torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def conv_params_from_state(state: State, prefix: str, norm: str = "none",
                           kind: str = "conv") -> dict:
    """`{prefix}{kind}.*` of a reference NormConv1d (`kind='conv'`) or
    NormConvTranspose1d (`kind='convtr'`)."""
    p: dict = {}
    old = (f"{prefix}{kind}.weight_g", f"{prefix}{kind}.weight_v")
    new = (f"{prefix}{kind}.parametrizations.weight.original0",
           f"{prefix}{kind}.parametrizations.weight.original1")
    if norm == "weight_norm" or old[1] in state or new[1] in state:
        g_key, v_key = old if old[1] in state else new
        p["v"] = _get(state, v_key)
        p["g"] = _get(state, g_key).reshape(-1)  # dim 0 of the torch weight
    else:
        p["w"] = _get(state, f"{prefix}{kind}.weight")
    if f"{prefix}{kind}.bias" in state:
        p["b"] = _get(state, f"{prefix}{kind}.bias")
    if norm in ("layer_norm", "time_group_norm"):
        p["norm"] = {"scale": _get(state, f"{prefix}norm.weight"),
                     "bias": _get(state, f"{prefix}norm.bias")}
    return p


def lstm_params_from_state(state: State, prefix: str, num_layers: int) -> dict:
    return {"layers": [
        {"w_ih": _get(state, f"{prefix}weight_ih_l{i}"),
         "w_hh": _get(state, f"{prefix}weight_hh_l{i}"),
         "b_ih": _get(state, f"{prefix}bias_ih_l{i}"),
         "b_hh": _get(state, f"{prefix}bias_hh_l{i}")}
        for i in range(num_layers)]}


def _resblock(state: State, prefix: str, cfg: SEANetConfig) -> dict:
    # block = Sequential(act, conv, act, conv): convs at odd indices
    p: dict = {"convs": [conv_params_from_state(
        state, f"{prefix}block.{2 * j + 1}.conv.", cfg.norm) for j in range(2)]}
    if not cfg.true_skip:
        p["shortcut"] = conv_params_from_state(
            state, f"{prefix}shortcut.conv.", cfg.norm)
    return p


def encoder_params_from_state(state: State, cfg: SEANetConfig,
                              root: str = "encoder.model.") -> dict:
    idx = 0
    p: dict = {"init_conv": conv_params_from_state(
        state, f"{root}{idx}.conv.", cfg.norm), "stages": []}
    idx += 1
    for _ratio in cfg.encoder_ratios:
        stage: dict = {"res": []}
        for _j in range(cfg.n_residual_layers):
            stage["res"].append(_resblock(state, f"{root}{idx}.", cfg))
            idx += 1
        idx += 1  # activation module
        stage["down"] = conv_params_from_state(state, f"{root}{idx}.conv.",
                                               cfg.norm)
        idx += 1
        p["stages"].append(stage)
    if cfg.lstm:
        p["lstm"] = lstm_params_from_state(state, f"{root}{idx}.lstm.",
                                           cfg.lstm)
        idx += 1
    idx += 1  # activation
    p["final_conv"] = conv_params_from_state(state, f"{root}{idx}.conv.",
                                             cfg.norm)
    return p


def decoder_params_from_state(state: State, cfg: SEANetConfig,
                              root: str = "decoder.model.") -> dict:
    idx = 0
    p: dict = {"init_conv": conv_params_from_state(
        state, f"{root}{idx}.conv.", cfg.norm), "stages": []}
    idx += 1
    if cfg.lstm:
        p["lstm"] = lstm_params_from_state(state, f"{root}{idx}.lstm.",
                                           cfg.lstm)
        idx += 1
    for _ratio in cfg.ratios:
        idx += 1  # activation
        stage: dict = {"up": conv_params_from_state(
            state, f"{root}{idx}.convtr.", cfg.norm, kind="convtr"), "res": []}
        idx += 1
        for _j in range(cfg.n_residual_layers):
            stage["res"].append(_resblock(state, f"{root}{idx}.", cfg))
            idx += 1
        p["stages"].append(stage)
    idx += 1  # activation
    p["final_conv"] = conv_params_from_state(
        state, f"{root}{idx}.conv.", cfg.resolved_decoder_final_norm())
    return p


def quantizer_state_from_state(state: State, cfg: RVQConfig,
                               root: str = "quantizer.vq.layers.") -> RVQState:
    def stack(name):
        return torch.stack([_get(state, f"{root}{k}._codebook.{name}")
                            for k in range(cfg.num_books)])

    inited = state.get(f"{root}0._codebook.inited", [1.0])
    return RVQState(embed=stack("embed"), embed_avg=stack("embed_avg"),
                    cluster_size=stack("cluster_size"),
                    inited=bool(np.asarray(inited, np.float32).reshape(-1)[0]))


def model_params_from_state(state: State, cfg) -> tp.Tuple[dict, RVQState]:
    """Full EncodecModel conversion (`cfg` is an EncodecConfig), on the CPU."""
    params = {"encoder": encoder_params_from_state(state, cfg.seanet),
              "decoder": decoder_params_from_state(state, cfg.seanet)}
    return params, quantizer_state_from_state(state, cfg.rvq)


# ---------------------------------------------------------------------------
# The JAX package's parameter tree -> reference state dict (numpy), a copy
# of `encodec_tpu/models/torch_zoo.py:201-306`: convs `[K, Cin, Cout]` ->
# `[Cout, Cin, K]`, transposed convs `[K, Cout, Cin]` -> `[Cin, Cout, K]`,
# weight-norm gains -> `[C, 1, 1]`, LSTM weights as they are.
# ---------------------------------------------------------------------------

def _conv_to_state(p: dict, prefix: str, out: dict, transposed: bool) -> None:
    kind, axes = ("convtr", (1, 2, 0)) if transposed else ("conv", (2, 1, 0))
    if "v" in p:
        out[f"{prefix}{kind}.weight_v"] = np.asarray(p["v"]).transpose(axes)
        out[f"{prefix}{kind}.weight_g"] = np.asarray(p["g"]).reshape(-1, 1, 1)
    else:
        out[f"{prefix}{kind}.weight"] = np.asarray(p["w"]).transpose(axes)
    if p.get("b") is not None:
        out[f"{prefix}{kind}.bias"] = np.asarray(p["b"])
    if "norm" in p:
        out[f"{prefix}norm.weight"] = np.asarray(p["norm"]["scale"])
        out[f"{prefix}norm.bias"] = np.asarray(p["norm"]["bias"])


def _lstm_to_state(p: dict, prefix: str, out: dict) -> None:
    for i, layer in enumerate(p["layers"]):
        for name in ("ih", "hh"):
            out[f"{prefix}weight_{name}_l{i}"] = np.asarray(layer[f"w_{name}"])
            out[f"{prefix}bias_{name}_l{i}"] = np.asarray(layer[f"b_{name}"])


def _resblock_to_state(p: dict, prefix: str, out: dict) -> None:
    for j, conv_p in enumerate(p["convs"]):
        _conv_to_state(conv_p, f"{prefix}block.{2 * j + 1}.conv.", out, False)
    if "shortcut" in p:
        _conv_to_state(p["shortcut"], f"{prefix}shortcut.conv.", out, False)


def state_from_jax(params: dict, qstate, cfg) -> tp.Dict[str, np.ndarray]:
    """The JAX package's `params`/`qstate` (numpy or array leaves) ->
    reference-layout state dict, walking the module indices the loaders
    above walk (`cfg` is an EncodecConfig)."""
    out: tp.Dict[str, np.ndarray] = {}
    enc, root, idx = params["encoder"], "encoder.model.", 0
    _conv_to_state(enc["init_conv"], f"{root}{idx}.conv.", out, False)
    idx += 1
    for stage in enc["stages"]:
        for res_p in stage["res"]:
            _resblock_to_state(res_p, f"{root}{idx}.", out)
            idx += 1
        idx += 1  # activation module
        _conv_to_state(stage["down"], f"{root}{idx}.conv.", out, False)
        idx += 1
    if cfg.seanet.lstm:
        _lstm_to_state(enc["lstm"], f"{root}{idx}.lstm.", out)
        idx += 1
    idx += 1  # activation
    _conv_to_state(enc["final_conv"], f"{root}{idx}.conv.", out, False)

    dec, root, idx = params["decoder"], "decoder.model.", 0
    _conv_to_state(dec["init_conv"], f"{root}{idx}.conv.", out, False)
    idx += 1
    if cfg.seanet.lstm:
        _lstm_to_state(dec["lstm"], f"{root}{idx}.lstm.", out)
        idx += 1
    for stage in dec["stages"]:
        idx += 1  # activation
        _conv_to_state(stage["up"], f"{root}{idx}.convtr.", out, True)
        idx += 1
        for res_p in stage["res"]:
            _resblock_to_state(res_p, f"{root}{idx}.", out)
            idx += 1
    idx += 1  # activation
    _conv_to_state(dec["final_conv"], f"{root}{idx}.conv.", out, False)

    # a shared codebook repeats its one book in every stage's slot
    embed, embed_avg, cluster = (np.asarray(qstate[i]) for i in range(3))
    inited = float(bool(np.asarray(qstate[3])))
    for k in range(cfg.rvq.n_q):
        kk = min(k, embed.shape[0] - 1)
        root = f"quantizer.vq.layers.{k}._codebook."
        out[root + "embed"] = embed[kk]
        out[root + "embed_avg"] = embed_avg[kk]
        out[root + "cluster_size"] = cluster[kk]
        out[root + "inited"] = np.asarray([inited], np.float32)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def params_from_jax(params: dict, qstate, cfg) -> tp.Tuple[dict, RVQState]:
    """The JAX package's parameter tree and quantizer state (`RVQState`
    fields in order: embed, embed_avg, cluster_size, inited), e.g. from a
    JAX-trained checkpoint (`train.checkpoint.load_checkpoint`), -> the
    port's `(params, qstate)` on the CPU, for `model.params` and
    `model.qstate`."""
    return model_params_from_state(state_from_jax(params, qstate, cfg), cfg)


def _find_adam(node) -> tp.Optional[tuple]:
    """The first (count, mu, nu) namedtuple node of an optimizer state tree
    (optax's `ScaleByAdamState` inside `inject_hyperparams`' chain)."""
    if isinstance(node, tuple) and getattr(node, "_fields", None) == (
            "count", "mu", "nu"):
        return node
    children = (node.values() if isinstance(node, dict) else
                node if isinstance(node, (list, tuple)) else ())
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(raw, cfg):
    """A JAX `TrainState` (fields in order: params, qstate, opt_state,
    disc_params, disc_opt_state, balancer_state, rng), as the port's
    `train.load_checkpoint` reads it from a JAX-written `.ckpt` or as numpy
    arrays, → the port's `train.TrainState` on the CPU (`cfg` is an
    EncodecConfig).

    The Adam `count`, `mu` and `nu` come from the optimizer tree's
    (count, mu, nu) node and go through `params_from_jax`'s layout mapping
    like the parameters. JAX's PRNG key cannot become a torch generator
    state: the generator is seeded from the key's bits, so a resumed run is
    deterministic but draws other indices than JAX would. A GAN run's
    discriminator state is refused (ROADMAP 11a)."""
    from ..train.optim import AdamState
    from ..train.steps import TrainState, refuse_gan

    params, qstate, opt_state, disc_params = raw[0], raw[1], raw[2], raw[3]
    if disc_params is not None:
        refuse_gan("a checkpoint with discriminator parameters")
    qstate = tuple(qstate)
    port_params, port_q = params_from_jax(params, qstate, cfg)
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("the checkpoint's optimizer state has no Adam "
                         "(count, mu, nu) node")
    mu, _ = params_from_jax(adam[1], qstate, cfg)
    nu, _ = params_from_jax(adam[2], qstate, cfg)
    count = torch.tensor(int(np.asarray(adam[0])), dtype=torch.int32)
    key = np.asarray(raw[6]).astype(np.uint64).reshape(-1)
    seed = int(sum(int(k) << (32 * i) for i, k in enumerate(key[::-1])))
    rng = torch.Generator().manual_seed(seed % (1 << 63)).get_state()
    return TrainState(params=port_params, qstate=port_q,
                      opt_state=AdamState(count=count, mu=mu, nu=nu),
                      disc_params=None, disc_opt_state=None,
                      balancer_state=None, rng=rng)


def lm_params_from_state(state: State, n_q: int, num_layers: int = 5) -> dict:
    """The reference `LMModel` state dict (ref model.py:45-83) -> the LM
    parameter tree of `models.lm` (float32, on the CPU)."""
    def lin(prefix: str) -> dict:
        return {"w": _get(state, f"{prefix}weight").T.contiguous(),
                "b": _get(state, f"{prefix}bias")}

    def norm(prefix: str) -> dict:
        return {"scale": _get(state, f"{prefix}weight"),
                "bias": _get(state, f"{prefix}bias")}

    p: dict = {
        "emb": torch.stack([_get(state, f"emb.{k}.weight")
                            for k in range(n_q)]),
        "linears": {
            "w": torch.stack([_get(state, f"linears.{k}.weight").T
                              for k in range(n_q)]),
            "b": torch.stack([_get(state, f"linears.{k}.bias")
                              for k in range(n_q)]),
        },
        "norm_in": norm("transformer.norm_in."),
        "layers": [],
    }
    for i in range(num_layers):
        root = f"transformer.layers.{i}."
        in_w = _get(state, f"{root}self_attn.in_proj_weight")
        in_b = _get(state, f"{root}self_attn.in_proj_bias")
        d = in_w.shape[1]
        layer = {name: {"w": in_w[j * d:(j + 1) * d].T.contiguous(),
                        "b": in_b[j * d:(j + 1) * d].clone()}
                 for j, name in enumerate(("q", "k", "v"))}
        layer.update(out=lin(f"{root}self_attn.out_proj."),
                     ff1=lin(f"{root}linear1."), ff2=lin(f"{root}linear2."),
                     norm1=norm(f"{root}norm1."), norm2=norm(f"{root}norm2."))
        p["layers"].append(layer)
    return p


def lm_params_from_jax(params: dict) -> dict:
    """The JAX package's LM parameter tree (numpy or array leaves) -> the
    port's (the same layout, float32 tensors on the CPU)."""
    if isinstance(params, dict):
        return {k: lm_params_from_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [lm_params_from_jax(v) for v in params]
    return torch.from_numpy(np.array(params, dtype=np.float32))


def load_state(model, state: State) -> None:
    """Load a reference-layout state dict into `model` (in place)."""
    if "model_state_dict" in state:   # fork training checkpoints wrap it
        state = state["model_state_dict"]
    params, qstate = model_params_from_state(state, model.cfg)
    model.params = params
    model.qstate = qstate


def load_pretrained(model, checkpoint_name: str,
                    repository: tp.Optional[str] = None) -> None:
    """Load `{repository}/{checkpoint_name}` into `model` (in place),
    verifying the sha256 prefix embedded in the file name when it has one
    (`name-<sha prefix>.th`)."""
    if repository is None:
        raise RuntimeError(
            f"no local checkpoint repository given for {checkpoint_name}: "
            "pass repository=DIR (CLI: --repository DIR); the port does "
            "not download checkpoints")
    file = Path(repository) / checkpoint_name
    parts = file.stem.split("-")
    if len(parts) > 1:
        checksum = parts[1]
        sha = hashlib.sha256()
        with open(file, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                sha.update(chunk)
        if sha.hexdigest()[:len(checksum)] != checksum:
            raise RuntimeError(f"Invalid checksum for {file}")
    load_state(model, torch.load(file, map_location="cpu", weights_only=True))
