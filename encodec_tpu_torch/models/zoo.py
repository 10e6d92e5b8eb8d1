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
layout mapping; a GAN run's discriminator, its Adam moments and the
balancer's state too), so the port's trainer resumes a JAX run. The MS-STFT
discriminator: `msstftd_params_from_jax` (JAX's HWIO tree → the port's
OIHW) and `msstftd_params_from_torch` (the reference `.th` layout).
Spectral-norm convs travel as the reference's `weight_orig`, `weight_u`,
`weight_v` (torch's spectral_norm) and land as `w_orig`, `u_sn`, `v_sn`.

The writers: `state_from_params` / `save_reference_checkpoint` take the
port's own model to the reference `.th` (what `tools.export` writes), and
`torch_state_from_lm_params` an LM's tree to the reference `LMModel`
state dict.

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
from .msstftd import msstftd_params_from_torch  # noqa: F401  (re-exported)
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
    if f"{prefix}{kind}.weight_orig" in state:      # spectral norm
        p["w_orig"] = _get(state, f"{prefix}{kind}.weight_orig")
        p["u_sn"] = _get(state, f"{prefix}{kind}.weight_u")
        p["v_sn"] = _get(state, f"{prefix}{kind}.weight_v")
    elif norm == "weight_norm" or old[1] in state or new[1] in state:
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
# A parameter tree -> reference state dict (numpy), a copy of
# `encodec_tpu/models/torch_zoo.py:201-306`. From the JAX package's tree
# (`from_jax`): convs `[K, Cin, Cout]` -> `[Cout, Cin, K]`, transposed
# convs `[K, Cout, Cin]` -> `[Cin, Cout, K]`; the port's tree is in torch
# layout already. Weight-norm gains -> `[C, 1, 1]`, LSTM weights as they
# are.
# ---------------------------------------------------------------------------

def _conv_to_state(p: dict, prefix: str, out: dict, transposed: bool,
                   from_jax: bool) -> None:
    kind, axes = ("convtr", (1, 2, 0)) if transposed else ("conv", (2, 1, 0))
    if not from_jax:
        axes = (0, 1, 2)
    if "w_orig" in p:
        # u and v index the `[Cout, rest]` view in both layouts
        out[f"{prefix}{kind}.weight_orig"] = np.asarray(
            p["w_orig"]).transpose(axes)
        out[f"{prefix}{kind}.weight_u"] = np.asarray(p["u_sn"])
        out[f"{prefix}{kind}.weight_v"] = np.asarray(p["v_sn"])
    elif "v" in p:
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


def _resblock_to_state(p: dict, prefix: str, out: dict,
                       from_jax: bool) -> None:
    for j, conv_p in enumerate(p["convs"]):
        _conv_to_state(conv_p, f"{prefix}block.{2 * j + 1}.conv.", out, False,
                       from_jax)
    if "shortcut" in p:
        _conv_to_state(p["shortcut"], f"{prefix}shortcut.conv.", out, False,
                       from_jax)


def _numpy_tree(tree):
    """Tensor leaves (on any device) → numpy arrays; other leaves as they
    are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree


def _state_dict(params: dict, qstate, cfg,
                from_jax: bool) -> tp.Dict[str, np.ndarray]:
    """`params`/`qstate` -> the reference-layout state dict, walking the
    module indices the loaders above walk (`cfg` is an EncodecConfig)."""
    params, qstate = _numpy_tree(params), _numpy_tree(tuple(qstate))
    out: tp.Dict[str, np.ndarray] = {}

    def conv(p: dict, prefix: str, transposed: bool = False) -> None:
        _conv_to_state(p, prefix, out, transposed, from_jax)

    enc, root, idx = params["encoder"], "encoder.model.", 0
    conv(enc["init_conv"], f"{root}{idx}.conv.")
    idx += 1
    for stage in enc["stages"]:
        for res_p in stage["res"]:
            _resblock_to_state(res_p, f"{root}{idx}.", out, from_jax)
            idx += 1
        idx += 1  # activation module
        conv(stage["down"], f"{root}{idx}.conv.")
        idx += 1
    if cfg.seanet.lstm:
        _lstm_to_state(enc["lstm"], f"{root}{idx}.lstm.", out)
        idx += 1
    idx += 1  # activation
    conv(enc["final_conv"], f"{root}{idx}.conv.")

    dec, root, idx = params["decoder"], "decoder.model.", 0
    conv(dec["init_conv"], f"{root}{idx}.conv.")
    idx += 1
    if cfg.seanet.lstm:
        _lstm_to_state(dec["lstm"], f"{root}{idx}.lstm.", out)
        idx += 1
    for stage in dec["stages"]:
        idx += 1  # activation
        conv(stage["up"], f"{root}{idx}.convtr.", transposed=True)
        idx += 1
        for res_p in stage["res"]:
            _resblock_to_state(res_p, f"{root}{idx}.", out, from_jax)
            idx += 1
    idx += 1  # activation
    conv(dec["final_conv"], f"{root}{idx}.conv.")

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


def state_from_jax(params: dict, qstate, cfg) -> tp.Dict[str, np.ndarray]:
    """The JAX package's `params`/`qstate` (numpy or array leaves) ->
    reference-layout state dict (`cfg` is an EncodecConfig)."""
    return _state_dict(params, qstate, cfg, from_jax=True)


def state_from_params(params: dict, qstate, cfg) -> tp.Dict[str, np.ndarray]:
    """The port's `params`/`qstate` (tensors on any device) ->
    reference-layout state dict (numpy float32): the keys and layout that
    `model_params_from_state` and the JAX package's `torch_zoo.
    load_pretrained` read back (`torch_state_from_params`' counterpart)."""
    return _state_dict(params, qstate, cfg, from_jax=False)


def save_reference_checkpoint(model, directory: tp.Union[str, Path],
                              name: tp.Optional[str] = None) -> str:
    """Save `model` as a zoo-style `.th`, the sha256 prefix of the file in
    its name (`{name or model.name}-{sha256[:8]}.th`, ref model.py:331-342),
    and return its path. It loads back bit for bit through
    `load_pretrained`, and into the reference's own modules."""
    state = {k: torch.from_numpy(v) for k, v in state_from_params(
        model.params, model.qstate, model.cfg).items()}
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / "export_tmp.th"
    torch.save(state, tmp)
    sha = hashlib.sha256(tmp.read_bytes()).hexdigest()[:8]
    final = directory / f"{name or model.name}-{sha}.th"
    tmp.replace(final)
    return str(final)


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


def msstftd_params_from_jax(tree) -> dict:
    """The JAX package's MS-STFT discriminator tree (numpy or array leaves;
    also an Adam moment tree shaped like it) → the port's: HWIO weights
    (`w`, `v`, `w_orig`) to OIHW, the rest (`b`, `g`, `u_sn`, `v_sn`) as
    they are, float32 tensors on the CPU."""
    def conv(p: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, np.float32).transpose(3, 2, 0, 1)
            if k in ("w", "v", "w_orig") else np.asarray(v, np.float32)))
            for k, v in p.items()}

    return {"discs": [{"convs": [conv(p) for p in sub["convs"]]}
                      for sub in tree["discs"]]}


def _adam_from_jax(opt_state, convert) -> "AdamState":
    from ..train.optim import AdamState

    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("the checkpoint's optimizer state has no Adam "
                         "(count, mu, nu) node")
    return AdamState(count=torch.tensor(int(np.asarray(adam[0])),
                                        dtype=torch.int32),
                     mu=convert(adam[1]), nu=convert(adam[2]))


def train_state_from_jax(raw, cfg):
    """A JAX `TrainState` (fields in order: params, qstate, opt_state,
    disc_params, disc_opt_state, balancer_state, rng), as the port's
    `train.load_checkpoint` reads it from a JAX-written `.ckpt` or as numpy
    arrays, → the port's `train.TrainState` on the CPU (`cfg` is an
    EncodecConfig).

    The Adam `count`, `mu` and `nu` come from the optimizer tree's
    (count, mu, nu) node and go through `params_from_jax`'s layout mapping
    like the parameters; a GAN run's discriminator parameters and moments
    through `msstftd_params_from_jax`, the balancer's EMA state as it is.
    JAX's PRNG key cannot become a torch generator state: the generator is
    seeded from the key's bits, so a resumed run is deterministic but draws
    other indices than JAX would."""
    from ..train.steps import TrainState

    params, qstate, opt_state = raw[0], tuple(raw[1]), raw[2]
    disc_params, disc_opt_state, balancer_state = raw[3], raw[4], raw[5]
    port_params, port_q = params_from_jax(params, qstate, cfg)
    opt = _adam_from_jax(
        opt_state, lambda tree: params_from_jax(tree, qstate, cfg)[0])
    disc = disc_opt = bal = None
    if disc_params is not None:
        disc = msstftd_params_from_jax(disc_params)
        disc_opt = _adam_from_jax(disc_opt_state, msstftd_params_from_jax)
    if balancer_state is not None:
        bal = {part: {k: torch.tensor(float(np.asarray(v)),
                                      dtype=torch.float32)
                      for k, v in balancer_state[part].items()}
               for part in ("total", "fix")}
    key = np.asarray(raw[6]).astype(np.uint64).reshape(-1)
    seed = int(sum(int(k) << (32 * i) for i, k in enumerate(key[::-1])))
    rng = torch.Generator().manual_seed(seed % (1 << 63)).get_state()
    return TrainState(params=port_params, qstate=port_q, opt_state=opt,
                      disc_params=disc, disc_opt_state=disc_opt,
                      balancer_state=bal, rng=rng)


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


def torch_state_from_lm_params(params: dict) -> tp.Dict[str, np.ndarray]:
    """The LM parameter tree of `models.lm` (tensors on any device) -> the
    reference `LMModel` state dict (numpy float32), the inverse of
    `lm_params_from_state` (a copy of `torch_zoo.py:159-199`)."""
    p = _numpy_tree(params)
    out: tp.Dict[str, np.ndarray] = {}
    for k in range(p["emb"].shape[0]):
        out[f"emb.{k}.weight"] = p["emb"][k]
        out[f"linears.{k}.weight"] = p["linears"]["w"][k].T
        out[f"linears.{k}.bias"] = p["linears"]["b"][k]
    out["transformer.norm_in.weight"] = p["norm_in"]["scale"]
    out["transformer.norm_in.bias"] = p["norm_in"]["bias"]
    for i, layer in enumerate(p["layers"]):
        root = f"transformer.layers.{i}."
        out[root + "self_attn.in_proj_weight"] = np.concatenate(
            [layer[h]["w"].T for h in ("q", "k", "v")], axis=0)
        out[root + "self_attn.in_proj_bias"] = np.concatenate(
            [layer[h]["b"] for h in ("q", "k", "v")], axis=0)
        for name, key in (("self_attn.out_proj", "out"), ("linear1", "ff1"),
                          ("linear2", "ff2")):
            out[f"{root}{name}.weight"] = layer[key]["w"].T
            out[f"{root}{name}.bias"] = layer[key]["b"]
        for name in ("norm1", "norm2"):
            out[f"{root}{name}.weight"] = layer[name]["scale"]
            out[f"{root}{name}.bias"] = layer[name]["bias"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


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
