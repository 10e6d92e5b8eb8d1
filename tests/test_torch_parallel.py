"""The codebook-sharded RVQ search, the sequence-parallel codec and the
pipelined LM on `torch.distributed`, on the CPU: the port at world 4
against JAX's single-device functions and JAX's mesh functions on the
conftest's 8-device CPU mesh, on the same seeded inputs.

One gloo world of 4 ranks (`torch.multiprocessing.spawn`, the rank task
`test_torch_parallel_ranks.task_paths`, a file store under the module's
temporary directory) runs every path; the test process runs JAX's.

Tolerances, JAX's own tests' (`tests/test_tp.py`, `test_sp.py`,
`test_pp.py`): tp codes equal, a duplicated row across shards resolved to
the lowest global index; sp latents rtol 1e-5, atol 1e-6 of the port's
unsharded encoder (the 24 kHz-style weight-norm encoder too) and within
the port's JAX-parity bound of JAX's (rtol 1e-4, atol 1e-5), decoded
audio rtol 5e-4, atol 1e-4 of both, codes equal
outside the searches' tie flags (top-2 margin < 1e-3); pp probabilities
rtol 2e-5, atol 2e-6 (logits with an offset atol 2e-5), three Adam steps'
losses rtol 1e-5 of the single-process step's, and the first step's
gradient (what JAX's test holds through SGD) rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from encodec_tpu.models import lm as jlm
from encodec_tpu.models.model import build_model as jax_build_model
from encodec_tpu.models.seanet import seanet_decoder as jax_seanet_decoder
from encodec_tpu.models.seanet import seanet_encoder as jax_seanet_encoder
from encodec_tpu.parallel import make_mesh as jax_make_mesh
from encodec_tpu.parallel.pp import lm_forward_batch_pp as jax_forward_pp
from encodec_tpu.parallel.pp import stack_lm_layers as jax_stack
from encodec_tpu.parallel.sp import seanet_decode_sp as jax_decode_sp
from encodec_tpu.parallel.sp import seanet_encode_sp as jax_encode_sp
from encodec_tpu.parallel.tp import nearest_codebook_tp as jax_nearest_tp
from encodec_tpu.parallel.tp import rvq_encode_tp as jax_rvq_encode_tp
from encodec_tpu.quant import RVQConfig as JaxRVQConfig
from encodec_tpu.quant import init_rvq as jax_init_rvq
from encodec_tpu.quant import rvq_encode as jax_rvq_encode
from encodec_tpu.quant.rvq import _nearest as jax_nearest
from encodec_tpu.train.lm_train import shift_codes as jax_shift_codes
from encodec_tpu_torch import parallel
from encodec_tpu_torch.models import build_model, lm, params_from_jax
from encodec_tpu_torch.models.seanet import (SEANetConfig, init_seanet_encoder,
                                             seanet_decoder, seanet_encoder)
from encodec_tpu_torch.models.zoo import lm_params_from_jax
from encodec_tpu_torch.quant import RVQState, rvq_encode_margins
from encodec_tpu_torch.train.lm_train import (create_lm_train_state, lm_loss,
                                              make_lm_train_step, shift_codes)
from encodec_tpu_torch.train.optim import tree_leaves, tree_map
from encodec_tpu_torch.train.steps import _grads, _with_grad
from tests import test_torch_parallel_ranks as ranks

WORLD = 4
TIE = 1e-3
SP_TINY = dict(sample_rate=10, channels=1, causal=True,
               model_norm="layer_norm", name="breathing_model",
               ratios=[5, 2, 1], bins=32, dimension=16, n_filters=4,
               decoder_final_norm="none", shared_codebook=True,
               kmeans_init=False)
SP_24K = dict(sample_rate=24000, channels=1, causal=True,
              model_norm="weight_norm", name="encodec_24khz",
              ratios=[4, 3, 2, 1], bins=64, dimension=16, n_filters=4,
              kmeans_init=False)
LM_CFG = dict(n_q=4, card=17, dim=32, num_heads=4, num_layers=4,
              past_context=9)
RVQ_CFG = dict(dimension=16, n_q=4, bins=64, kmeans_init=False)
RVQ_CFG2 = dict(dimension=16, n_q=3, bins=64, kmeans_init=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _randn(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _sp_pair(kw, seed):
    bw = [0.08 if kw["sample_rate"] == 10 else 12.0]   # 16 and 2 stages
    jm = jax_build_model(bw, seed=seed, **kw)
    tm = build_model(bw, seed=seed, device="cpu", **kw)
    tm.params, tm.qstate = params_from_jax(_np(jm.params),
                                           tuple(_np(jm.qstate)), tm.cfg)
    return jm, tm


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    out = tmp_path_factory.mktemp("paths")
    inp, jx = {}, {}
    # tp: gaussian rows, a book of all-equal rows, a row duplicated in two
    # shards (rows 20 and 50 of 64: shards 1 and 3 of 4)
    x, e = _randn(0, (100, 32)), _randn(1, (64, 32))
    dup = e.copy()
    dup[20] = dup[50]
    xd = dup[50][None] + _randn(2, (16, 32), 1e-3)
    for name, (a, b) in {"x": (x, e), "tie": (np.ones((16, 32), np.float32),
                                              np.ones((64, 32), np.float32)),
                         "dup": (xd, dup)}.items():
        inp[f"tp_{name}"] = (_t(a), _t(b))
        jx[f"tp_{name}"] = np.asarray(jax_nearest(jnp.asarray(a),
                                                  jnp.asarray(b)))
    jx["tp_x_mesh"] = np.asarray(jax_nearest_tp(
        jnp.asarray(x), jnp.asarray(e), jax_make_mesh(8, axis_name="model")))
    jcfg = JaxRVQConfig(**RVQ_CFG)
    jstate = jax_init_rvq(jax.random.PRNGKey(0), jcfg)
    inp["rvq_state"] = RVQState(*(_t(a) for a in _np(tuple(jstate)[:3])),
                                inited=True)
    inp["rvq_cfg"], inp["rvq_cfg2"] = RVQ_CFG, RVQ_CFG2
    inp["rvq_x"], inp["rvq_x2"] = (_t(_randn(3, (2, 9, 16))),
                                   _t(_randn(4, (4, 8, 16))))
    jx["tp_rvq"] = np.asarray(jax_rvq_encode(jstate, jnp.asarray(
        inp["rvq_x"].numpy()), jcfg))
    jx["tp_rvq_mesh"] = np.asarray(jax_rvq_encode_tp(
        jstate, jnp.asarray(inp["rvq_x"].numpy()), jcfg,
        jax_make_mesh(8, axis_name="model")))
    jx["tp_rvq_2d"] = np.asarray(jax_rvq_encode(
        jstate, jnp.asarray(inp["rvq_x2"].numpy()), JaxRVQConfig(**RVQ_CFG2)))

    # sp: the tiny breathing model and a 24 kHz-style weight-norm model
    inp["sp_models"], inp["sp_z"] = {}, {}
    for name, kw, seed, T, Tz in (("breathing", SP_TINY, 0, 10 * 8 * 8, 40),
                                  ("24k", SP_24K, 2, 24 * 8 * 5, 24)):
        jm, tm = _sp_pair(kw, seed)
        sc = jm.cfg.seanet
        xs = _randn(10 + seed, (2, T, 1))
        z = _randn(20 + seed, (2, Tz, sc.dimension))
        inp["sp_models"][name] = ((tm.params, tm.qstate, tm.cfg), _t(xs))
        inp["sp_z"][name] = _t(z)
        jx[f"sp_enc_{name}"] = np.asarray(jax_seanet_encoder(
            jm.params["encoder"], jnp.asarray(xs), sc))
        jx[f"sp_dec_{name}"] = np.asarray(jax_seanet_decoder(
            jm.params["decoder"], jnp.asarray(z), sc))
        with torch.no_grad():
            jx[f"sp_enc_port_{name}"] = seanet_encoder(
                tm.params["encoder"], _t(xs), tm.cfg.seanet).numpy()
            jx[f"sp_dec_port_{name}"] = seanet_decoder(
                tm.params["decoder"], _t(z), tm.cfg.seanet).numpy()
        mesh8 = jax_make_mesh(8, axis_name="seq")
        jx[f"sp_enc_mesh_{name}"] = np.asarray(jax_encode_sp(
            jm.params["encoder"], jnp.asarray(xs), sc, mesh8))
        jx[f"sp_dec_mesh_{name}"] = np.asarray(jax_decode_sp(
            jm.params["decoder"], jnp.asarray(z), sc, mesh8))
        _, margins = rvq_encode_margins(
            tm.qstate, _t(jx[f"sp_enc_{name}"]), tm.cfg.rvq)
        jx[f"sp_flags_{name}"] = margins < TIE
        jx[f"sp_codes_{name}"] = np.asarray(jax_rvq_encode(
            jm.qstate, jnp.asarray(jx[f"sp_enc_{name}"]), jm.cfg.rvq))
    short = SEANetConfig(channels=1, dimension=16, n_filters=4, causal=True,
                         ratios=(2, 5), n_residual_layers=3, dilation_base=4,
                         norm="layer_norm")
    inp["sp_short"] = (init_seanet_encoder(torch.Generator().manual_seed(0),
                                           short, torch.device("cpu")),
                       torch.zeros(1, short.hop_length * WORLD, 1), short)

    # pp
    jcfg_lm = jlm.LMConfig(**LM_CFG)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg_lm)
    codes = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                          (8, LM_CFG["n_q"], 13), 0,
                                          LM_CFG["card"]))
    inp["lm_cfg"], inp["lm_params"] = LM_CFG, lm_params_from_jax(_np(jp))
    inp["lm_codes"] = torch.from_numpy(codes.astype(np.int64))
    inp["lm_inputs"] = shift_codes(inp["lm_codes"])
    jin = jax_shift_codes(jnp.asarray(codes))
    jx["pp_fwd"] = np.asarray(jlm.lm_forward_batch(jp, jin, jcfg_lm))
    jx["pp_logits"] = np.asarray(jlm.lm_forward_batch(
        jp, jin, jcfg_lm, offset=5, return_logits=True))
    jstacked, jother = jax_stack(jp, 4)
    jx["pp_fwd_mesh"] = np.asarray(jax.jit(lambda s, o, i: jax_forward_pp(
        s, o, i, jcfg_lm, Mesh(np.asarray(jax.devices()[:4]), ("pipe",)),
        4))(jstacked, jother, jin))

    torch.save(inp, out / "paths.pt")
    mp.spawn(ranks.run, args=(WORLD, str(out / "store"), str(out), "paths"),
             nprocs=WORLD, join=True)
    got = [torch.load(out / f"paths_{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return dict(got=got, jax=jx, inp=inp)


def _same_on_every_rank(paths, key):
    first = paths["got"][0][key]
    for r in range(1, WORLD):
        assert torch.equal(paths["got"][r][key], first), (key, r)
    return first


@pytest.mark.parametrize("name", ["x", "tie", "dup"])
def test_tp_nearest_codes_equal_single_device(paths, name):
    """Codes over 4 shards equal JAX's single-device search: a book of
    equal rows gives index 0, and a row duplicated in shards 1 and 3 the
    lower one (20)."""
    got = _same_on_every_rank(paths, f"tp_{name}")
    want = paths["jax"][f"tp_{name}"]
    assert np.array_equal(got.numpy(), want)
    if name == "tie":
        assert not got.any()
    if name == "dup":
        assert (got == 20).all()
    if name == "x":
        assert np.array_equal(got.numpy(), paths["jax"]["tp_x_mesh"])


@pytest.mark.parametrize("name", ["tp_rvq", "tp_rvq_2d"])
def test_tp_rvq_encode_equals_single_device(paths, name):
    """`rvq_encode_tp` (4 model shards; 2 data x 2 model with the batch
    on `data`) equals JAX's `rvq_encode` and JAX's 8-shard
    `rvq_encode_tp`."""
    got = _same_on_every_rank(paths, name)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), paths["jax"][name])
    if name == "tp_rvq":
        assert np.array_equal(got.numpy(), paths["jax"]["tp_rvq_mesh"])


@pytest.mark.parametrize("name", ["breathing", "24k"])
def test_sp_encode_matches_single_device_and_jax_mesh(paths, name):
    """The port's 4 shards against its own unsharded encoder at JAX's sp
    bound, and against JAX's encoder and JAX's 8-shard one at the port's
    JAX-parity bound for the encoder (rtol 1e-4, atol 1e-5,
    `tests/test_torch_breathing.py`: XLA and oneDNN sum in other orders)."""
    got = _same_on_every_rank(paths, f"sp_enc_{name}").numpy()
    np.testing.assert_allclose(got, paths["jax"][f"sp_enc_port_{name}"],
                               rtol=1e-5, atol=1e-6)
    for key in (f"sp_enc_{name}", f"sp_enc_mesh_{name}"):
        np.testing.assert_allclose(got, paths["jax"][key], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["breathing", "24k"])
def test_sp_codes_equal_outside_tie_flags(paths, name):
    got = _same_on_every_rank(paths, f"sp_codes_{name}").numpy()   # B,K,T
    want = paths["jax"][f"sp_codes_{name}"].transpose(1, 0, 2)
    flags = paths["jax"][f"sp_flags_{name}"].numpy()               # K,B·T
    safe = ~flags.reshape(want.shape[1], want.shape[0], -1).transpose(1, 0, 2)
    assert safe.mean() > 0.5
    assert np.array_equal(got[safe], want[safe])


@pytest.mark.parametrize("name", ["breathing", "24k"])
def test_sp_decode_matches_single_device_and_jax_mesh(paths, name):
    got = _same_on_every_rank(paths, f"sp_dec_{name}").numpy()
    for key in (f"sp_dec_port_{name}", f"sp_dec_{name}",
                f"sp_dec_mesh_{name}"):
        np.testing.assert_allclose(got, paths["jax"][key], rtol=5e-4,
                                   atol=1e-4)
    audio = _same_on_every_rank(paths, f"sp_audio_{name}")
    T = paths["inp"]["sp_models"][name][1].shape[1]
    assert audio.shape == (2, T, 1) and bool(torch.isfinite(audio).all())


def test_sp_short_shard_raises_jax_error(paths):
    msg = paths["got"][0]["sp_short"]
    assert msg is not None and "shard too short" in msg
    assert "Use fewer shards or a longer signal" in msg


@pytest.mark.parametrize("m", [4, 8])
def test_pp_forward_matches_offline(paths, m):
    got = _same_on_every_rank(paths, f"pp_fwd_{m}").numpy()
    np.testing.assert_allclose(got, paths["jax"]["pp_fwd"], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(got, paths["jax"]["pp_fwd_mesh"], rtol=2e-5,
                               atol=2e-6)


def test_pp_forward_offset_and_logits(paths):
    got = _same_on_every_rank(paths, "pp_logits").numpy()
    np.testing.assert_allclose(got, paths["jax"]["pp_logits"], rtol=2e-5,
                               atol=2e-5)


def test_pp_non_divisible_errors(paths):
    msg = paths["got"][0]["pp_bad_batch"]
    assert msg is not None and "not divisible by n_microbatches" in msg
    with pytest.raises(ValueError, match="not divisible by n_stages=3"):
        parallel.stack_lm_layers(paths["inp"]["lm_params"], 3)


def test_pp_train_steps_match_the_single_process_step(paths):
    """Three pipelined Adam steps (lr 1e-2, clip 1) track the port's
    single-process step's loss, and the first step's gradient, stage by
    stage and replicated, equals the single process's; every rank
    reports the same loss."""
    inp = paths["inp"]
    cfg = lm.LMConfig(**LM_CFG)
    params = inp["lm_params"]
    opt, opt_state = create_lm_train_state(params, lr=1e-2)
    step = make_lm_train_step(cfg, opt)
    nll = []
    p = params
    for _ in range(3):
        p, opt_state, m = step(p, opt_state, inp["lm_codes"])
        nll.append(float(m["nll"]))
    got = _same_on_every_rank(paths, "pp_nll")
    np.testing.assert_allclose(got.numpy(), nll, rtol=1e-5)
    # the first step's gradient, against autograd on the offline loss
    leaves = _with_grad(params)
    with torch.enable_grad():
        loss, _ = lm_loss(leaves, inp["lm_codes"], cfg)
        grads = _grads(loss, leaves)
    stacked, other = parallel.stack_lm_layers(grads, WORLD)
    for r in range(WORLD):
        g_stage, g_other = paths["got"][r]["pp_grads"]
        for a, b in zip(tree_leaves(g_stage),
                        tree_leaves(tree_map(lambda v: v[r:r + 1],
                                             stacked))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
        for a, b in zip(tree_leaves(g_other), tree_leaves(other)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
