"""The frozen operation and byte counts against hand counts at small
shapes, and the shapes they assume against the plain reference's."""

import math

import pytest
import torch

from portbench.counts import kernels, names, seanet, steps
from portbench.reference import seanet as ref_seanet
from portbench.reference.arch import SEANET_DEFAULTS

ARCH = dict(SEANET_DEFAULTS, channels=1, dimension=4, n_filters=2,
            ratios=[2, 3], causal=True, norm="none", decoder_final_norm="none",
            bins=8, n_q=2, shared_codebook=False, sample_rate=60,
            lstm_layers=1, hop=6, frame_rate=10)


def test_conv_flops_by_hand():
    c = seanet.Conv("c", cin=3, cout=5, kernel=7, stride=2, dilation=1,
                    t_in=20, t_out=10, transposed=False)
    assert c.flops(batch=4) == 2 * 3 * 5 * 7 * 10 * 4
    t = c._replace(transposed=True)
    assert t.flops(batch=4) == 2 * 3 * 5 * 7 * 20 * 4


def test_lstm_flops_by_hand():
    lstm = seanet.Lstm("l", units=8, layers=2, t=5)
    # per layer and step: gates 4H from input (H) and state (H)
    assert lstm.flops(batch=3) == 2 * (2 * 4 * 8 * (8 + 8) * 5 * 3)
    assert lstm.recurrent_flops(batch=3) == 8 * 3 * 5 * 64


def test_k3_bounds_by_hand():
    f = kernels.k3_forward(batch=2, t=3, h=4, save_c=True)
    assert f["flops"] == 8 * 2 * 3 * 16
    assert f["bytes"] == 4 * (2 * 3 * 16 + 64 + 2 * 3 * 4 + 2 * 3 * 4)
    b = kernels.k3_backward(batch=2, t=3, h=4)
    assert b["flops"] == f["flops"]
    assert b["bytes"] == 4 * (2 * 2 * 3 * 16 + 2 * 2 * 3 * 4 + 64)
    assert kernels.bound_s(f) == max(f["flops"] / 67e12, f["bytes"] / 3.35e12)


@pytest.mark.parametrize("length", [60, 61, 97])
def test_plans_match_the_reference_shapes(length):
    enc, lstm, frames = seanet.encoder_plan(ARCH, length)
    dec, dlstm = seanet.decoder_plan(ARCH, frames)
    assert lstm.units == dlstm.units == 2 * 2 ** 2
    p = _params(enc, dec, lstm)
    x = torch.randn(1, 1, length)
    z = ref_seanet.encoder(p["encoder"], x, ARCH)
    assert z.shape[1] == frames and z.shape[2] == ARCH["dimension"]
    y = ref_seanet.decoder(p["decoder"], z, ARCH)
    assert y.shape[-1] == dec[-1].t_out == frames * ARCH["hop"]
    assert frames == math.ceil(length / ARCH["hop"])


def _conv(c):
    shape = ((c.cin, c.cout, c.kernel) if c.transposed
             else (c.cout, c.cin, c.kernel))
    return {"w": torch.randn(shape) * 0.1, "b": torch.zeros(c.cout)}


def _params(enc, dec, lstm):
    def layers(h):
        return {"layers": [{"w_ih": torch.randn(4 * h, h) * 0.1,
                            "w_hh": torch.randn(4 * h, h) * 0.1,
                            "b_ih": torch.zeros(4 * h),
                            "b_hh": torch.zeros(4 * h)}]}

    def stages(convs, down):
        out, cur = [], {}
        for c in convs:
            key = c.name.split(".")[-1]
            if key == "conv0":
                cur.setdefault("res", [{}])[0]["convs"] = [_conv(c)]
            elif key == "conv1":
                cur["res"][0]["convs"].append(_conv(c))
            elif key == "shortcut":
                cur["res"][0]["shortcut"] = _conv(c)
            elif key in ("down", "up"):
                cur[key] = _conv(c)
            if (down and key == "down") or (not down and key == "shortcut"):
                out.append(cur)
                cur = {}
        return out

    h = lstm.units
    return {
        "encoder": {"init_conv": _conv(enc[0]), "lstm": layers(h),
                    "stages": stages(enc[1:-1], True),
                    "final_conv": _conv(enc[-1])},
        "decoder": {"init_conv": _conv(dec[0]), "lstm": layers(h),
                    "stages": stages(dec[1:-1], False),
                    "final_conv": _conv(dec[-1])}}


def test_train_step_flops_by_hand():
    parts = seanet.train_step_flops(ARCH, batch=2, length=60)
    enc, lstm, frames = seanet.encoder_plan(ARCH, 60)
    dec, dlstm = seanet.decoder_plan(ARCH, frames)
    fwd = sum(c.flops(2) for c in enc + dec)
    assert parts["conv"] == 3 * fwd - enc[0].flops(2)
    assert parts["lstm"] == 3 * (lstm.flops(2) + dlstm.flops(2))
    n = 2 * frames
    assert parts["rvq"] == 2 * (2 * n * 8 * 4 + n * 4)


def test_spectral_loss_flops_by_hand():
    # 30 s windows of 512 points every 50 samples, padded by 231 each side
    frames = (1000 + 2 * 231 - 512) // 50 + 1
    assert seanet.spectral_loss_flops(1000, 2, 512, 50) == \
        3 * 2.5 * 512 * 9 * frames * 2


def test_codec_n_q_and_batch_flops():
    arch = dict(ARCH, bins=1024, frame_rate=75)
    assert steps.n_q(arch, {"bandwidth_kbps": 6.0}) == 8
    assert steps.n_q(arch, {"bandwidth_kbps": 1.5}) == 2
    traffic = {"batch": 2, "length": 60, "bandwidth_kbps": 1.5}
    f = steps.call_flops(dict(ARCH, frame_rate=75, bins=1024), {}, traffic,
                         "batch")
    parts = seanet.codec_flops(dict(ARCH, bins=1024), 2, 60, 2)
    assert f == sum(parts.values())


def test_k3_work_per_call():
    traffic = {"batch": 2, "length": 60}
    assert len(steps.k3_work(ARCH, traffic, "gen")) == 2 * 2
    assert len(steps.k3_work(ARCH, traffic, "batch")) == 2


@pytest.mark.parametrize("kernel,group", [
    ("void lstm_grid_kernel<true>(float const*)", "k3_forward"),
    ("lstm_scan_kernel_pair", "k3_forward"),
    ("lstm_bwd_kernel", "k3_backward"),
    ("lstm_bwd_cluster_kernel<2>", "k3_backward"),
    ("vq_nearest_rowblock_kernel", "k1"),
    ("vq_nearest_kernel", "k1"),
    ("vq_rvq_kernel", "k2"),
    ("sm90_xmma_fprop_implicit_gemm", None),
])
def test_own_kernel_names(kernel, group):
    assert names.own_group(kernel) == group


@pytest.mark.parametrize("op,shapes,group", [
    ("aten::cudnn_convolution", [[16, 32, 1, 1000], [64, 32, 1, 7]],
     "conv1d_forward"),
    ("aten::convolution_backward", [[16, 32, 7149, 257], [16, 2, 7149, 513]],
     "conv2d_backward"),
    ("aten::cudnn_convolution", [[16, 2, 512, 513], [32, 2, 3, 9]],
     "conv2d_forward"),
    ("aten::convolution_backward", [[16, 32, 1000], [16, 16, 1000]],
     "conv1d_backward"),
    ("aten::addmm", [[7680, 4096]], "gemm"),
    ("aten::_fft_r2c", [[16, 512]], "fft"),
    ("aten::add_", [[16]], None),
])
def test_op_groups(op, shapes, group):
    assert names.op_group(op, shapes) == group
