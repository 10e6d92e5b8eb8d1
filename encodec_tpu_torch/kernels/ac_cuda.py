"""The range decoder of lmv=3 with the LM's CDF head fused in: CUDA kernel
wrapper and plain twin.

`ac_head_pull` runs one lockstep decode step of S lanes on the card from
the integer LM head's product: a cluster of CTAs per lane finishes the
lane's K CDF rows in shared memory, gathered in the first CTA, where one
warp then pulls the lane's K symbols, and the symbols,
the next step's feed and the sticky `ok`/`eof` flags are written on the
device. The step index is read from a device tensor, so one captured
launch serves every step of `IntLMModel.decode_lockstep`'s CUDA graph. It
replaces JAX's head tail (`encodec_tpu/models/ilm.py::_head_cdf` after its
einsum) and the XLA scan of `encodec_tpu/stream/device_ac.py::ac_pull_row`
inside JAX's fused decode scan; neither is a Pallas kernel. The kernel is
`csrc/ac_decode.cu` (see the source for its design). Its plain twin is
`stream.device_ac.ac_head_pull_lanes`, the same integer arithmetic.

For CPU tensors the wrapper runs the twin; for CUDA tensors it launches the
kernel or raises — no fallback. `ac_head_pull.launches` counts launches:
the wrapper counts each launch it makes outside a CUDA graph capture, and
the decode counts each replay of its captured step.
"""

from __future__ import annotations

import torch

from ..stream import device_ac
from . import build
from .validate import SMEM_PER_BLOCK, check_tensor, require_same_device

AC_THREADS = 256           # csrc/ac_decode.cu kThreads: 8 warps
AC_CLUSTER = 4             # kCluster: CTAs per lane
AC_MAX_CARD = 1024         # kMaxCard: 32 row entries per lane
AC_LUT = 1024              # the exp2 table's entries

ac_head_pull_plain = device_ac.ac_head_pull_lanes


def window_bytes(K: int) -> int:
    """The stream bytes a step can reach, with room for two aligned 4-byte
    reads from the last (a pull injects at most 24 bits, so K pulls read
    < 24K bits from `pos`)."""
    return 3 * K + 16


def ac_plan(K: int, card: int) -> dict:
    """The kernel's launch: a cluster of `cluster` CTAs of `threads` per
    lane, each with `smem` bytes of dynamic shared memory (K int32 rows of
    1024 entries whatever the card, each padded by a word per 32 entries,
    the exp2 table and the stream window). Raises where the rows do not
    fit a block's 227 KB or a lane of a warp would hold more than 32
    entries of a row."""
    if not 1 <= card <= AC_MAX_CARD:
        raise ValueError(f"card={card}: the kernel builds a row with one "
                         f"warp, at most {AC_MAX_CARD} entries")
    row_words = 33 * AC_MAX_CARD // 32
    smem = 4 * K * row_words + 4 * AC_LUT + ((window_bytes(K) + 3) & ~3)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"K={K}, card={card}: the rows and the window need "
                         f"{smem} B of shared memory, more than the "
                         f"{SMEM_PER_BLOCK} B (227 KB) a block can use")
    return {"cluster": AC_CLUSTER, "threads": AC_THREADS, "smem": smem}


def _check(state, acc, head_b, lut, data, nbits, ts, t, codes, feed, ok,
           eof) -> None:
    check_tensor("state", state, ndim=2, dtype=torch.int64)
    check_tensor("acc", acc, ndim=3, dtype=torch.float64)
    check_tensor("head_b", head_b, ndim=2, dtype=torch.int32)
    check_tensor("data", data, ndim=2, dtype=torch.uint8)
    for name, x in (("lut", lut), ("nbits", nbits), ("ts", ts), ("t", t)):
        check_tensor(name, x, ndim=1, dtype=torch.int64)
    check_tensor("codes", codes, ndim=3, dtype=torch.int64)
    check_tensor("feed", feed, ndim=2, dtype=torch.int64)
    for name, x in (("ok", ok), ("eof", eof)):
        check_tensor(name, x, ndim=1, dtype=torch.bool)
    require_same_device(state, acc, head_b, lut, data, nbits, ts, t, codes,
                        feed, ok, eof)
    K, S, card = acc.shape
    want = {"state": (S, device_ac.STATE_FIELDS), "head_b": (K, card),
            "lut": (AC_LUT,), "nbits": (S,), "ts": (S,), "t": (1,),
            "feed": (S, K), "ok": (S,), "eof": (S,)}
    got = {"state": state, "head_b": head_b, "lut": lut, "nbits": nbits,
           "ts": ts, "t": t, "feed": feed, "ok": ok, "eof": eof}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape} for acc "
                             f"{tuple(acc.shape)}, got "
                             f"{tuple(got[name].shape)}")
    if S < 1 or K < 1 or card < 1:
        raise ValueError(f"empty acc {tuple(acc.shape)}")
    if data.shape[0] != S or data.shape[1] < 1:
        raise ValueError(f"data: expected [{S}, L >= 1], got "
                         f"{tuple(data.shape)}")
    if codes.shape[0] < 1 or tuple(codes.shape[1:]) != (S, K):
        raise ValueError(f"codes: expected [T >= 1, {S}, {K}], got "
                         f"{tuple(codes.shape)}")


def ac_head_pull(state: torch.Tensor, acc: torch.Tensor,
                 head_b: torch.Tensor, e0: int, lut: torch.Tensor,
                 data: torch.Tensor, nbits: torch.Tensor, ts: torch.Tensor,
                 t: torch.Tensor, codes: torch.Tensor, feed: torch.Tensor,
                 ok: torch.Tensor, eof: torch.Tensor) -> None:
    """One lockstep decode step of S lanes from the LM head's product, in
    place.

    state `[S, 5]` int64 (`stream.device_ac.init_state`); acc `[K, S, card]`
    float64 (`models.ilm._head_acc` of the trunk's output: integers); head_b
    `[K, card]` int32 (its values are below 2^30) and e0 the head's bias
    and exponent; lut `[1024]` int64 the exp2 table; data `[S, L]` uint8
    (each lane's stream, zero-padded); nbits, ts `[S]` int64 (stream bits,
    lane length in
    steps); t `[1]` int64, the step, read on the device (the caller
    advances it); codes `[T, S, K]` int64 (step t's symbols go to
    `codes[t]`); feed `[S, K]` int64 (the next step's input: 1 + symbols
    where t + 1 < ts, else 0); ok, eof `[S]` bool, sticky. A lane with
    t >= ts writes zeros and keeps its state and flags. All contiguous, on
    one device; the wrapper reads no tensor, so the launch can be captured
    in a CUDA graph."""
    _check(state, acc, head_b, lut, data, nbits, ts, t, codes, feed, ok, eof)
    if acc.device.type == "cpu":
        ac_head_pull_plain(state, acc, head_b, e0, lut, data, nbits, ts, t,
                           codes, feed, ok, eof)
        return
    K, S, card = acc.shape
    plan = ac_plan(K, card)
    lib = build.load_library("ac_decode")
    with torch.cuda.device(acc.device):
        rc = lib.ac_head_pull_launch(
            state.data_ptr(), acc.data_ptr(), head_b.data_ptr(), e0,
            lut.data_ptr(), data.data_ptr(), nbits.data_ptr(), ts.data_ptr(),
            t.data_ptr(), S, K, card, data.shape[1], codes.shape[0],
            codes.data_ptr(), feed.data_ptr(), ok.data_ptr(), eof.data_ptr(),
            plan["threads"], plan["smem"],
            torch.cuda.current_stream(acc.device).cuda_stream)
        build.check(lib, "ac_decode", rc)
        if not torch.cuda.is_current_stream_capturing():
            ac_head_pull.launches += 1


ac_head_pull.launches = 0  # type: ignore[attr-defined]
