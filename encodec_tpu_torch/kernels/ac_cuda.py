"""The range decoder of lmv=3: CUDA kernel wrapper and plain twin.

`ac_pull_rows` runs one lockstep decode step of S lanes on the card: each
active lane pulls its K symbols from its CDF rows, and the symbols, the
next step's feed and the sticky `ok`/`eof` flags are written on the device,
so `IntLMModel.decode_lockstep` never copies a row to the host. It
replaces the XLA scan of `encodec_tpu/stream/device_ac.py::ac_pull_row`
(not a Pallas kernel; JAX vmaps it over the lanes inside its fused decode
scan). The kernel is `csrc/ac_decode.cu`: one CTA per lane, thread 0
running the coder's state machine and the block counting the symbol's
interval (see the source). Its plain twin is
`stream.device_ac.ac_pull_lanes`, the same integer arithmetic.

For CPU tensors the wrapper runs the twin; for CUDA tensors it launches the
kernel or raises — no fallback. `ac_pull_rows.launches` counts launches.
"""

from __future__ import annotations

import torch

from ..stream import device_ac
from . import build
from .validate import check_tensor, require_same_device

AC_MAX_THREADS = 1024      # csrc/ac_decode.cu kMaxThreads
AC_MAX_WINDOW = 48 * 1024  # static shared memory a CTA may use unasked

ac_pull_rows_plain = device_ac.ac_pull_lanes


def ac_threads(card: int) -> int:
    """The kernel's block size: `card` rounded up to a warp, at most 1024
    (above that a thread tests every 1024th symbol)."""
    return min(AC_MAX_THREADS, 32 * -(-card // 32))


def window_bytes(K: int) -> int:
    """Shared memory of one CTA: the stream bytes a step can reach (a pull
    injects at most 24 bits, so K pulls read < 24K bits from `pos`)."""
    return 3 * K + 2


def _check(state, rows, data, nbits, ts, t, codes, feed, ok, eof) -> None:
    check_tensor("state", state, ndim=2, dtype=torch.int64)
    check_tensor("rows", rows, ndim=3, dtype=torch.int64)
    check_tensor("data", data, ndim=2, dtype=torch.uint8)
    for name, x in (("nbits", nbits), ("ts", ts)):
        check_tensor(name, x, ndim=1, dtype=torch.int64)
    check_tensor("codes", codes, ndim=3, dtype=torch.int64)
    check_tensor("feed", feed, ndim=2, dtype=torch.int64)
    for name, x in (("ok", ok), ("eof", eof)):
        check_tensor(name, x, ndim=1, dtype=torch.bool)
    require_same_device(state, rows, data, nbits, ts, codes, feed, ok, eof)
    S, K, card = rows.shape
    want = {"state": (S, device_ac.STATE_FIELDS), "nbits": (S,), "ts": (S,),
            "feed": (S, K), "ok": (S,), "eof": (S,)}
    got = {"state": state, "nbits": nbits, "ts": ts, "feed": feed, "ok": ok,
           "eof": eof}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape} for rows "
                             f"{tuple(rows.shape)}, got "
                             f"{tuple(got[name].shape)}")
    if S < 1 or K < 1 or card < 1:
        raise ValueError(f"empty rows {tuple(rows.shape)}")
    if data.shape[0] != S or data.shape[1] < 1:
        raise ValueError(f"data: expected [{S}, L >= 1], got "
                         f"{tuple(data.shape)}")
    if tuple(codes.shape[1:]) != (S, K):
        raise ValueError(f"codes: expected [T, {S}, {K}], got "
                         f"{tuple(codes.shape)}")
    if not 0 <= t < codes.shape[0]:
        raise ValueError(f"step t={t} outside codes' {codes.shape[0]} steps")
    if window_bytes(K) > AC_MAX_WINDOW:
        raise ValueError(f"K={K} codebooks need {window_bytes(K)} B of "
                         f"shared memory (at most {AC_MAX_WINDOW})")


def ac_pull_rows(state: torch.Tensor, rows: torch.Tensor, data: torch.Tensor,
                 nbits: torch.Tensor, ts: torch.Tensor, t: int,
                 codes: torch.Tensor, feed: torch.Tensor, ok: torch.Tensor,
                 eof: torch.Tensor) -> None:
    """One lockstep range-decode step of S lanes, in place.

    state `[S, 5]` int64 (`stream.device_ac.init_state`); rows `[S, K,
    card]` int64 CDF rows (`IntLMModel.step`); data `[S, L]` uint8 (each
    lane's stream, zero-padded); nbits, ts `[S]` int64 (stream bits, lane
    length in steps); codes `[T, S, K]` int64 (step t's symbols go to
    `codes[t]`); feed `[S, K]` int64 (the next step's input: 1 + symbols
    where t + 1 < ts, else 0); ok, eof `[S]` bool, sticky. A lane with
    t >= ts writes zeros and keeps its state and flags. All contiguous, on
    one device; the step index t is a host integer, so nothing is read
    back."""
    _check(state, rows, data, nbits, ts, t, codes, feed, ok, eof)
    if rows.device.type == "cpu":
        ac_pull_rows_plain(state, rows, data, nbits, ts, t, codes, feed, ok,
                           eof)
        return
    lib = build.load_library("ac_decode")
    S, K, card = rows.shape
    with torch.cuda.device(rows.device):
        rc = lib.ac_decode_launch(
            state.data_ptr(), rows.data_ptr(), data.data_ptr(),
            nbits.data_ptr(), ts.data_ptr(), t, S, K, card, data.shape[1],
            codes[t].data_ptr(), feed.data_ptr(), ok.data_ptr(),
            eof.data_ptr(), ac_threads(card),
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(lib, "ac_decode", rc)
    ac_pull_rows.launches += 1


ac_pull_rows.launches = 0  # type: ignore[attr-defined]
