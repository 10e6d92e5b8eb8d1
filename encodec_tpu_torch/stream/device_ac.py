"""On-device arithmetic (range) decoding for lmv=3: the plain PyTorch twin.

Port of `encodec_tpu/stream/device_ac.py`. The host range decoder
(`stream.ac.ArithmeticDecoder`, bit-matching the reference
encodec/quantization/ac.py:170-260) is a sequential integer state machine.
Run on the host, it needs every decode step's CDF rows on the host: one
blocking device→host copy per step. This module runs the *identical* state
machine over tensors, so the rows, the coder state and the symbols stay on
the device. On the card, one decode step of all lanes is one launch of the
hand-written kernel `kernels.ac_cuda.ac_head_pull` (`csrc/ac_decode.cu`),
which also finishes the LM's CDF head; `ac_head_pull_lanes`, the head's
tail followed by `ac_pull_lanes`, is that kernel's plain twin, which runs
for CPU tensors.

Lanes. Every function decodes S independent streams at once: lane s is row
s of each tensor. The state is one int64 tensor `[S, 5]` whose columns are
(`low`, `high`, `current`, `max_bit`, `pos`), the last being the number of
bits read. The bit-injection and prefix-flush loops run while any live lane
still needs a step; a lane that is not live keeps its state.

Exactness
---------
The coder state (`low`, `high`, `current`) can reach 2**62 (the reference
asserts `max_bit <= 61`, ac.py:141), so it is held in int64. (JAX holds each
word as two uint32 limbs, because its x64 mode is global and the TPU has no
f64; the port needs neither the limbs nor JAX's 12/13-bit product split.)
Every reference operation is reproduced exactly:

- doubling and bit injection: `2 * v + bit` in int64;
- `effective_low = ceil(range_low * delta / 2**24)` (and the floor twin):
  the reference computes this in f64 (ac.py:188-197), which is exact at
  these widths (`range_low < 2**25`, `delta < 2**25`, so the product is
  below 2**50 < 2**53). `_mul_shift24` forms the same product in int64,
  exactly, and shifts: the integer result equals the reference's f64
  result bit for bit.
- symbol search: the reference binary-searches the CDF row (ac.py:189-205).
  Here, as in JAX, the bounds of *all* symbols are computed at once and
  `sym = count(eff_low <= current - low) - 1`, clamped to `[0, card)`, with
  `ok = eff_low[sym] <= current - low <= eff_high[sym]` (the bounds are
  monotone in the symbol, so this is the same answer; a failed `ok` flags
  a malformed stream instead of the reference's RuntimeError).
- `current` is what JAX's two limbs hold: doubling wraps modulo 2**64, and
  the flush's subtraction of a bit below bit 32 borrows only within the
  low 32 bits (JAX's `_sub_bit`); `current - low` is taken modulo 2**32 as
  a signed 32-bit value, as JAX's difference of the low limbs is. On a
  valid stream `current` lies in `[low, high]`, every subtracted bit is
  set in it and `current - low < delta`, so none of this acts and the
  arithmetic is exact. After a corrupt step `current` runs above `high`;
  then these rules keep the symbols, the state and the `ok` and `eof`
  flags equal to JAX's.

The bitstream is LSB-first within bytes (`stream.binary.BitPacker` with
bits=1, ref binary.py:55-88): bit *i* is `(data[i >> 3] >> (i & 7)) & 1`.
Reads at or past the lane's `nbits` yield 0 bits. The reference's
BitUnpacker instead reports exhaustion (ac.py:180-182); here the same
condition is the `eof` flag (`pos > nbits` after a pull), raised by the
caller after the decode. A stream that encodes the N symbols being decoded
contains every bit those N pulls consume, so the two behaviours cannot
diverge on any stream the encoder produced.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

TOTAL_RANGE_BITS = 24
# the columns of a state `[S, 5]`
LOW, HIGH, CUR, MAX_BIT, POS = range(5)
STATE_FIELDS = 5
_LO_LIMB = 0xFFFFFFFF
_HI_LIMB = -(1 << 32)      # 0xFFFFFFFF00000000 as int64


def init_state(batch: tp.Optional[int] = None,
               device: tp.Union[str, torch.device] = "cpu") -> Tensor:
    """Fresh decoder state: int64 `[5]` (or `[batch, 5]`, one row per lane)
    of (low, high, current, max_bit, pos) = (0, 0, 0, -1, 0), as
    ArithmeticDecoder.__init__."""
    shape = (STATE_FIELDS,) if batch is None else (batch, STATE_FIELDS)
    state = torch.zeros(shape, dtype=torch.int64, device=device)
    state[..., MAX_BIT] = -1
    return state


def _mul_shift24(r: Tensor, delta: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Exact (floor(r * delta / 2**24), ceil(r * delta / 2**24)) for int64
    `r`, `delta` < 2**25, matching the reference's exact-f64
    `math.floor/ceil(range * ratio)` (ac.py:132-133, 196-197): the product
    is below 2**50, and `>>` is the floor."""
    p = r * delta
    floor = p >> TOTAL_RANGE_BITS
    frac = (p & ((1 << TOTAL_RANGE_BITS) - 1)) != 0
    return floor, floor + frac


def _wrap32(x: Tensor) -> Tensor:
    """x modulo 2**32 as a signed 32-bit value (JAX's uint32 → int32)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _pull_bit(data: Tensor, pos: Tensor, nbits: Tensor) -> Tensor:
    """LSB-first bit `pos[s]` of lane s's uint8 buffer `data[s]`; 0 at or
    past bit `nbits[s]`, the lane's true stream length (the buffer may be
    wider, padded to the longest lane)."""
    idx = torch.clamp(pos >> 3, 0, data.shape[1] - 1)
    byte = torch.gather(data, 1, idx[:, None])[:, 0].to(torch.int64)
    return torch.where(pos < nbits, (byte >> (pos & 7)) & 1, 0)


def ac_pull(state: Tensor, cdf_rows: Tensor, data: Tensor, nbits: Tensor,
            live: tp.Optional[Tensor] = None
            ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Decode one symbol in each lane. `state` `[S, 5]`, `cdf_rows`
    `[S, card]` int64 quantized CDFs (the rows the host decoder sees),
    `data` `[S, L]` uint8, `nbits` `[S]`; `live` `[S]` bool (default all)
    marks the lanes to advance. Returns (new_state, symbols `[S]`,
    ok `[S]`); a lane that is not live keeps its state.

    Exactly `ArithmeticDecoder.pull` (ref ac.py:178-207): bit injection
    until delta >= 2**24, vectorized interval search, bound update, and
    common-prefix flush."""
    low, high, cur, max_bit, pos = state.unbind(-1)
    if live is None:
        live = torch.ones_like(low, dtype=torch.bool)

    # 1. inject bits until the range is wide enough to split (ac.py:179-186)
    while True:
        need = live & (high - low + 1 < (1 << TOTAL_RANGE_BITS))
        if not bool(need.any()):
            break
        bit = _pull_bit(data, pos, nbits)
        low = torch.where(need, low * 2, low)
        high = torch.where(need, high * 2 + 1, high)
        cur = torch.where(need, cur * 2 + bit, cur)
        max_bit = max_bit + need
        pos = pos + need

    # 2. vectorized symbol search (ac.py:188-205)
    delta = (high - low + 1)[:, None]
    cur_rel = _wrap32(cur - low)
    cdf = cdf_rows.to(torch.int64)
    _, eff_low = _mul_shift24(F.pad(cdf[:, :-1], (1, 0)), delta)    # ceil
    eff_high, _ = _mul_shift24(cdf - 1, delta)                       # floor
    sym = (eff_low <= cur_rel[:, None]).sum(-1) - 1
    sym = torch.clamp(sym, 0, cdf.shape[1] - 1)
    sel_low = torch.gather(eff_low, 1, sym[:, None])[:, 0]
    sel_high = torch.gather(eff_high, 1, sym[:, None])[:, 0]
    ok = (sel_low <= cur_rel) & (cur_rel <= sel_high)

    # 3. bound update: low/high <- old_low + effective bounds (ac.py:204)
    high = low + sel_high
    low = low + sel_low

    # 4. common-prefix flush (ac.py:167-176)
    while True:
        k = torch.clamp(max_bit, min=0)
        b1 = (low >> k) & 1
        flush = live & (max_bit >= 0) & (b1 == ((high >> k) & 1))
        if not bool(flush.any()):
            break
        sub = torch.where(flush, b1 << k, 0)
        low = low - sub
        high = high - sub
        cur = torch.where(k < 32, (cur & _HI_LIMB) | ((cur - sub) & _LO_LIMB),
                          cur - sub)
        max_bit = max_bit - flush.to(torch.int64)

    new = torch.stack([low, high, cur, max_bit, pos], -1)
    return torch.where(live[:, None], new, state), sym, ok


def ac_pull_row(state: Tensor, rows: Tensor, data: Tensor, nbits: Tensor,
                live: tp.Optional[Tensor] = None
                ) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Decode one `[K, card]` row of symbols per lane (the per-timestep
    codebook sweep of the LM codec, ref compress.py:130-148): `rows`
    `[S, K, card]`. Returns (state, `[S, K]` symbols, all-ok `[S]`, eof
    `[S]`), where `eof` mirrors the host BitUnpacker's exhaustion (some bit
    the lane consumed lay past its `nbits`)."""
    syms, oks = [], []
    for k in range(rows.shape[1]):
        state, sym, ok = ac_pull(state, rows[:, k], data, nbits, live)
        syms.append(sym)
        oks.append(ok)
    eof = state[:, POS] > nbits
    return state, torch.stack(syms, 1), torch.stack(oks, 1).all(1), eof


def ac_decode_rows(data: Tensor, cdfs: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Decode `cdfs.shape[0]` symbols from the uint8 stream `data` `[L]`
    with one `[card]` CDF row per symbol (`cdfs` `[N, card]`). Returns
    (`[N]` int64 symbols, all-rows-ok flag): the test surface against the
    host `ArithmeticDecoder`."""
    state = init_state(1, data.device)
    nbits = torch.full((1,), 8 * data.shape[0], dtype=torch.int64,
                       device=data.device)
    syms, oks = [], []
    for row in cdfs:
        state, sym, ok = ac_pull(state, row[None], data[None], nbits)
        syms.append(sym)
        oks.append(ok)
    if not syms:
        return (torch.zeros(0, dtype=torch.int64, device=data.device),
                torch.ones((), dtype=torch.bool, device=data.device))
    return torch.cat(syms), torch.cat(oks).all()


def ac_pull_lanes(state: Tensor, rows: Tensor, data: Tensor, nbits: Tensor,
                  ts: Tensor, t: tp.Union[int, Tensor], codes: Tensor,
                  feed: Tensor, ok: Tensor, eof: Tensor) -> None:
    """One lockstep decode step of S lanes, in place: the range decoder's
    part of JAX's fused scan body (`encodec_tpu/models/ilm.py:884-891`).

    The step index `t` is an int or a one-element int64 tensor. Lane s is
    active while `t < ts[s]`: it pulls the K symbols of `rows[s]`
    (`[S, K, card]`), writes them to `codes[t, s]` (`codes` `[T, S, K]`)
    and `1 + symbols` to `feed[s]` where `t + 1 < ts[s]` (else 0: the
    writer padded the lane with zeros), and folds its step into the sticky
    flags `ok[s]` (every pull's symbol lay inside its interval) and
    `eof[s]` (some consumed bit lay past `nbits[s]`). An inactive lane
    keeps its state and flags and writes zeros."""
    live = t < ts
    new, syms, ok_row, eof_row = ac_pull_row(state, rows, data, nbits, live)
    state.copy_(new)
    syms = torch.where(live[:, None], syms, 0)
    codes[t] = syms
    feed.copy_(torch.where((t + 1 < ts)[:, None], syms + 1, 0))
    ok &= ok_row | ~live
    eof |= eof_row & live


def ac_head_pull_lanes(state: Tensor, acc: Tensor, head_b: Tensor, e0: int,
                       lut: Tensor, data: Tensor, nbits: Tensor, ts: Tensor,
                       t: Tensor, codes: Tensor, feed: Tensor, ok: Tensor,
                       eof: Tensor) -> None:
    """One lockstep decode step of S lanes from the LM head's product, in
    place: the CDF rows of `acc` [K, S, card] float64 (the integer LM's
    `_head_acc`), with `head_b` [K, card] int32, the head's exponent `e0`
    and the exp2 table `lut` [1024] (`models.ilm._head_tail`), then
    `ac_pull_lanes` at the step `t` [1] int64: JAX's fused scan body after
    its trunk (`encodec_tpu/models/ilm.py:661` `_head_cdf`, then
    `stream/device_ac.py:222` `ac_pull_row` per lane). The plain twin of
    `kernels.ac_head_pull`."""
    from ..models.ilm import _head_tail

    ac_pull_lanes(state, _head_tail(acc, head_b, e0, lut), data, nbits, ts,
                  t, codes, feed, ok, eof)
