"""Integer (fixed-point) LM: the machine-portable entropy prior of lmv=3.

Port of `encodec_tpu/models/ilm.py`. An lmv=3 `.ecdc` stream is decodable
only by a reader that rebuilds the writer's quantized CDF rows exactly, so
every op of this LM is exact integer arithmetic: any device, any batching
and any chunking give bit-identical rows, here and in the JAX package.

What is copied unchanged, because it *is* the format: the constants, the
LUT builders (pure-Python `decimal` arithmetic, no libm), the weight
quantization (`quantize_lm_params`: IEEE rint and power-of-two scales) and
the code checksum (`codes_checksum`, the container's "cc").

What is rewritten for torch, op for op after the JAX functions:
- Integers are held in int64 (embeddings and the k/v caches in int16,
  widened before any sum). JAX's uint32 values (the positional phase, the
  `_mul32`/`_shr64` limbs) become int64 masked with `& 0xFFFFFFFF` where
  JAX wraps; a 32x32-bit product and its shift are one int64 product,
  every one under 2^47. Integer division is floor division and `>>` is
  arithmetic, as in XLA.
- Every contraction (the linears, the head, q.k and the attention sum) is
  one float64 matmul of the integer values. Each partial sum is an integer
  below 2^31 (|a| <= MM_CLIP = 16319, |w| <= 127, n <= 800; |q7| <= 2047,
  |k| <= 16319, hd = 25; sum(a) ~ 2^12, |v| <= 16319), far below 2^53, so
  the result is exact whatever order the library sums in; it equals the
  TPU's base-128 int8 split without needing it. torch has no integer
  matmul on CUDA.
- The streaming step is the chunk forward at C = 1: its mask is the
  step's window, so the two cannot drift apart.

Decoding (`IntLMModel.decode_lockstep`) runs on the model's device, as
JAX's fused scan does. A decode step (`_DecodeGraph`) is the integer
trunk for all lanes over a k/v ring in static buffers, the head's float64
product, and one launch of `kernels.ac_head_pull` (the CUDA kernel of
`csrc/ac_decode.cu`; on the CPU its twin `stream.device_ac`), which
finishes the head into CDF rows and pulls every lane's K symbols, writing
the codes, the next step's feed and the `ok`/`eof` flags on the device.
The step index is a device counter, so on the card one step is captured
as a CUDA graph and replayed; nothing is read back until the last step,
when the codes and flags come to the host in one copy.

Bitstream contract: EVERY constant below (scales, clips, LUT contents,
shift order) defines the lmv=3 format. Changing any of them changes the
bitstream.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch

from ..device import resolve_device
from .lm import LMConfig

Tensor = torch.Tensor

ILM_VERSION = 3            # == the .ecdc "lmv" this module implements

ABITS = 10                 # activation fixed-point scale 2^10
ACT_MAX = 32767            # activation clip (int16 range, real +/-32)
MM_CLIP = 16319            # matmul-input clip: 2^14-65 keeps the balanced
                           # base-128 int8 split's high half within +/-127
QBITS = 7                  # q is pre-scaled to 2^7 before the k-dot
EXP_BITS = 13              # exp2 LUT output scale (values in [2^13, 2^14))
TOTAL_RANGE_BITS = 24      # matches stream.ac / the reference coder


# ---------------------------------------------------------------------------
# Deterministic LUTs (pure-Python decimal/Fraction arithmetic; identical on
# every machine — no libm involvement anywhere)
# ---------------------------------------------------------------------------

_PI_50 = "3.14159265358979323846264338327950288419716939937511"


def _decimal_ctx():
    import decimal
    ctx = decimal.Context(prec=50)
    return decimal, ctx


def _dround(decimal, v) -> int:
    return int(v.to_integral_value(rounding=decimal.ROUND_HALF_EVEN))


@functools.lru_cache()
def exp2_table() -> np.ndarray:
    """E[f] = round(2^EXP_BITS * 2^(f/1024)), f in [0, 1024).

    Built by repeated multiplication with 2^(1/1024) at 50-digit decimal
    precision — accumulated error ~1e-47, vastly inside the rounding
    cells (the values are irrational for f != 0, so no .5 ties exist)."""
    decimal, ctx = _decimal_ctx()
    step = ctx.exp(ctx.ln(decimal.Decimal(2)) / 1024)
    out = np.empty(1024, np.int32)
    v = decimal.Decimal(1 << EXP_BITS)
    for f in range(1024):
        out[f] = _dround(decimal, v)
        v = ctx.multiply(v, step)
    return out


@functools.lru_cache()
def sin_table() -> np.ndarray:
    """S[i] = round(2^14 * sin((pi/2) * i/1024)), i in [0, 1025] (the last
    entry duplicates i=1024 so interpolation at the quadrant edge is
    in-bounds). Chebyshev recurrence sin((i+1)t) = 2cos(t)sin(it) -
    sin((i-1)t) at 50-digit precision (error ~1e-46; values irrational
    except the exact endpoints — no .5 ties)."""
    decimal, ctx = _decimal_ctx()
    theta = decimal.Decimal(_PI_50) / 2048

    def _taylor(fn_sign_start, x):
        # sin: start=x, n0=1; cos: start=1, n0=0
        term, acc, n = fn_sign_start, fn_sign_start, 0
        xx = ctx.multiply(x, x)
        for k in range(40):
            n += 2
            div = n * (n + 1) if fn_sign_start == x else (n - 1) * n
            term = ctx.divide(ctx.multiply(-term, xx), decimal.Decimal(div))
            acc = ctx.add(acc, term)
        return acc

    sin1 = _taylor(theta, theta)
    cos1 = _taylor(decimal.Decimal(1), theta)
    two_cos = ctx.multiply(decimal.Decimal(2), cos1)
    scale = decimal.Decimal(1 << 14)
    out = np.empty(1026, np.int32)
    s_prev, s_cur = decimal.Decimal(0), sin1
    out[0] = 0
    for i in range(1, 1025):
        out[i] = _dround(decimal, ctx.multiply(s_cur, scale))
        s_prev, s_cur = s_cur, ctx.subtract(ctx.multiply(two_cos, s_cur),
                                            s_prev)
    out[1025] = out[1024]
    return out


@functools.lru_cache()
def gelu_table() -> np.ndarray:
    """T[i] = round(2^ABITS * gelu(-16 + i/16)), i in [0, 513] (entry 513
    duplicates 512 for in-bounds interpolation). Exact (erf-based) gelu,
    erf via a decimal Taylor series (50 digits; |x|/sqrt(2) <= 6 needs
    ~90 terms, beyond that erf == +/-1 to 1e-17 < table resolution)."""
    decimal, ctx = _decimal_ctx()
    sqrt2 = ctx.sqrt(decimal.Decimal(2))
    two_over_sqrt_pi = ctx.divide(
        decimal.Decimal(2), ctx.sqrt(decimal.Decimal(_PI_50)))

    def erf(z):
        if z < 0:
            return -erf(-z)
        if z > 6:
            return decimal.Decimal(1)
        term, acc = z, z
        zz = ctx.multiply(z, z)
        for n in range(1, 110):
            term = ctx.divide(ctx.multiply(-term, zz), decimal.Decimal(n))
            acc = ctx.add(acc, ctx.divide(term, decimal.Decimal(2 * n + 1)))
        return ctx.multiply(two_over_sqrt_pi, acc)

    out = np.empty(514, np.int32)
    half = decimal.Decimal("0.5")
    for i in range(513):
        x = decimal.Decimal(i - 256) / 16
        g = ctx.multiply(ctx.multiply(x, half),
                         ctx.add(decimal.Decimal(1),
                                 erf(ctx.divide(x, sqrt2))))
        out[i] = _dround(decimal, ctx.multiply(g, decimal.Decimal(1 << ABITS)))
    out[513] = out[512]
    return out


@functools.lru_cache()
def invsqrt_table() -> np.ndarray:
    """Y0[j] = round(2^22 / sqrt(m_j)) for m_j = (j+256)*128 + 64, covering
    m in [2^15, 2^17) with 768 cells (LUT seed; one Newton step follows
    in-graph). decimal sqrt is correctly rounded."""
    decimal, ctx = _decimal_ctx()
    out = np.empty(768, np.int32)
    num = decimal.Decimal(1 << 22)
    for j in range(768):
        m = (j + 256) * 128 + 64
        v = ctx.divide(num, ctx.sqrt(decimal.Decimal(m)))
        out[j] = int(v.to_integral_value(rounding=decimal.ROUND_HALF_EVEN))
    return out


@functools.lru_cache()
def pos_phase_steps(dim: int, max_period: float) -> np.ndarray:
    """Per-dimension phase increments: step[j] = round(2^32 /
    (2*pi*max_period^(j/(half-1)))) as uint32 — one wraparound add per
    token reproduces the reference's sinusoid arguments in *turns*
    (ref transformer.py:16-27). Python-int exact; identical everywhere."""
    decimal, ctx = _decimal_ctx()
    half = dim // 2
    two_pi = 2 * decimal.Decimal(_PI_50)
    period = decimal.Decimal(repr(max_period))
    out = np.empty(half, np.uint64)
    for j in range(half):
        p = ctx.power(period, decimal.Decimal(j) / (half - 1))
        v = ctx.divide(decimal.Decimal(1 << 32), two_pi * p)
        out[j] = int(v.to_integral_value(
            rounding=decimal.ROUND_HALF_EVEN)) & 0xFFFFFFFF
    return out.astype(np.uint32)


def layernorm_consts(d: int, eps: float = 1e-5) -> tp.Tuple[int, int]:
    """(eps in V-units, Kd = round(sqrt(d) * 2^ABITS)) — see _layernorm."""
    decimal, ctx = _decimal_ctx()
    eps_units = int((decimal.Decimal(repr(eps)) * d * (1 << 2 * ABITS))
                    .to_integral_value(rounding=decimal.ROUND_HALF_EVEN))
    kd = int((ctx.sqrt(decimal.Decimal(d)) * (1 << ABITS))
             .to_integral_value(rounding=decimal.ROUND_HALF_EVEN))
    return eps_units, kd


def qk_scale_const(head_dim: int) -> int:
    """round(2^12 / sqrt(head_dim)) — the 1/sqrt(hd) attention scale."""
    decimal, ctx = _decimal_ctx()
    v = ctx.divide(decimal.Decimal(1 << 12),
                   ctx.sqrt(decimal.Decimal(head_dim)))
    return int(v.to_integral_value(rounding=decimal.ROUND_HALF_EVEN))


LOG2E_Q14 = 23637   # round(log2(e) * 2^14); base-e -> base-2 logit convert


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# Weight quantization (deterministic: IEEE rint + power-of-two scaling)
# ---------------------------------------------------------------------------

def _pow2_exponent(max_abs: float, target: int = 127, lo: int = -8,
                   hi: int = 20) -> int:
    """Largest e in [lo, hi] with max_abs * 2^e <= target, via exact
    power-of-two float multiplies (no log — libm-free, deterministic)."""
    if max_abs == 0.0 or not np.isfinite(max_abs):
        return 0
    e = hi
    while e > lo and float(max_abs) * float(2.0 ** e) > target:
        e -= 1
    return e


def _qmat(w: np.ndarray) -> tp.Tuple[np.ndarray, int]:
    """float weights -> (int8 quantized, power-of-two exponent e):
    w_q = rint(w * 2^e), |w_q| <= 127."""
    w = np.asarray(w, np.float64)
    e = _pow2_exponent(float(np.max(np.abs(w))) if w.size else 0.0)
    q = np.clip(np.rint(w * (2.0 ** e)), -127, 127).astype(np.int8)
    return q, e


def _qvec(v: np.ndarray, bits: int = ABITS,
          clip: int = 2 ** 30) -> np.ndarray:
    return np.clip(np.rint(np.asarray(v, np.float64) * (1 << bits)),
                   -clip, clip).astype(np.int32)


def quantize_lm_params(params: dict, cfg: LMConfig
                       ) -> tp.Tuple[dict, tuple]:
    """Float LM pytree (models.lm layout) -> (integer param pytree,
    static per-matrix exponent tuple). Deterministic on any host."""
    g = _host

    iparams: dict = {
        "emb": np.clip(np.rint(g(params["emb"]).astype(np.float64)
                               * (1 << ABITS)),
                       -ACT_MAX, ACT_MAX).astype(np.int16),
        "norm_in": {
            # |scale| capped at 8 so n*scale stays in int32 (see _layernorm)
            "scale": _qvec(g(params["norm_in"]["scale"]), clip=8 << ABITS),
            "bias": _qvec(g(params["norm_in"]["bias"]), clip=ACT_MAX),
        },
        "layers": [],
    }
    head_q, head_e = _qmat(g(params["linears"]["w"]))
    iparams["head_w"] = head_q
    iparams["head_b"] = _qvec(g(params["linears"]["b"]))
    exps = [head_e]
    for layer in params["layers"]:
        il = {}
        for name in ("q", "k", "v", "out", "ff1", "ff2"):
            wq, e = _qmat(g(layer[name]["w"]))
            il[name] = {"w": wq, "b": _qvec(g(layer[name]["b"]))}
            exps.append(e)
        for nm in ("norm1", "norm2"):
            il[nm] = {"scale": _qvec(g(layer[nm]["scale"]), clip=8 << ABITS),
                      "bias": _qvec(g(layer[nm]["bias"]), clip=ACT_MAX)}
        iparams["layers"].append(il)
    # LUTs ride in the pytree (constant int arrays, same on every host)
    iparams["lut"] = {
        "exp2": exp2_table(), "sin": sin_table(), "gelu": gelu_table(),
        "invsqrt": invsqrt_table(),
        "pos_step": pos_phase_steps(cfg.dim, cfg.max_period),
    }
    return iparams, tuple(exps)


# ---------------------------------------------------------------------------
# Integer numerics (int64 tensors; see the module docstring)
# ---------------------------------------------------------------------------

MASK32 = 0xFFFFFFFF   # JAX's uint32 wraparound


@functools.lru_cache()
def _consts(cfg: LMConfig) -> tp.Tuple[tp.Tuple[int, int], int]:
    """(layernorm (eps units, Kd), q.k scale) of a configuration."""
    return layernorm_consts(cfg.dim), qk_scale_const(cfg.dim // cfg.num_heads)


def _floordiv(a: Tensor, b) -> Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _rshift_round(x: Tensor, s: int) -> Tensor:
    """Round-half-up arithmetic right shift (s static >= 0)."""
    if s <= 0:
        return x << (-s)
    return (x + (1 << (s - 1))) >> s


def _imatmul(a: Tensor, b: Tensor) -> Tensor:
    """Exact integer `a @ b` as one float64 matmul: exact while every
    partial sum is an integer below 2^53, which each caller's bound keeps."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def _dot_i8(a: Tensor, w8: Tensor) -> Tensor:
    """Exact a[..., n] @ w8[n, m] for |a| <= MM_CLIP, |w8| <= 127, n <= 800
    (|acc| < 1.7e9), the JAX function's int8 split in one matmul."""
    return _imatmul(a, w8)


def _linear(x: Tensor, layer: dict, e: int) -> Tensor:
    """A10 activations -> A10 output: clip, integer matmul, rescale, bias."""
    acc = _dot_i8(torch.clamp(x, -MM_CLIP, MM_CLIP), layer["w"])
    return _rshift_round(acc, e) + layer["b"]


def _bitlen(x: Tensor) -> Tensor:
    """Bit length of non-negative int64 values below 2^53 (0 -> 0): the
    exponent of frexp, exact on their exact float64 conversion."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _layernorm(x: Tensor, scale_q: Tensor, bias_q: Tensor, d: int,
               lut_invsqrt: Tensor, eps_units: int, kd: int) -> Tensor:
    """Integer LayerNorm over the last axis (A10 in/out): the JAX
    function's limb arithmetic on the exact int64 variance V < 2^38."""
    x = torch.clamp(x, -ACT_MAX, ACT_MAX)
    s = x.sum(-1, keepdim=True)
    half = d // 2
    mu = _floordiv(s + torch.where(s >= 0, half, -half), d)  # round-to-nearest
    c = torch.clamp(x - mu, -32768, 32767)
    v = (c * c).sum(-1, keepdim=True) + eps_units
    h = (_bitlen(v) - 16) >> 1                         # floor; may be negative
    # m = V >> 2h (or << -2h), in [2^15, 2^17)
    m = torch.where(h >= 0, v >> torch.clamp(2 * h, min=0),
                    v << torch.clamp(-2 * h, min=0))
    y0 = lut_invsqrt[torch.clamp((m >> 7) - 256, 0, 767)]   # ~2^22 / sqrt(m)
    # Newton: y1 = y0 * (3*2^14 - (m*y0^2 >> 30)) >> 15  (m*y0^2 < 2^47)
    y1 = (y0 * ((3 << 14) - ((m * y0 * y0) >> 30))) >> 15
    # n = c * y1 * Kd >> (22 + h)   (A10 normalized value; |c*y1*Kd| < 2^45)
    cy = c * y1
    n = torch.sign(cy) * ((cy.abs() * kd) >> torch.clamp(22 + h, 0, 63))
    n = torch.clamp(n, -ACT_MAX, ACT_MAX)
    out = _rshift_round(n * scale_q, ABITS) + bias_q
    return torch.clamp(out, -ACT_MAX, ACT_MAX)


def _exp2_fixed(t: Tensor, lut: Tensor) -> Tensor:
    """2^(t/2^ABITS) at scale 2^EXP_BITS for t <= 0 (A10 base-2 log
    domain). Saturates to 0 below ~-31 integer bits.

    With u = -t = q*1024 + r:  2^(-u/1024) = LUT[0] >> q when r == 0,
    else LUT[1024-r] >> (q+1)."""
    u = torch.clamp(-t, max=31 << ABITS)
    q = u >> ABITS
    r = u & ((1 << ABITS) - 1)
    f = ((1 << ABITS) - r) & ((1 << ABITS) - 1)
    shift = q + (r != 0).to(torch.int64)
    return lut[f] >> torch.clamp(shift, max=31)


def _to_base2(logits: Tensor) -> Tensor:
    """A10 natural-log-domain logit deltas (<= 0) -> A10 base-2."""
    return _rshift_round(logits * LOG2E_Q14 >> 7, 7)


def _gelu_int(x: Tensor, lut: Tensor) -> Tensor:
    """A10 gelu via 512-cell LUT + linear interpolation."""
    u = torch.clamp(x, -(16 << ABITS), (16 << ABITS) - 1) + (16 << ABITS)
    idx = u >> 6
    t0 = lut[idx]
    t1 = lut[idx + 1]
    return t0 + (((t1 - t0) * (u & 63)) >> 6)


def _sin_from_phase(phase: Tensor, lut: Tensor) -> Tensor:
    """sin(2*pi*phase/2^32) at A10 for phase in [0, 2^32), via the
    quarter-wave LUT + interpolation."""
    quad = phase >> 30                                 # 0..3
    p20 = (phase >> 10) & 0xFFFFF                      # pos within quadrant
    mirrored = torch.where((quad & 1) == 1, (1 << 20) - p20, p20)
    idx = mirrored >> 10                               # 0..1024
    s0 = lut[idx]
    s1 = lut[idx + 1]
    v = s0 + (((s1 - s0) * (mirrored & 1023)) >> 10)   # scale 2^14
    v = torch.where(quad >= 2, -v, v)
    return _rshift_round(v, 4)                         # -> A10


def _pos_embedding(phase: Tensor, lut_sin: Tensor) -> Tensor:
    """phase [..., half] -> A10 [..., dim] (cos half then sin half)."""
    cos = _sin_from_phase((phase + (1 << 30)) & MASK32, lut_sin)
    return torch.cat([cos, _sin_from_phase(phase, lut_sin)], dim=-1)


# ---------------------------------------------------------------------------
# CDF head (the lmv=3 bitstream definition)
# ---------------------------------------------------------------------------

def scores_to_cdf(scores: Tensor) -> Tensor:
    """Integer exp-scores [..., card] -> quantized CDF rows.

    With M = 2^24 - 2*card (the distributable range mass after the
    min_range=2 floor): ranges_i = 2 + (floor(e_i * 2^16 / sum(e)) *
    (M >> 10)) >> 6, cdf = cumsum. Every range >= 2 and cdf[-1] <= 2^24 by
    construction."""
    card = scores.shape[-1]
    m = (1 << TOTAL_RANGE_BITS) - 2 * card
    total = scores.sum(-1, keepdim=True)               # <= card * 2^14
    p16 = _floordiv(scores << 16, torch.clamp(total, min=1))
    return torch.cumsum(2 + ((p16 * (m >> 10)) >> 6), dim=-1)


def int_symbol_bounds(cdf: Tensor, symbols: Tensor
                      ) -> tp.Tuple[Tensor, Tensor]:
    """(cdf [..., card], symbols [...]) -> coder (range_low, range_high),
    the `push_bounds` convention (ref ac.py:139-146)."""
    sym = symbols[..., None].to(torch.int64)
    high = torch.gather(cdf, -1, sym)[..., 0] - 1
    prev = torch.gather(cdf, -1, torch.clamp(sym - 1, min=0))[..., 0]
    return torch.where(symbols == 0, 0, prev), high


# ---------------------------------------------------------------------------
# The integer transformer
# ---------------------------------------------------------------------------

class ILMStreamState(tp.NamedTuple):
    kcache: Tensor  # [L, B, W, C] int16 — cached K projections, newest last
    vcache: Tensor  # [L, B, W, C] int16 — cached V projections
    length: int     # includes the zero-init entry (ref quirk)
    phase: Tensor   # [half] int64 in [0, 2^32) — phase of the next token


def _exps_of(exps: tuple, li: int) -> dict:
    """Static exponents for layer li: head is exps[0], then 6 per layer."""
    names = ("q", "k", "v", "out", "ff1", "ff2")
    base = 1 + 6 * li
    return {n: exps[base + i] for i, n in enumerate(names)}


def init_ilm_stream(iparams: dict, cfg: LMConfig, batch: int = 1,
                    offset: int = 0) -> ILMStreamState:
    """Fresh stream state on the parameters' device. The ring's newest slot
    holds the reference's zero-init cache entry (ref transformer.py:106):
    the projection of a zero input, i.e. the clipped k/v biases. `offset`
    sets the positional phase exactly as `offset` wraparound additions
    would."""
    W, d = cfg.past_context, cfg.dim
    dev = iparams["emb"].device
    kc = torch.zeros((cfg.num_layers, batch, W, d), dtype=torch.int16,
                     device=dev)
    vc = torch.zeros_like(kc)
    for li, layer in enumerate(iparams["layers"]):
        kc[li, :, W - 1] = torch.clamp(layer["k"]["b"], -MM_CLIP, MM_CLIP)
        vc[li, :, W - 1] = torch.clamp(layer["v"]["b"], -MM_CLIP, MM_CLIP)
    steps = pos_phase_steps(cfg.dim, cfg.max_period)
    phase = ((int(offset) * steps.astype(np.uint64)) % (1 << 32)).astype(
        np.int64)
    return ILMStreamState(kc, vc, 1, torch.from_numpy(phase).to(dev))


def _trunk_in(iparams: dict, indices: Tensor, phase: Tensor,
              cfg: LMConfig, eps_kd: tp.Tuple[int, int]) -> Tensor:
    """Summed codebook embeddings -> norm_in -> + positional (A10).
    indices [..., K] (1 + previous code, 0 = start)."""
    K = indices.shape[-1]
    emb = iparams["emb"][:K]                           # [K, card+1, d] int16
    rows = torch.arange(K, device=indices.device) * emb.shape[1]
    gathered = emb.reshape(-1, cfg.dim)[indices + rows]    # [..., K, d]
    x = gathered.to(torch.int64).sum(-2)
    x = _layernorm(x, iparams["norm_in"]["scale"], iparams["norm_in"]["bias"],
                   cfg.dim, iparams["lut"]["invsqrt"], *eps_kd)
    pe = _pos_embedding(phase, iparams["lut"]["sin"])
    return torch.clamp(x + pe, -ACT_MAX, ACT_MAX)


def _attention_out(a: Tensor, v: Tensor) -> Tensor:
    """a [B,H,T,S] (2^12-scaled weights), v [B,S,H,hd] -> A10 [B,T,H*hd]."""
    out = _imatmul(a, v.transpose(1, 2))               # [B, H, T, hd]
    B, T = out.shape[0], out.shape[2]
    return _rshift_round(out.transpose(1, 2).reshape(B, T, -1), 12)


def _softmax_weights(logits: Tensor, mask: Tensor, lut_exp2: Tensor) -> Tensor:
    """Masked integer softmax -> 2^12-scaled weights (exact division)."""
    lm = torch.where(mask, logits, -(1 << 30))
    mx = lm.max(-1, keepdim=True).values
    t = torch.clamp(lm - mx, -(63 << ABITS), 0)
    e = torch.where(mask, _exp2_fixed(_to_base2(t), lut_exp2), 0)
    tot = torch.clamp(e.sum(-1, keepdim=True), min=1)
    return _floordiv(e << 12, tot)


def _head_acc(iparams: dict, x: Tensor, K: int) -> Tensor:
    """Trunk output [..., d] -> the head's product, float64 [K, N, card]
    (N the product of the leading dims): one matmul of the clipped
    activations and the int8 weights of the first K codebooks, every sum
    an integer below 2^31, so exact (see `_imatmul`)."""
    xc = torch.clamp(x, -MM_CLIP, MM_CLIP)
    return torch.matmul(xc.reshape(1, -1, xc.shape[-1]).to(torch.float64),
                        iparams["head_w"][:K])


def _head_tail(acc: Tensor, head_b: Tensor, e0: int,
               lut_exp2: Tensor) -> Tensor:
    """The head after its product: `acc` [K, N, card] (`_head_acc`),
    `head_b` [K, card] -> CDF rows [N, K, card] int64: rescale and bias,
    the row max, the clamped base-2 exponent and `scores_to_cdf`."""
    logits = _rshift_round(acc.to(torch.int64).transpose(0, 1), e0) + head_b
    mx = logits.max(-1, keepdim=True).values
    t = torch.clamp(logits - mx, -(63 << ABITS), 0)
    return scores_to_cdf(_exp2_fixed(_to_base2(t), lut_exp2))


def _head_cdf(iparams: dict, exps: tuple, x: Tensor, K: int) -> Tensor:
    """Trunk output [..., d] -> CDF rows [..., K, card]."""
    rows = _head_tail(_head_acc(iparams, x, K), iparams["head_b"][:K],
                      exps[0], iparams["lut"]["exp2"])
    return rows.reshape(*x.shape[:-1], K, -1)


def _trunk(iparams: dict, exps: tuple, indices: Tensor, kcache: Tensor,
           vcache: Tensor, phases: Tensor, mask: Tensor, cfg: LMConfig
           ) -> tp.Tuple[Tensor, tp.List[Tensor], tp.List[Tensor]]:
    """The integer transformer over a chunk: indices [B, K, C] at positional
    phases [C, half] -> (trunk output [B, C, d], and per layer the chunk's
    clipped keys and values [B, C, d] int64). Each query attends over
    [cache (W slots of `kcache`/`vcache` [L, B, W, d]) | chunk (C)] keys
    where `mask` [C, W + C] is true; the slots' order is the caller's (the
    integer sums do not depend on it)."""
    B, K, C = indices.shape
    W, H, d = kcache.shape[2], cfg.num_heads, cfg.dim
    hd = d // H
    eps_kd, ks = _consts(cfg)
    lut = iparams["lut"]
    x = _trunk_in(iparams, indices.transpose(1, 2), phases[None], cfg,
                  eps_kd)                                      # [B, C, d]
    new_k, new_v = [], []
    for li, layer in enumerate(iparams["layers"]):
        e = _exps_of(exps, li)
        q = _linear(x, layer["q"], e["q"])
        k_new = torch.clamp(_linear(x, layer["k"], e["k"]), -MM_CLIP, MM_CLIP)
        v_new = torch.clamp(_linear(x, layer["v"], e["v"]), -MM_CLIP, MM_CLIP)
        keys = torch.cat([kcache[li].to(torch.int64), k_new], 1)
        vals = torch.cat([vcache[li].to(torch.int64), v_new], 1)
        q7 = torch.clamp(_rshift_round(q, ABITS - QBITS), -2047, 2047)
        qh = q7.reshape(B, C, H, hd).transpose(1, 2)           # [B, H, C, hd]
        kh = keys.reshape(B, W + C, H, hd).permute(0, 2, 3, 1)  # [B, H, hd, S]
        logits = _imatmul(qh, kh)                              # 2^17 scale
        l10 = torch.clamp(_rshift_round(logits, 7), -65535, 65535)
        l10 = torch.clamp((l10 * ks) >> 12, -(63 << ABITS), 63 << ABITS)
        a = _softmax_weights(l10, mask, lut["exp2"])
        attn = _attention_out(a, vals.reshape(B, W + C, H, hd))
        o = _linear(attn, layer["out"], e["out"])
        x1 = _layernorm(x + o, layer["norm1"]["scale"],
                        layer["norm1"]["bias"], d, lut["invsqrt"], *eps_kd)
        ff = _linear(_gelu_int(_linear(x1, layer["ff1"], e["ff1"]),
                               lut["gelu"]), layer["ff2"], e["ff2"])
        x = _layernorm(x1 + ff, layer["norm2"]["scale"],
                       layer["norm2"]["bias"], d, lut["invsqrt"], *eps_kd)
        new_k.append(k_new)
        new_v.append(v_new)
    return x, new_k, new_v


def ilm_chunk_forward(iparams: dict, exps: tuple, indices: Tensor,
                      state: ILMStreamState, cfg: LMConfig
                      ) -> tp.Tuple[Tensor, ILMStreamState]:
    """Teacher-forced chunk: indices [B, K, C] -> (cdf rows [B, C, K, card]
    int64, new state). Windowed attention over [cache(W) | chunk(C)] keys
    with the mask the streaming cell induces:
      in-chunk key s for query t:  0 <= t - s <= W
      cache slot j for query t:    j >= max(t, W - min(length, W))
    (the zero entry lives in the ring, placed by init_ilm_stream)."""
    _, K, C = indices.shape
    W = cfg.past_context
    lut = iparams["lut"]
    dev = indices.device

    # per-position phases: phase_t = phase0 + t*step (wraparound exact)
    tpos = torch.arange(C, device=dev)[:, None]
    phases = (state.phase[None, :] + tpos * lut["pos_step"][None, :]) & MASK32

    n_valid = min(state.length, W)
    t_ar = torch.arange(C, device=dev)[:, None]
    cache_mask = torch.arange(W, device=dev)[None, :] >= torch.clamp(
        t_ar, min=W - n_valid)                                 # [C, W]
    lag = t_ar - torch.arange(C, device=dev)[None, :]
    mask = torch.cat([cache_mask, (lag >= 0) & (lag <= W)], 1)  # [C, W+C]

    x, ks, vs = _trunk(iparams, exps, indices, state.kcache, state.vcache,
                       phases, mask, cfg)
    cdf = _head_cdf(iparams, exps, x, K)                       # [B, C, K, card]
    return cdf, ILMStreamState(
        kcache=torch.stack([torch.cat([c, k.to(torch.int16)], 1)[:, -W:]
                            for c, k in zip(state.kcache, ks)]),
        vcache=torch.stack([torch.cat([c, v.to(torch.int16)], 1)[:, -W:]
                            for c, v in zip(state.vcache, vs)]),
        length=min(state.length + C, W + 1),
        phase=(state.phase + C * lut["pos_step"]) & MASK32)


def ilm_step(iparams: dict, exps: tuple, indices: Tensor,
             state: ILMStreamState, cfg: LMConfig
             ) -> tp.Tuple[Tensor, ILMStreamState]:
    """One streaming step: indices [B, K] -> (cdf rows [B, K, card], new
    state): the chunk forward at C = 1, whose mask is the step's window."""
    cdf, state = ilm_chunk_forward(iparams, exps, indices[:, :, None], state,
                                   cfg)
    return cdf[:, 0], state


# ---------------------------------------------------------------------------
# Model wrapper (the lmv=3 codec surface consumed by stream.compress)
# ---------------------------------------------------------------------------

def _device_params(tree, device: torch.device, key: str = ""):
    """Integer parameters (numpy) -> tensors on `device`: matrices as
    float64 (the contractions' operand type, exact), embeddings int16,
    everything else int64."""
    if isinstance(tree, dict):
        return {k: _device_params(v, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_device_params(v, device) for v in tree]
    dtype = (torch.float64 if key in ("w", "head_w") else
             torch.int16 if key == "emb" else torch.int64)
    return torch.from_numpy(np.asarray(tree).astype(np.int64)).to(
        device=device, dtype=dtype)


class IntLMModel:
    """The integer LM on a device, with its codec paths.

    Derive it from a float `LMModel` with `from_lm` (deterministic on any
    host); the derived integer parameters, not the float ones, define the
    lmv=3 bitstream."""

    CODEC_CHUNK = 256

    def __init__(self, cfg: LMConfig, iparams: dict, exps: tuple,
                 device: tp.Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.iparams = _device_params(iparams, self.device)
        self.exps = exps

    @classmethod
    def from_lm(cls, lm) -> "IntLMModel":
        """The integer LM of `lm` on `lm.device` (made once per `lm`)."""
        cached = getattr(lm, "_int_model", None)
        if cached is not None:
            return cached
        iparams, exps = quantize_lm_params(lm.params, lm.cfg)
        m = cls(lm.cfg, iparams, exps, lm.device)
        lm._int_model = m
        return m

    @property
    def card(self) -> int:
        return self.cfg.card

    def init_stream(self, batch: int = 1, offset: int = 0) -> ILMStreamState:
        return init_ilm_stream(self.iparams, self.cfg, batch=batch,
                               offset=offset)

    def step(self, indices: Tensor, state: ILMStreamState
             ) -> tp.Tuple[Tensor, ILMStreamState]:
        """`ilm_step`: indices [B, K] -> (cdf rows [B, K, card], state)."""
        return ilm_step(self.iparams, self.exps, indices, state, self.cfg)

    def chunk_forward(self, indices: Tensor, state: ILMStreamState
                      ) -> tp.Tuple[Tensor, ILMStreamState]:
        """`ilm_chunk_forward`: indices [B, K, C] -> (rows [B, C, K, card],
        state)."""
        return ilm_chunk_forward(self.iparams, self.exps, indices, state,
                                 self.cfg)

    def codec_symbol_bounds(self, codes: np.ndarray,
                            chunk: tp.Optional[int] = None):
        """[K, T] codes -> (lows, highs) int64 [T*K] in (t, k) interleave
        order."""
        return self.codec_symbol_bounds_batched([codes], chunk)[0]

    @torch.inference_mode()
    def codec_symbol_bounds_batched(self, codes_list, chunk=None):
        """Coder bounds for S independent code frames `[K, T_s]` (a fresh
        state each), teacher-forced in lockstep through the chunk forward in
        chunks of at most `chunk` tokens (any split gives the same rows);
        finished lanes are fed zeros."""
        S = len(codes_list)
        K = codes_list[0].shape[0]
        Ts = [c.shape[1] for c in codes_list]
        chunk = max(1, min(chunk or self.CODEC_CHUNK, max(Ts)))
        n_chunks = -(-max(Ts) // chunk)
        Tp = n_chunks * chunk
        shifted = np.zeros((S, K, Tp), np.int64)
        symbols = np.zeros((S, K, Tp), np.int64)
        for s, c in enumerate(codes_list):
            shifted[s, :, 1:Ts[s]] = 1 + np.asarray(c)[:, :Ts[s] - 1]
            symbols[s, :, :Ts[s]] = c
        shifted_t = torch.from_numpy(shifted).to(self.device)
        symbols_t = torch.from_numpy(symbols).to(self.device)
        state = self.init_stream(batch=S)
        lows, highs = [], []
        for ci in range(n_chunks):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            cdf, state = self.chunk_forward(shifted_t[:, :, sl], state)
            lo, hi = int_symbol_bounds(cdf, symbols_t[:, :, sl].transpose(1, 2))
            lows.append(lo)
            highs.append(hi)
        lows_h = torch.cat(lows, 1).cpu().numpy()          # [S, Tp, K]
        highs_h = torch.cat(highs, 1).cpu().numpy()
        return [(lows_h[s, :Ts[s]].reshape(-1), highs_h[s, :Ts[s]].reshape(-1))
                for s in range(S)]

    DECODE_GRAPHS = 8      # decode runners (graphs) kept, last used first

    def _decode_graph(self, S: int, K: int, n_bytes: int,
                      n_steps: int) -> "_DecodeGraph":
        """The decode runner for S lanes of K codebooks, cached per (S, K)
        (the `DECODE_GRAPHS` last used) and made anew (a new capture on the
        card) when a decode needs longer streams or more steps than its
        buffers hold; capacities are powers of two."""
        graphs = self.__dict__.setdefault("_decode_graphs", {})
        runner = graphs.pop((S, K), None)
        if (runner is None or runner.data.shape[1] < n_bytes
                or runner.codes.shape[0] < n_steps):
            runner = _DecodeGraph(self, S, K, 1 << (n_bytes - 1).bit_length(),
                                  1 << (n_steps - 1).bit_length())
        graphs[S, K] = runner
        while len(graphs) > self.DECODE_GRAPHS:
            graphs.pop(next(iter(graphs)))
        return runner

    @torch.inference_mode()
    def decode_lockstep(self, datas: tp.Sequence[bytes], K: int,
                        Ts: tp.Sequence[int]) -> np.ndarray:
        """Range-decode S independent streams in lockstep on the model's
        device: the counterpart of JAX's `fused_decode_chunk_exec` and
        `stream.compress._lockstep_decode_int`. The streams go into the
        static buffers of this (S, K)'s `_DecodeGraph`, which runs max(Ts)
        decode steps: each is the integer LM's step for all lanes and one
        `kernels.ac_head_pull` launch, which writes the lanes' symbols into
        `codes[t]`, `1 + symbols` into the feed of step t + 1 and the sticky
        `ok`/`eof` flags, then advances the step counter t, a device tensor
        that every step reads, so the host neither knows t nor reads a
        tensor. On the card the first decode at an (S, K) runs its first
        step eagerly and captures the step as a CUDA graph; every other step
        is a replay of that graph. Lane s is active while t < Ts[s]; it is
        fed zeros from t = Ts[s] on, as the writer padded it. After the
        loop, codes and flags come to the host in one copy. (JAX's
        8192-byte buffer buckets and 256-token chunks only bounded XLA's
        compiles; the port needs neither.)

        Returns codes `[S, K, max(Ts)]` (int64, ragged tails zero). Raises
        EOFError when a stream ended before its symbols did (a bit past
        its end was consumed), then RuntimeError('Binary search failed')
        when a symbol fell outside every interval (a corrupt stream), in
        JAX's order."""
        S, T_max = len(datas), max(Ts)
        runner = self._decode_graph(S, K, max(1, max(len(d) for d in datas)),
                                    T_max)
        runner.reset(datas, Ts)
        runner.run(T_max)
        out = torch.cat([runner.codes[:T_max].reshape(-1),
                         runner.ok.to(torch.int64),
                         runner.eof.to(torch.int64)]).cpu().numpy()
        n = T_max * S * K
        if out[n + S:].any():
            raise EOFError("The stream ended sooner than expected.")
        if not out[n:n + S].all():
            raise RuntimeError("Binary search failed")
        return np.ascontiguousarray(
            np.moveaxis(out[:n].reshape(T_max, S, K), 0, -1))


class _DecodeGraph:
    """One lockstep decode step of S lanes and K codebooks over static
    buffers, so that the step is the same work at the same addresses every
    time: on the card it is captured once as a CUDA graph and replayed, on
    the CPU it runs eagerly.

    Buffers, all updated in place (the head's bias `head_b` [K, card] int32,
    the kernel's operand, is made once): the k/v ring `kc`/`vc` [L, S, W, d]
    int16, the step counter `t` [1] (the decode's step index: the
    positional phase is t * pos_step mod 2^32 and the ring's fill follows
    from it), the feed [S, K], the range decoder's state [S, 5], `data`
    [S, n_bytes], `nbits` and `ts` [S], `codes` [n_steps, S, K] and the
    flags `ok`/`eof` [S].

    The ring: step t writes its keys and values into slot t mod W, and the
    zero-init entry (`init_ilm_stream`) starts in slot W - 1, as if written
    at step -1. So at step t the slots holding the window are j < t and
    j = W - 1 (all of them from t = W - 1 on): `ilm_chunk_forward`'s
    shifted cache with its slots rotated, which the exact integer sums of
    the attention do not see. One graph thus serves every step: the mask
    is computed from the device counter inside the step."""

    def __init__(self, model: "IntLMModel", S: int, K: int, n_bytes: int,
                 n_steps: int):
        from ..stream import device_ac

        cfg, dev = model.cfg, model.device
        self.model, self.K = model, K
        self.head_b = model.iparams["head_b"][:K].to(torch.int32)
        state = model.init_stream(batch=S)
        self.kc0, self.vc0 = state.kcache, state.vcache
        self.kc, self.vc = state.kcache.clone(), state.vcache.clone()
        self.slots = torch.arange(cfg.past_context, device=dev)
        self.seen_now = torch.ones(1, dtype=torch.bool, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.feed = torch.zeros((S, K), dtype=torch.int64, device=dev)
        self.ac0 = device_ac.init_state(S, dev)
        self.ac = self.ac0.clone()
        self.data = torch.zeros((S, n_bytes), dtype=torch.uint8, device=dev)
        self.nbits = torch.zeros(S, dtype=torch.int64, device=dev)
        self.ts = torch.zeros(S, dtype=torch.int64, device=dev)
        self.codes = torch.zeros((n_steps, S, K), dtype=torch.int64,
                                 device=dev)
        self.ok = torch.ones(S, dtype=torch.bool, device=dev)
        self.eof = torch.zeros(S, dtype=torch.bool, device=dev)
        self.acc: tp.Optional[Tensor] = None
        self.graph: tp.Optional["torch.cuda.CUDAGraph"] = None

    def reset(self, datas: tp.Sequence[bytes], Ts: tp.Sequence[int]) -> None:
        """Load S streams of `Ts` steps and return to step 0."""
        S, n_bytes = self.data.shape
        buf = np.zeros((S, n_bytes), np.uint8)
        for s, d in enumerate(datas):
            buf[s, :len(d)] = np.frombuffer(d, np.uint8)
        self.data.copy_(torch.from_numpy(buf))
        self.nbits.copy_(torch.tensor([8 * len(d) for d in datas]))
        self.ts.copy_(torch.tensor(list(Ts)))
        self.kc.copy_(self.kc0)
        self.vc.copy_(self.vc0)
        self.ac.copy_(self.ac0)
        self.t.zero_()
        self.feed.zero_()
        self.ok.fill_(True)
        self.eof.fill_(False)

    def lm(self) -> None:
        """The LM's part of step t: the trunk on the feed over the ring,
        the new keys and values into slot t mod W, and the head's product
        into `acc` [K, S, card] float64."""
        m, W = self.model, self.slots.shape[0]
        lut = m.iparams["lut"]
        phases = (self.t[:, None] * lut["pos_step"][None, :]) & MASK32
        ring = (self.slots < self.t) | (self.slots >= W - 1)
        mask = torch.cat([ring, self.seen_now])[None]           # [1, W + 1]
        x, ks, vs = _trunk(m.iparams, m.exps, self.feed[:, :, None], self.kc,
                           self.vc, phases, mask, m.cfg)
        slot = torch.remainder(self.t, W)
        for li in range(len(ks)):
            self.kc[li].index_copy_(1, slot, ks[li].to(torch.int16))
            self.vc[li].index_copy_(1, slot, vs[li].to(torch.int16))
        self.acc = _head_acc(m.iparams, x, self.K)

    def step(self) -> None:
        """One decode step: `lm`, one `ac_head_pull` (the rows finished
        from `acc` and every lane's K pulls), then t += 1."""
        from ..kernels import ac_head_pull

        self.lm()
        m = self.model
        ac_head_pull(self.ac, self.acc, self.head_b, m.exps[0],
                     m.iparams["lut"]["exp2"], self.data, self.nbits, self.ts,
                     self.t, self.codes, self.feed, self.ok, self.eof)
        self.t += 1

    def run(self, n: int) -> None:
        """`n` decode steps from the current one. On the card: replays of
        the captured step, each counted as one `ac_head_pull` launch; with
        no graph yet, the first step runs eagerly on a side stream (the
        warm-up before a capture) and the step is captured. On the CPU:
        eager steps."""
        from ..kernels import ac_head_pull

        if self.model.device.type != "cuda":
            for _ in range(n):
                self.step()
            return
        if self.graph is None and n > 0:
            main = torch.cuda.current_stream(self.model.device)
            side = torch.cuda.Stream(self.model.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.step()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step()
            self.graph = graph
            n -= 1
        for _ in range(n):
            self.graph.replay()
            ac_head_pull.launches += 1


def codes_checksum(frames_codes: tp.Iterable[np.ndarray]) -> int:
    """CRC32 over frames' [K, T] codes in write order (little-endian u16)
    — the lmv=3 end-to-end integrity field ("cc")."""
    import zlib
    crc = 0
    for codes in frames_codes:
        buf = np.ascontiguousarray(np.asarray(codes), dtype="<u2").tobytes()
        crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF
