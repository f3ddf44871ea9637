"""Plain-form (non-Montgomery) Fq arithmetic on exact matrix products.

The NTT-CRT Montgomery engine (ops/msm_ntt_mul.py) puts the digit
convolution into matrix products of 7-bit planes but keeps the full REDC
pipeline: every multiply costs THREE exact convolutions (t = a*b,
m = t*N' mod R, m*N) plus four carry sweeps.

This module drops Montgomery form entirely.  A 377-bit modular multiply
becomes:

    1. ONE exact digit convolution  t = a * b          (NTT-CRT, as before)
    2. ONE reduction matmul: the high digits of t (rows 47..103) are
       folded with a precomputed matrix  M_red[:, k] = digits(2^(8*(47+k))
       mod N), i.e.  t mod N  =  t_lo  +  M_red @ t_hi  — four 7-bit
       plane [50, 57] x [57, P] matmuls, exact (msm_ntt_mul._plane_dot).
    3. Two carry sweeps.

No REDC, no Montgomery radix, no conversion in or out: values are plain
integers mod N in a redundant band.  Cost is ~1/3 of the Montgomery
engine's convolution work; the device MSM (ops/msm_mxu.py) runs on it.

Representation ("band tensor"):
    [PAD_IN=64, P] int32 digit columns, radix 2^8, little-endian rows;
    rows 51..63 are zero; digits lie in a small redundant band
    (typically [0, ~350], transiently [-2, ~900]); the VALUE is only
    bounded by 2^400 and is reduced mod N by every multiply.

Bound discipline (each op's comment states its exact bound):
    * forward NTT accumulation:  51 * 12288 * band  < 2^31 for band < 3400
    * convolution coefficients reconstructed over the asymmetric CRT
      window [-2^24, p1*p2 - 2^24): positive bound 51 * band_a * band_b
      < 7.8e7 (bands to ~1200 both sides), negative bound -2^24 (signed
      carry digits reach -2, so coefficients can dip slightly negative
      — see _crt)
    * reduction matmul:          57 * 255 * band < 2^31

Role: ark-ff Fq multiplication on the MSM hot path (SURVEY.md §2b ark-ff
row; reference reaches it through ark-ec VariableBaseMSM at the KZG
commit call sites, src/lib.rs:111 -> ark-poly-commit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .field_params import Q_MOD, inv_mod
from .msm_ntt_mul import (
    CONV_OUT,
    DIGITS,
    NTT_LEN,
    PAD_IN,
    PAD_OUT,
    PRIMES,
    _int_digits,
    _interp,
    _mod_p,
    _plane_dot,
    _primitive_root,
    _split6,
)

# rows 0..FOLD_FROM-1 of a double-width product are kept as-is; rows
# FOLD_FROM..PAD_OUT-1 are folded through the reduction matmul.
# FOLD_FROM=47 keeps the kept part < 2^376 < N.
FOLD_FROM = 47
FOLD_ROWS = PAD_OUT - FOLD_FROM  # 57


class PlainConsts:
    """Host-side constant pack for the plain-form engine (numpy)."""

    def __init__(self) -> None:
        q = Q_MOD
        self.v_planes = []  # per prime: (Vh, Vl) int8 [NTT_LEN, PAD_IN]
        self.w_planes = []  # per prime: (Wh, Wl) int8 [PAD_OUT, NTT_LEN]
        for p in PRIMES:
            g = _primitive_root(p)
            w = pow(g, (p - 1) // NTT_LEN, p)
            v = np.zeros((NTT_LEN, PAD_IN), np.int64)
            for i in range(NTT_LEN):
                for j in range(DIGITS + 1):  # +1 row: carry overflow digit
                    v[i, j] = pow(w, i * j, p)
            winv = inv_mod(w, p)
            ninv = inv_mod(NTT_LEN, p)
            wm = np.zeros((PAD_OUT, NTT_LEN), np.int64)
            for k in range(CONV_OUT - 1):
                for i in range(NTT_LEN):
                    wm[k, i] = pow(winv, i * k, p) * ninv % p
            self.v_planes.append(
                ((v >> 7).astype(np.int8), (v & 127).astype(np.int8))
            )
            self.w_planes.append(
                ((wm >> 7).astype(np.int8), (wm & 127).astype(np.int8))
            )
        # CRT: t = t1 + p1 * ((t2 - t1) * inv(p1) mod p2)
        self.crt_c = inv_mod(PRIMES[0] % PRIMES[1], PRIMES[1])

        # reduction matrix: column k = digits of 2^(8*(FOLD_FROM+k)) mod N
        m = np.zeros((DIGITS, FOLD_ROWS), np.int64)
        for k in range(FOLD_ROWS):
            m[:, k] = _int_digits(pow(2, 8 * (FOLD_FROM + k), q), DIGITS)
        self.m_red = ((m >> 7).astype(np.int8), (m & 127).astype(np.int8))

        # big offsets for subtraction (values stay non-negative): digits
        # of 2^18*N and 2^20*N (rows <= 49, digits <= 255).  A multiply
        # output is < ~2^393 (lo < 2^376 plus 57*~900*N from the fold),
        # so 2^18*N covers any subtrahend built from a few mul outputs and
        # 2^20*N covers sums up to < 2^397 (the x3-style combinations).
        self.c18n = _int_digits((q << 18), PAD_IN).reshape(PAD_IN, 1)
        self.c20n = _int_digits((q << 20), PAD_IN).reshape(PAD_IN, 1)
        self.c18n = self.c18n.astype(np.int32)
        self.c20n = self.c20n.astype(np.int32)
        self.one = np.zeros((PAD_IN, 1), np.int32)
        self.one[0, 0] = 1
        # value-fold constants: digits of 2N and the top-digit estimate
        # scale 2^(8*46) / (2N) (fold_val)
        self.c2n = _int_digits(2 * q, PAD_IN).reshape(PAD_IN, 1).astype(
            np.int32)
        self.inv_2n_scaled = float((2.0 ** (8 * 46)) / float(2 * q))

    def as_arrays(self):
        """Flat tuple of jnp arrays for kernel plumbing (stable order):
        [0..3]  Vh1, Vl1, Wh1, Wl1
        [4..7]  Vh2, Vl2, Wh2, Wl2
        [8..9]  Mh, Ml  (reduction planes)
        [10]    c18n   [11] c20n   [12] one   [13] c2n
        """
        out = []
        for i in range(2):
            out += [jnp.asarray(self.v_planes[i][0]),
                    jnp.asarray(self.v_planes[i][1]),
                    jnp.asarray(self.w_planes[i][0]),
                    jnp.asarray(self.w_planes[i][1])]
        out += [jnp.asarray(self.m_red[0]), jnp.asarray(self.m_red[1]),
                jnp.asarray(self.c18n), jnp.asarray(self.c20n),
                jnp.asarray(self.one), jnp.asarray(self.c2n)]
        return tuple(out)


@functools.lru_cache(maxsize=None)
def consts() -> PlainConsts:
    return PlainConsts()


@functools.lru_cache(maxsize=None)
def const_arrays():
    return consts().as_arrays()


# ---------------------------------------------------------------------------
# traceable ops on [rows, P] int32 band tensors
# ---------------------------------------------------------------------------


def carry2(x, rows_out: int):
    """Two signed floor-carry rounds along the digit axis.  Handles
    negative coefficients exactly (arithmetic shift = floor division).
    For |coeff| <= 40M the result digits are in (-2, ~900)."""
    for _ in range(2):
        carry = jax.lax.shift_right_arithmetic(x, 8)
        digit = x - carry * 256
        x = digit + jnp.concatenate(
            [jnp.zeros_like(carry[:1]), carry[:-1]], axis=0)
    if x.shape[0] < rows_out:
        x = jnp.concatenate(
            [x, jnp.zeros((rows_out - x.shape[0],) + x.shape[1:], x.dtype)],
            axis=0)
    return x[:rows_out]


def tr(x, cs):
    """Band tensor [PAD_IN, P] -> per-prime NTT evals ([NTT_LEN, P] x2).

    Accumulation bound: 51 * (p-1) * band ~ 626k * band < 2^31 for
    band < 3400 — every band this engine produces qualifies."""
    xh, xl = _split6(x)
    out = []
    for i, p in enumerate(PRIMES):
        vh, vl = cs[4 * i], cs[4 * i + 1]
        e = (8192 * _plane_dot(vh, xh) + 128 * _plane_dot(vh, xl)
             + 64 * _plane_dot(vl, xh) + _plane_dot(vl, xl))
        out.append(_mod_p(e, p))
    return tuple(out)


def _crt(t1, t2):
    """Exact conv coefficients from the two prime residues, over the
    ASYMMETRIC window [-2^24, p1*p2 - 2^24).

    Convolution coefficients can be slightly NEGATIVE: the signed carry
    sweeps leave digits as low as -2, so a product a_i*b_j sum can dip
    below zero (worst observed bound: -51*4*~1800 ~ -4e5; the window
    allows -1.6e7).  An unsigned reconstruction returned such a
    coefficient as ~+p1*p2, which is exactly how the first MSM-scale
    test failed (one s2 term off by p1*p2 * 2^128).  Positive
    coefficients stay below ~2e7 (bands ~350 at the fixpoint; worst
    transient ~612 on eval-space sums -> 51*612^2 = 1.9e7), far under
    the window top of 7.8e7."""
    c = consts().crt_c
    p1, p2 = PRIMES
    d = _mod_p(t2 - t1 + p2 * 2, p2)
    e = _mod_p(d * c, p2)
    raw = t1 + p1 * e                      # c mod p1*p2, in [0, p1*p2)
    wrap = p1 * p2 - (1 << 24)
    return raw - jnp.where(raw >= wrap, jnp.int32(p1 * p2), 0)


def mul_ee(ea, eb, cs):
    """Multiply from eval form: interp(ea o eb) -> reduce mod N -> band.

    Conv coefficients must be < p1*p2 = 94.39M for CRT exactness: with
    digit bands a,b this is 51*a*b — callers keep max(a)*max(b) < 1.85M.
    Output: band tensor, digits in [0, ~340] (value < ~2^392)."""
    ts = []
    for i, p in enumerate(PRIMES):
        prod = _mod_p(ea[i] * eb[i], p)
        wh, wl = cs[4 * i + 2], cs[4 * i + 3]
        ts.append(_interp(wh, wl, prod, p))
    t = carry2(_crt(ts[0], ts[1]), PAD_OUT)
    # fold rows FOLD_FROM.. through the reduction matmul:
    #   t mod N = t[:FOLD_FROM] + M_red @ t[FOLD_FROM:]
    # bound: 57 * 255 * 900 = 13.1M < 2^31.
    hi = t[FOLD_FROM:]
    hh, hl = _split6(hi)
    mh, ml = cs[8], cs[9]
    red = (8192 * _plane_dot(mh, hh) + 128 * _plane_dot(mh, hl)
           + 64 * _plane_dot(ml, hh) + _plane_dot(ml, hl))
    lo = jnp.concatenate(
        [t[:FOLD_FROM],
         jnp.zeros((DIGITS - FOLD_FROM,) + t.shape[1:], t.dtype)], axis=0)
    return carry2(lo + red, PAD_IN)


def mul_pp(a, b, cs):
    """Band x band -> band (plain modular multiply)."""
    return mul_ee(tr(a, cs), tr(b, cs), cs)


def add_pp(a, b):
    """Band add: one carry round keeps digits < ~600 (band + band)."""
    x = a + b
    carry = jax.lax.shift_right_arithmetic(x, 8)
    digit = x - carry * 256
    return digit + jnp.concatenate(
        [jnp.zeros_like(carry[:1]), carry[:-1]], axis=0)


def sub_pp(a, b, cs, big: bool = False):
    """Band subtract, kept non-negative by adding 2^18*N (or 2^20*N when
    the subtrahend can exceed ~2^395 — e.g. x3-style chained sums).  Two
    signed carry rounds leave digits in (-2, ~350)."""
    off = cs[11] if big else cs[10]
    off = off.reshape((-1,) + (1,) * (a.ndim - 1))
    return carry2(a - b + off, PAD_IN)


def fold_val(x, cs):
    """Value fold: subtract m*2N with m estimated from rows 46..49 in
    f32 (m = max(floor(est)-1, 0) never over-subtracts), then two carry
    rounds.  Input: any band tensor with value < 2^400 (rows <= 49 after
    carries).  Output: value < ~3*2N, digits back in the small band.
    m <= 2^22; m * digit(2N) <= 2^22*255 < 2^31."""
    inv2n = consts().inv_2n_scaled
    shape1 = (1,) * (x.ndim - 1)
    est = (x[49].astype(jnp.float32) * 16777216.0
           + x[48].astype(jnp.float32) * 65536.0
           + x[47].astype(jnp.float32) * 256.0
           + x[46].astype(jnp.float32)) * inv2n
    m = jnp.maximum(jnp.floor(est) - 1.0, 0.0).astype(jnp.int32)
    c2n = cs[13].reshape((-1,) + shape1)
    out = carry2(x - m[None] * c2n, PAD_IN)
    # coefficients after the subtraction reach ~m*255 ~ 6.6e8; two carry
    # rounds leave digits up to ~10k — one more round restores the band
    return carry2(out, PAD_IN)


def eval_scale(e, k: int, p: int):
    """Scale an eval row by a small constant (linear in the transform)."""
    return _mod_p(e * k, p)


def is_zero_cols(x) -> jnp.ndarray:
    """[rows, P] -> [P] bool: True where the column is all-zero digits.
    Only valid for tensors that are exactly zero by construction (e.g.
    infinity markers) — NOT a value-mod-N test."""
    return jnp.all(x == 0, axis=0)


# ---------------------------------------------------------------------------
# host conversions (plain form; reuse the Montgomery module's helpers)
# ---------------------------------------------------------------------------


def ints_to_cols(values) -> np.ndarray:
    """list[int] -> [PAD_IN, N] int32 plain digit columns."""
    from .msm_ntt_mul import ints_to_cols as _mont_cols

    return _mont_cols(values, mont=False)


def cols_to_ints(arr) -> list:
    """[rows, N] digit columns -> canonical ints (any band, any rows)."""
    arr = np.asarray(arr, np.int64)
    out = []
    for i in range(arr.shape[1]):
        v = 0
        for j in range(arr.shape[0] - 1, -1, -1):
            v = (v << 8) + int(arr[j, i])
        out.append(v % Q_MOD)
    return out
