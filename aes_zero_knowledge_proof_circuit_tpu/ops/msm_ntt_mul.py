"""Fq Montgomery multiplication via small-prime NTTs as matrix products
of 7-bit planes.

A 377-bit product is an acyclic convolution of 8-bit digit vectors
(conv length 99 < 128), evaluated with length-128 NTTs over TWO small
primes and reconstructed by CRT:

    p1 = 12289, p2 = 7681        (both ≡ 1 mod 128 → 128th roots exist)
    t mod p   = W_p @ ((V_p @ a) ∘ (V_p @ b))       -- two plane matmuls/side
    t         = CRT(t mod p1, t mod p2)             (t < 51·319² ≪ p1·p2)

Matrices and data are split into 7-bit planes (x = 128·hi + lo, both
planes fit int8), so every plane product is exact (see _plane_dot); the
recombined accumulation stays ≤ 2.1e8 < 2^31 in int32. Montgomery REDC
(mul_T) reuses the pipeline with the transforms of the CONSTANTS N' and N
precomputed, so a full mul = 16 forward-plane matmuls + 24
interpolation-plane matmuls of shape [128, 64] @ [64, P] plus int32 glue
(carry rounds, mod-p reductions, CRT).

Layout is [digit, P] with the batch on the last (wide) axis. Values are
int32 digit columns in the same redundant band discipline as field_f32
(digits normalized to < 320 before each mul — the 7-bit data planes
accept hi ≤ 4; values folded below ~6N). Montgomery radix matches
field_f32 (R = 2^400).

The plain-form MSM engine (ops/mxu_field.py) builds on this module's
transform helpers (_plane_dot, _fwd, _interp, _mod_p, _split6); mul_T is the
Montgomery reference the tests pin to host bigints.

Role: ark-ff Montgomery multiplication (SURVEY.md §2b ark-ff row).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .field_params import Q_MOD, inv_mod

# engine geometry — shared with field_f32's Fq instance (R = 2^400)
DIGITS = 50              # 8-bit digits per operand
CONV_OUT = 2 * DIGITS    # conv coefficients 0..98; padded rows
NTT_LEN = 128
PAD_IN = 64              # operand rows padded for the plane contraction
PAD_OUT = 104            # conv output rows (99 -> multiple of 8)
PRIMES = (12289, 7681)   # both ≡ 1 (mod 128); p1*p2 = 94_391_809
R_BITS = 8 * DIGITS
R_INT = 1 << R_BITS

# digit-band contract: mul operands must have digits in [0, DIGIT_BAND]
# (the 7-bit plane split d = 64*hi + lo requires hi <= 4 for the int32
# accumulation bound; see _fwd)
DIGIT_BAND = 319


def _primitive_root(p: int) -> int:
    fac = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            fac.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fac.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in fac):
            return g
    raise ValueError("no primitive root")


def _int_digits(v: int, n: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = v & 0xFF
        v >>= 8
    assert v == 0
    return out


class NttMulConsts:
    """Host-side constant pack (numpy; passed into kernels as inputs)."""

    def __init__(self):
        q = Q_MOD
        self.nprime = (-pow(q, -1, R_INT)) % R_INT
        n_dig = _int_digits(q, DIGITS)
        np_dig = _int_digits(self.nprime, DIGITS)

        self.v_planes = []   # per prime: (Vh, Vl) int8 [NTT_LEN, PAD_IN]
        self.w_planes = []   # per prime: (Wh, Wl) int8 [PAD_OUT, NTT_LEN]
        self.e_nprime = []   # per prime: [NTT_LEN, 1] int32 (transform)
        self.e_n = []        # per prime: [NTT_LEN, 1] int32
        for p in PRIMES:
            g = _primitive_root(p)
            w = pow(g, (p - 1) // NTT_LEN, p)
            v = np.zeros((NTT_LEN, PAD_IN), np.int64)
            for i in range(NTT_LEN):
                for j in range(DIGITS + 1):   # +1 row: carry overflow digit
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

            def transform(digits: np.ndarray) -> np.ndarray:
                e = np.zeros(NTT_LEN, np.int64)
                for i in range(NTT_LEN):
                    acc = 0
                    for j, d in enumerate(digits):
                        acc += int(d) * pow(w, i * j, p)
                    e[i] = acc % p
                return e.reshape(NTT_LEN, 1).astype(np.int32)

            self.e_nprime.append(transform(np_dig))
            self.e_n.append(transform(n_dig))

        # CRT: t = t1 + p1 * ((t2 - t1) * inv(p1) mod p2)
        self.crt_c = inv_mod(PRIMES[0] % PRIMES[1], PRIMES[1])

        # band constants (int32 digit columns [DIGITS, 1])
        self.n_dig = n_dig.reshape(DIGITS, 1).astype(np.int32)
        self.two_n = _int_digits(2 * q, DIGITS).reshape(DIGITS, 1).astype(
            np.int32)
        self.c16n = _int_digits(16 * q, DIGITS).reshape(DIGITS, 1).astype(
            np.int32)
        self.inv_2n_scaled = float((2.0 ** (8 * (DIGITS - 4))) / float(2 * q))
        # carry-out weights: top three digits of the REDC low half
        wgt = np.zeros((DIGITS, 1), np.float32)
        for j in range(DIGITS - 3, DIGITS):
            wgt[j, 0] = float(2.0 ** (8 * (j - DIGITS)))
        self.carry_w = wgt

    def as_arrays(self):
        """Flat tuple of jnp arrays for kernel plumbing (stable order)."""
        out = []
        for i in range(2):
            out += [jnp.asarray(self.v_planes[i][0]),
                    jnp.asarray(self.v_planes[i][1]),
                    jnp.asarray(self.w_planes[i][0]),
                    jnp.asarray(self.w_planes[i][1]),
                    jnp.asarray(self.e_nprime[i]),
                    jnp.asarray(self.e_n[i])]
        out += [jnp.asarray(self.n_dig), jnp.asarray(self.two_n),
                jnp.asarray(self.c16n), jnp.asarray(self.carry_w)]
        return tuple(out)


@functools.lru_cache(maxsize=None)
def consts() -> NttMulConsts:
    return NttMulConsts()


# ---------------------------------------------------------------------------
# traceable math on [rows, P] int32 values
# ---------------------------------------------------------------------------


def _plane_dot(m, x):
    """[r, k] int8 @ [k, P] int8 -> [r, P] int32, exactly.

    Computed as a full-f32 product (Precision.HIGHEST): every operand is
    a 7-bit plane (|v| <= 127) and k <= 128, so each sum is an integer
    below 128 * 127^2 < 2^21 and f32 holds it exactly. An int8 x int8 ->
    int32 dot_general is not safe here on the H100: XLA's autotuned
    Triton GEMM returns wrong sums for the [50, 57] @ [57, 2^14]
    reduction product of ops/mxu_field.mul_ee (PERF.md, PR 1)."""
    out = jax.lax.dot_general(
        m.astype(jnp.float32), x.astype(jnp.float32),
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out.astype(jnp.int32)


def _mod_p(x, p: int):
    """x mod p for 0 <= x < ~2.2e8 (quotient via f32 reciprocal; the f32
    rounding of x and of the product keeps |q_err| <= 2 -> two correction
    rounds each side)."""
    q = (x.astype(jnp.float32) * (1.0 / p)).astype(jnp.int32)
    r = x - q * p
    r = jnp.where(r < 0, r + p, r)
    r = jnp.where(r < 0, r + p, r)
    r = jnp.where(r >= p, r - p, r)
    r = jnp.where(r >= p, r - p, r)
    return r


def _split7(x):
    """x in [0, 2^14) -> (hi, lo) int8 planes with x = 128*hi + lo."""
    hi = jax.lax.shift_right_logical(x, 7)
    lo = jnp.bitwise_and(x, 127)
    return hi.astype(jnp.int8), lo.astype(jnp.int8)


def _split6(x):
    """digit in (-2, 336) -> (hi, lo) int8 planes with x = 64*hi + lo.

    Arithmetic shift + mask is an exact decomposition for negatives too
    (-1 -> hi=-1, lo=63), so the fold band's slightly-negative digits
    need no special casing."""
    hi = jax.lax.shift_right_arithmetic(x, 6)
    lo = jnp.bitwise_and(x, 63)
    return hi.astype(jnp.int8), lo.astype(jnp.int8)


def _fwd(vh, vl, ah, al, p: int):
    """Length-128 NTT mod p of digit planes (7-bit V planes, 6-bit data
    planes): E = (128 Vh + Vl) @ (64 Ah + Al) mod p. Max accumulation
    8192*51*96*4 + ... ~ 2.1e8 < 2^31."""
    e = (8192 * _plane_dot(vh, ah) + 128 * _plane_dot(vh, al)
         + 64 * _plane_dot(vl, ah) + _plane_dot(vl, al))
    return _mod_p(e, p)


def _interp(wh, wl, e, p: int):
    """Inverse transform: T = (128 Wh + Wl) @ e mod p with e in [0, p).
    Partial matmuls stay < 1.2e6; they are reduced mod p BEFORE the
    16384x recombination (which would overflow int32 otherwise)."""
    eh, el = _split7(e)
    x1 = _mod_p(_plane_dot(wh, eh), p)
    x2 = _mod_p(_plane_dot(wh, el) + _plane_dot(wl, eh), p)
    x3 = _mod_p(_plane_dot(wl, el), p)
    return _mod_p(16384 * x1 + 128 * x2 + x3, p)


def _carry2(x, rows_out: int):
    """Two floor-carry rounds along the digit axis (axis 0): coefficients
    <= 5.2e6 -> digits in [0, 319] (round 1 leaves carry <= ~20k, round 2
    carry <= ~80 -> digit <= 255 + 80). Output truncated/padded to
    rows_out rows."""
    for _ in range(2):
        carry = jax.lax.shift_right_logical(x, 8)
        digit = jnp.bitwise_and(x, 255)
        x = digit + jnp.concatenate(
            [jnp.zeros_like(carry[:1]), carry[:-1]], axis=0)
    if x.shape[0] < rows_out:
        x = jnp.concatenate(
            [x, jnp.zeros((rows_out - x.shape[0],) + x.shape[1:], x.dtype)],
            axis=0)
    return x[:rows_out]


def _conv_modp(a_dig, b_planes, cs, prime_idx: int):
    """One prime channel of conv(a, b): b may be pre-transformed
    (b_planes = eval row [NTT_LEN, P] int32) or digit planes."""
    p = PRIMES[prime_idx]
    vh, vl = cs[6 * prime_idx], cs[6 * prime_idx + 1]
    ah, al = _split6(a_dig)
    ea = _fwd(vh, vl, ah, al, p)
    eb = b_planes[prime_idx]
    prod = _mod_p(ea * eb, p)
    wh, wl = cs[6 * prime_idx + 2], cs[6 * prime_idx + 3]
    return _interp(wh, wl, prod, p)


def _crt(t1, t2):
    """Exact conv coefficients from the two prime residues (< p1*p2)."""
    c = consts().crt_c
    p1, p2 = PRIMES
    d = _mod_p(t2 - t1 + p2 * 2, p2)
    e = _mod_p(d * c, p2)
    return t1 + p1 * e


def fwd_planes(x_dig, cs):
    """Both prime-channel transforms of a digit tensor [PAD_IN, P] with
    digits in [0, DIGIT_BAND] — the cacheable half of a product."""
    out = []
    for i, p in enumerate(PRIMES):
        vh, vl = cs[6 * i], cs[6 * i + 1]
        xh, xl = _split6(x_dig)
        out.append(_fwd(vh, vl, xh, xl, p))
    return tuple(out)


def _conv(a_dig, eb_planes, cs):
    """Exact digit convolution a * b via NTT-CRT; a as digits, b as its
    two eval rows. Returns [PAD_OUT, P] coefficients (< 5.2e6)."""
    t1 = _conv_modp(a_dig, eb_planes, cs, 0)
    t2 = _conv_modp(a_dig, eb_planes, cs, 1)
    return _crt(t1, t2)


def mul_T(a, b, cs):
    """Montgomery product on [PAD_IN, P] int32 digit columns (digits in
    [0, DIGIT_BAND], value < ~4.2 N). Returns same form, value < 1.1 N.

    REDC: t = a*b;  m = (t mod R) * N' mod R;  out = (t + m*N) / R.
    The two constant products reuse precomputed transforms E[N'], E[N].
    """
    eb = fwd_planes(b, cs)
    t = _conv(a, eb, cs)                      # [PAD_OUT, P] coeffs of a*b
    t_dig = _carry2(t, PAD_OUT)               # digits [0, 319]

    t_lo = jnp.concatenate(
        [t_dig[:DIGITS],
         jnp.zeros((PAD_IN - DIGITS,) + t.shape[1:], t.dtype)], axis=0)
    e_np = (cs[4], cs[10])                    # E[N'] per prime
    m = _crt(_conv_modp(t_lo, e_np, cs, 0),
             _conv_modp(t_lo, e_np, cs, 1))
    m_dig = _carry2(m, PAD_IN)                # digits of m (mod R: low 50)
    m_dig = jnp.concatenate(
        [m_dig[:DIGITS],
         jnp.zeros((PAD_IN - DIGITS,) + m.shape[1:], m.dtype)], axis=0)

    e_n = (cs[5], cs[11])                     # E[N] per prime
    mn = _crt(_conv_modp(m_dig, e_n, cs, 0),
              _conv_modp(m_dig, e_n, cs, 1))

    v = _carry2(t_dig + _carry2(mn, PAD_OUT), PAD_OUT)
    # carry out of the low half: low 50 digits of the VALUE are 0 mod R;
    # recover the integer carry from the top three low-half digits (the
    # rest contribute < 2^-14) — same proven trick as field_f32.mul.
    carry_w = cs[15]
    carry = jnp.round(
        jnp.sum(v[:DIGITS].astype(jnp.float32) * carry_w, axis=0,
                keepdims=True)).astype(jnp.int32)
    hi = v[DIGITS:]
    hi = jnp.concatenate([hi[:1] + carry, hi[1:]], axis=0)
    out = jnp.concatenate(
        [hi, jnp.zeros((PAD_IN - hi.shape[0],) + hi.shape[1:], hi.dtype)],
        axis=0)
    return _carry2(out, PAD_IN)


# ---------------------------------------------------------------------------
# host conversion
# ---------------------------------------------------------------------------


def ints_to_cols(values, mont: bool = True) -> np.ndarray:
    """list[int] -> [PAD_IN, N] int32 digit columns (Montgomery form)."""
    n = len(values)
    out = np.zeros((PAD_IN, n), np.int32)
    for i, v in enumerate(values):
        v = int(v) % Q_MOD
        if mont:
            v = v * R_INT % Q_MOD
        for j in range(DIGITS):
            out[j, i] = v & 0xFF
            v >>= 8
    return out


def cols_to_ints(arr: np.ndarray, mont: bool = True):
    """[PAD_IN, N] int32 digit columns -> canonical ints."""
    arr = np.asarray(arr, np.int64)
    out = []
    rinv = inv_mod(R_INT % Q_MOD, Q_MOD)
    for i in range(arr.shape[1]):
        v = 0
        for j in range(arr.shape[0] - 1, -1, -1):
            v = (v << 8) + int(arr[j, i])
        v %= Q_MOD
        if mont:
            v = v * rinv % Q_MOD
        out.append(v)
    return out
