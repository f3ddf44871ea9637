"""Float32-digit Montgomery field engine — the prover's device hot path.

A field element is [..., D] float32 of exact 8-bit-weight digits (Fr: D=34,
Fq: D=50 — one spare limb beyond the uint32 engine so Montgomery REDC
contracts strongly; see bounds below). Digits are REDUNDANT (band ~(-2, 260))
and values are REDUNDANT (band [0, ~4.1 N)); all arithmetic is exact because
every float32 intermediate stays far below 2^24.

Why float32 digits:
* flat graphs — no fori_loops, no scatters (both cripple XLA compile times);
* the two constant multiplies inside REDC are single full-f32 matmuls
  against Toeplitz matrices of N' and N;
* NO carry chains and NO conditional subtractions on the hot path.

Invariants (uniform, no per-kernel bound tracking):
* every public op returns fold()-ed digits: value < 4.1 N, digits < 260;
* fold() subtracts m*2N with m = max(0, estimate-1) from a top-4-digit float
  estimate — always >= 0, always < ~4.1 N;
* mul: REDC(T) = (T + ((T N') mod R) N)/R with T < (4.1 N)^2, and since
  N/R < 2^-19 (Fr, R=2^272) / 2^-23 (Fq, R=2^400), the output is < 1.1 N;
* the /R carry-out is recovered from the top three low-half digits (the rest
  contributes < 2^-14) with a round() — exact because the low half is == 0
  mod R by REDC construction.

Exact canonicalization (to_canonical_limbs) happens only at host/kernel
boundaries. Bit-exact against the host oracle in tests/test_field_f32.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import init_jax_compilation_cache
from .field_params import Q_MOD, R_MOD, inv_mod

init_jax_compilation_cache()


class F32Ctx:
    """Montgomery context with the f32 engine's widened limb count."""

    def __init__(self, modulus: int, n_limbs16: int):
        self.modulus = modulus
        self.L = n_limbs16          # 16-bit limbs
        self.D = 2 * n_limbs16      # 8-bit digits
        self.R = 1 << (16 * n_limbs16)
        self.R_mod = self.R % modulus
        self.R2_mod = self.R * self.R % modulus
        self.R_inv = inv_mod(self.R_mod, modulus)
        # N^{-1} mod 2^k needs the generic inverse (inv_mod is Fermat-based
        # and assumes a prime modulus)
        self.nprime = (-pow(modulus, -1, self.R)) % self.R


def _int_to_digits(v: int, n_digits: int) -> np.ndarray:
    out = np.zeros(n_digits, np.float32)
    for i in range(n_digits):
        out[i] = float(v & 0xFF)
        v >>= 8
    assert v == 0, "constant exceeds digit width"
    return out


def _sync1(x) -> None:
    """Dispatch barrier: wait for the program producing x. Used by every
    chunked big-shape path so queued-op output buffers cannot pile up in
    device memory."""
    jax.block_until_ready(x)


def _toeplitz(v: int, in_digits: int, out_digits: int) -> np.ndarray:
    """T[j, k] = digit_{k-j}(v) so (a @ T)[k] = sum_j a[j] digit_{k-j}(v)."""
    d = np.zeros(out_digits, np.float64)
    vv = v
    for i in range(out_digits):
        d[i] = float(vv & 0xFF)
        vv >>= 8
    t = np.zeros((in_digits, out_digits), np.float32)
    for j in range(in_digits):
        for k in range(j, out_digits):
            t[j, k] = d[k - j]
    return t


class F32Ops:
    def __init__(self, ctx: F32Ctx):
        self.ctx = ctx
        self.D = ctx.D
        n_mod = ctx.modulus
        # The engine constants stay HOST numpy arrays on purpose: a numpy
        # constant closed over by a jitted op lowers straight from host
        # memory (a committed jax.Array constant would be fetched back
        # from the device during every lowering), and host values are
        # trivially concrete inside traces, so the lru-cached instances
        # need no ensure_compile_time_eval.
        self.t_nprime = _toeplitz(ctx.nprime, self.D, self.D)
        self.t_n = _toeplitz(n_mod, self.D, 2 * self.D)
        self.mod_digits = _int_to_digits(n_mod, self.D)
        self.two_n = _int_to_digits(2 * n_mod, self.D)
        self.c16n = _int_to_digits(16 * n_mod, self.D)
        self.one_mont = _int_to_digits(ctx.R_mod, self.D)
        self.r2_digits = _int_to_digits(ctx.R2_mod, self.D)
        self.zero = np.zeros((self.D,), np.float32)
        # fold() estimate constant: top-4-digit value / (2N), as float
        self.inv_2n_scaled = float(
            (2.0 ** (8 * (self.D - 4))) / float(2 * n_mod)
        )
        # carry-out weights: top three digits of the low half (j = D-3..D-1)
        w = np.zeros(self.D, np.float32)
        for j in range(self.D - 3, self.D):
            w[j] = float(2.0 ** (8 * (j - self.D)))
        self.carry_w = w
        # mul's conv-ladder graph holds ~20 [n, 2D] temporaries live under
        # XLA's scheduler; above _BIG_SCAN_N rows chunk the row axis to
        # bound that peak.
        self._mul_j = jax.jit(self.mul)
        self.mul = self._mul_sized
        self.add = jax.jit(self.add)
        self.sub = jax.jit(self.sub)
        self.neg = jax.jit(self.neg)
        self.inv = jax.jit(self.inv)
        # one dispatch instead of ~3 log n (hillis levels + Fermat pow);
        # lengths above _BIG_SCAN_N run the chunked path (bounded scan
        # graphs — see poly_jax.BIG_SCAN_N)
        self._batch_inv_j = jax.jit(self.batch_inv)
        self._prefix_mul_j = jax.jit(self._prefix_mul)
        self._suffix_mul_j = jax.jit(self._suffix_mul)
        self.batch_inv = self._batch_inv_sized
        self.to_canonical_limbs = jax.jit(self.to_canonical_limbs)
        self.from_limb16 = jax.jit(self.from_limb16)
        self.is_zero = jax.jit(self.is_zero)

    # -- digit plumbing ----------------------------------------------------

    def _norm(self, cols: jnp.ndarray, rounds: int = 2) -> jnp.ndarray:
        """Bound digit magnitudes (floor-carry rounds; handles negatives)."""
        for _ in range(rounds):
            carry = jnp.floor(cols * (1.0 / 256.0))
            digit = cols - carry * 256.0
            cols = digit + jnp.concatenate(
                [jnp.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1
            )
        return cols

    def _fold(self, x: jnp.ndarray) -> jnp.ndarray:
        """Subtract m*2N (m from a top-4-digit underestimate, minus one for
        safety; the estimate can lag floor(v/2N) by up to 2) -> value in
        [0, 6N), digits ~(-2, 260). All ops are closed over value < 6N."""
        d = x
        est = (
            d[..., -1] * 16777216.0
            + d[..., -2] * 65536.0
            + d[..., -3] * 256.0
            + d[..., -4]
        ) * self.inv_2n_scaled
        m = jnp.maximum(jnp.floor(est) - 1.0, 0.0)
        out = x - m[..., None] * self.two_n
        return self._norm(out, rounds=2)

    # -- core ops ----------------------------------------------------------

    def mul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        D = self.D
        a, b = jnp.broadcast_arrays(a, b)
        pad = [(0, 0)] * (a.ndim - 1)
        t = jnp.zeros(a.shape[:-1] + (2 * D,), jnp.float32)
        for j in range(D):
            t = t + jnp.pad(a * b[..., j : j + 1], pad + [(j, D - j)])
        t = self._norm(t)
        # precision=HIGHEST: every product and partial sum here is an
        # integer below 2^24, exact only in full f32. A reduced-precision
        # matmul (TF32 keeps ~10 mantissa bits; bf16 passes fewer) rounds
        # digits >= 257 (the redundant band reaches ~290 pre-norm) and
        # silently corrupts REDC.
        m = jnp.dot(t[..., :D], self.t_nprime,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        m = self._norm(m)
        # keep m in [0, R): digits mod 256 only matter up to position D-1;
        # norm may push a carry into higher... trim to D digits is mod R.
        mn = jnp.dot(m, self.t_n, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        v = self._norm(t + mn)
        carry = jnp.round(jnp.sum(v[..., :D] * self.carry_w, axis=-1))
        hi = v[..., D:]
        hi = jnp.concatenate(
            [hi[..., :1] + carry[..., None], hi[..., 1:]], axis=-1
        )
        return self._fold(self._norm(hi))

    def add(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return self._fold(a + b)

    def sub(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """a - b + 16N (b < 4.1 N so strictly positive), folded."""
        return self._fold(a - b + self.c16n)

    def neg(self, a: jnp.ndarray) -> jnp.ndarray:
        return self._fold(self.c16n - a)

    def square(self, a: jnp.ndarray) -> jnp.ndarray:
        return self.mul(a, a)

    def pow_int_loop(self, a: jnp.ndarray, e: int) -> jnp.ndarray:
        nbits = e.bit_length()
        bits = jnp.asarray(
            [(e >> (nbits - 1 - i)) & 1 for i in range(nbits)], jnp.float32
        )
        one = jnp.broadcast_to(self.one_mont, a.shape).astype(jnp.float32)

        def body(i, acc):
            acc = self.mul(acc, acc)
            return jnp.where(bits[i] == 1.0, self.mul(acc, a), acc)

        return jax.lax.fori_loop(0, nbits, body, one)

    def inv(self, a: jnp.ndarray) -> jnp.ndarray:
        """Fermat inverse (zeros map to zero only in canonical-zero digit
        form; callers guard zero if needed)."""
        return self.pow_int_loop(a, self.ctx.modulus - 2)

    def batch_inv(self, a: jnp.ndarray) -> jnp.ndarray:
        from .scan_utils import hillis_scan

        is_zero = self.is_zero(a)
        one = jnp.broadcast_to(self.one_mont, a.shape).astype(jnp.float32)
        safe = jnp.where(is_zero[..., None], one, a)
        prefix = hillis_scan(self.mul, safe)
        suffix = hillis_scan(self.mul, safe, reverse=True)
        total_inv = self.inv(prefix[-1])
        p_shift = jnp.concatenate([one[:1], prefix[:-1]], axis=0)
        s_shift = jnp.concatenate([suffix[1:], one[:1]], axis=0)
        out = self.mul(self.mul(p_shift, s_shift), total_inv)
        return jnp.where(is_zero[..., None], 0.0, out)

    def _mul_sized(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Montgomery mul with the row axis chunked above _BIG_SCAN_N
        (works both eagerly and under trace — shapes are static)."""
        C = self._BIG_SCAN_N
        na = getattr(a, "ndim", 0)
        nb = getattr(b, "ndim", 0)
        if na == 2 and a.shape[0] > C and (
                nb < 2 or b.shape[0] in (1, a.shape[0])):
            outs = []
            for c0 in range(0, a.shape[0], C):
                bb = b if nb < 2 or b.shape[0] == 1 else b[c0 : c0 + C]
                outs.append(self._mul_j(a[c0 : c0 + C], bb))
                _sync1(outs[-1])
            return jnp.concatenate(outs)
        if nb == 2 and b.shape[0] > C and (na < 2 or a.shape[0] == 1):
            return self._mul_sized(b, a)
        return self._mul_j(a, b)

    def _prefix_mul(self, a: jnp.ndarray) -> jnp.ndarray:
        from .scan_utils import hillis_scan

        return hillis_scan(self.mul, a)

    def _suffix_mul(self, a: jnp.ndarray) -> jnp.ndarray:
        from .scan_utils import hillis_scan

        return hillis_scan(self.mul, a, reverse=True)

    _BIG_SCAN_N = 1 << 19

    def _batch_inv_sized(self, a: jnp.ndarray):
        """batch_inv dispatch: single fused program below _BIG_SCAN_N,
        chunked two-pass Montgomery trick above it. The chunked path does
        NOT special-case zeros (its only callers invert challenge-offset
        denominators, zero with probability ~2^-253; a zero would yield a
        wrong proof the verifier rejects, not a panic)."""
        n = a.shape[0]
        C = self._BIG_SCAN_N
        if n <= C or a.ndim != 2:
            return self._batch_inv_j(a)
        one = jnp.broadcast_to(self.one_mont, (1, self.D)).astype(
            jnp.float32)
        pres = []
        for c0 in range(0, n, C):
            pres.append(self._prefix_mul_j(a[c0 : c0 + C]))
            _sync1(pres[-1])
        sufs = []
        for c0 in range(0, n, C):
            sufs.append(self._suffix_mul_j(a[c0 : c0 + C]))
            _sync1(sufs[-1])
        k = len(pres)
        offs = [one[0]]
        for i in range(1, k):
            offs.append(self.mul(offs[-1], pres[i - 1][-1]))
        soffs = [one[0]] * k
        for i in range(k - 2, -1, -1):
            soffs[i] = self.mul(soffs[i + 1], sufs[i + 1][0])
        total = self.mul(offs[-1], pres[-1][-1])
        tinv = self.inv(total)
        p_full = jnp.concatenate(
            [pres[0]] + [self.mul(pres[i], offs[i][None, :])
                         for i in range(1, k)])
        s_full = jnp.concatenate(
            [self.mul(sufs[i], soffs[i][None, :]) for i in range(k - 1)]
            + [sufs[-1]])
        p_shift = jnp.concatenate([one, p_full[:-1]], axis=0)
        s_shift = jnp.concatenate([s_full[1:], one], axis=0)
        return self.mul(self.mul(p_shift, s_shift), tinv[None, :])

    def is_zero(self, a: jnp.ndarray) -> jnp.ndarray:
        """Value == 0 (mod N) for fold-range inputs (< 6N): canonicalize
        the digits once and compare against the k*N patterns, k = 0..6."""
        e = self._exact_signed(a)[..., : self.D]
        hit = jnp.zeros(e.shape[:-1], bool)
        for k in range(7):
            kn = jnp.asarray(_int_to_digits(k * self.ctx.modulus, self.D))
            hit = jnp.logical_or(hit, jnp.all(e == kn, axis=-1))
        return hit

    def select(self, cond, a, b):
        return jnp.where(cond[..., None], a, b).astype(jnp.float32)

    # -- boundaries --------------------------------------------------------

    def _exact_signed(self, a: jnp.ndarray) -> jnp.ndarray:
        """Full carry resolution over D+1 digits (two's-complement style):
        digits 0..D-1 land in [0, 256); the extra top digit is 0 for
        non-negative values (all values here are < 2^(8D-8)) and 255 for
        negatives in (-2^(8D), 0) — floor-carry wraps mod 2^(8(D+1))."""
        pad = [(0, 0)] * (a.ndim - 1) + [(0, 1)]
        return self._norm(jnp.pad(a, pad), rounds=self.D + 1)

    def to_canonical_limbs(self, a: jnp.ndarray) -> jnp.ndarray:
        """Redundant digits -> canonical uint32 16-bit limbs in [0, N)."""
        d = self._exact_signed(a)[..., : self.D]
        for _ in range(6):  # value < 6N -> at most 6 subtractions
            e = self._exact_signed(d - self.mod_digits)
            ge = e[..., -1] < 128.0  # wrapped sign: 0 = nonneg, 255 = neg
            d = jnp.where(ge[..., None], e[..., : self.D], d)
        u = d.astype(jnp.int32).astype(jnp.uint32)
        return u[..., 0::2] | (u[..., 1::2] << jnp.uint32(8))

    def from_limb16(self, limbs: jnp.ndarray) -> jnp.ndarray:
        """uint32 16-bit limbs (canonical, possibly fewer than L) -> digits."""
        lo = (limbs & jnp.uint32(0xFF)).astype(jnp.float32)
        hi = ((limbs >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32)
        d = jnp.stack([lo, hi], axis=-1).reshape(limbs.shape[:-1] + (-1,))
        short = d.shape[-1]
        if short < self.D:
            d = jnp.pad(d, [(0, 0)] * (d.ndim - 1) + [(0, self.D - short)])
        return d


FR_F32_LIMBS = 17   # 272-bit R: N/R ~ 2^-19.6 -> strong REDC contraction
FQ_F32_LIMBS = 25   # 400-bit R: N/R ~ 2^-23.5


@functools.lru_cache(maxsize=None)
def fr_f32() -> F32Ops:
    return F32Ops(F32Ctx(R_MOD, FR_F32_LIMBS))


@functools.lru_cache(maxsize=None)
def fq_f32() -> F32Ops:
    return F32Ops(F32Ctx(Q_MOD, FQ_F32_LIMBS))


# -- host conversion helpers ------------------------------------------------


def ints_to_digits(ops: F32Ops, values, mont: bool = True) -> np.ndarray:
    ctx = ops.ctx
    out = np.zeros((len(values), ctx.D), np.float32)
    for i, v in enumerate(values):
        v = int(v) % ctx.modulus
        if mont:
            v = v * ctx.R_mod % ctx.modulus
        for j in range(ctx.D):
            out[i, j] = float(v & 0xFF)
            v >>= 8
    return out


def digits_to_ints(ops: F32Ops, arr, mont: bool = True):
    limbs16 = np.asarray(ops.to_canonical_limbs(jnp.asarray(arr)))
    flat = limbs16.reshape(-1, limbs16.shape[-1])
    ctx = ops.ctx
    out = []
    for row in flat:
        v = 0
        for j in range(len(row) - 1, -1, -1):
            v = (v << 16) | int(row[j])
        if mont:
            v = v * ctx.R_inv % ctx.modulus
        out.append(v)
    return out
