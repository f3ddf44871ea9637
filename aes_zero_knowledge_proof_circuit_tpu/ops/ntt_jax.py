"""Radix-2 NTT over Fr float32 digits — the prover's FFT engine.

A JAX equivalent of ark-poly's radix-2 GeneralEvaluationDomain
(SURVEY.md §2b) and the hot loop of every Marlin round (SURVEY.md §3.2:
"iFFT/FFT over H (~2^20)").

Decimation-in-time over [n, D] f32 digit tensors (ops/field_f32.py): a
static bit-reversal gather, then log2(n) butterfly stages, each one batched
Montgomery multiply (flat graph: digit fma ladder + two full-f32 Toeplitz
matmuls) of n/2 twiddled elements plus modular add/sub.

Twiddle layout: every stage's twiddles are strided subsamples of ONE
[n/2, D] table of omega-powers (stage s uses w_m^j = omega^{(n/m) j}, i.e.
table[:: n >> s]), so an engine holds a single device table per direction,
computed on device by a log-depth scan. The table, the bit-reversal
permutation, and 1/n enter the jitted program as runtime ARGUMENTS, never
as captured constants — at 2^20-2^22 an embedded-constant HLO would be
hundreds of MB, and one compiled program serves every call of a size.

Bit-exact against ops/poly_host.Domain (tests/test_ntt_jax.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .field_f32 import F32Ops, fr_f32, ints_to_digits
from .field_params import R_MOD, inv_mod, root_of_unity


def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int32)


def _twiddle_table(ops: F32Ops, log_n: int, inverse: bool) -> jnp.ndarray:
    """[n/2, D] device table of omega^j (Montgomery digits), j < n/2.

    Computed on device by a log-depth product scan — building 2^21 powers
    host-side in Python bigints costs tens of seconds."""
    from .scan_utils import hillis_scan

    omega = root_of_unity(log_n)
    if inverse:
        omega = inv_mod(omega, R_MOD)
    half = max(1, (1 << log_n) // 2)
    first = jnp.asarray(ints_to_digits(ops, [1]))          # [1, D]
    if half == 1:
        return first
    w = jnp.asarray(ints_to_digits(ops, [omega])[0])
    base = jnp.broadcast_to(w, (half - 1, ops.D)).astype(jnp.float32)
    seq = jnp.concatenate([first, base], axis=0)
    return hillis_scan(ops.mul, seq)


class NTTEngine:
    """One compiled forward+inverse NTT per domain size."""

    def __init__(self, log_n: int, ops: F32Ops | None = None):
        # engines are lru-cached: constructing one under an enclosing jit
        # would bake leaked tracers into the cached twiddle tables
        assert not isinstance(
            jnp.zeros(()), jax.core.Tracer
        ), "NTTEngine must be constructed eagerly, not inside a jit trace"
        self.log_n = log_n
        self.n = 1 << log_n
        self.ops = ops or fr_f32()
        self._perm = jax.device_put(_bitrev_perm(log_n))
        self._fwd_tab = _twiddle_table(self.ops, log_n, False)
        self._inv_tab = _twiddle_table(self.ops, log_n, True)
        self._n_inv = jnp.asarray(
            ints_to_digits(self.ops, [inv_mod(self.n, R_MOD)])[0]
        )
        self._ntt_j = jax.jit(self._core)
        self._intt_j = jax.jit(self._inv_core)

    def _butterfly(self, left, right, tw):
        """One radix-2 stage: (l + r*tw, l - r*tw)."""
        ops = self.ops
        prod = ops.mul(right, tw)
        return ops.add(left, prod), ops.sub(left, prod)

    def _core(self, x: jnp.ndarray, perm: jnp.ndarray,
              table: jnp.ndarray) -> jnp.ndarray:
        d = self.ops.D
        x = x[perm]
        for s in range(1, self.log_n + 1):
            m = 1 << s
            half = m // 2
            stride = self.n >> s
            tw = table[::stride] if stride > 1 else table
            xs = x.reshape(self.n // m, m, d)
            left = xs[:, :half]
            hi, lo = self._butterfly(left, xs[:, half:], tw[None, :, :])
            x = jnp.concatenate([hi, lo], axis=1).reshape(self.n, d)
        return x

    def _inv_core(self, x: jnp.ndarray, perm: jnp.ndarray,
                  table: jnp.ndarray, n_inv: jnp.ndarray) -> jnp.ndarray:
        out = self._core(x, perm, table)
        return self.ops.mul(out, n_inv[None, :])

    def ntt(self, coeffs: jnp.ndarray) -> jnp.ndarray:
        """[n, D] Montgomery digit coeffs -> evaluations (natural order)."""
        return self._ntt_j(coeffs, self._perm, self._fwd_tab)

    def intt(self, evals: jnp.ndarray) -> jnp.ndarray:
        return self._intt_j(evals, self._perm, self._inv_tab, self._n_inv)


@functools.lru_cache(maxsize=None)
def ntt_engine(log_n: int) -> NTTEngine:
    return NTTEngine(log_n)
