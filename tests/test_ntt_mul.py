"""NTT-CRT Montgomery multiplier (mul_T) vs the host oracle.

ops/msm_ntt_mul.py re-creates ark-ff Montgomery multiplication with the
digit convolution in exact matrix products of 7-bit planes (length-128
NTTs mod 12289/7681 + CRT); these tests pin it bit-exactly to host
bigint arithmetic, including digit bands produced by chained operations."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_ntt_mul as NM
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD


_mul = jax.jit(NM.mul_T)


def _mul_T(a, b):
    return _mul(a, b, NM.consts().as_arrays())


def test_ntt_mul_matches_host():
    r = random.Random(7)
    vals_a = [0, 1, Q_MOD - 1, 2**376] + [r.randrange(Q_MOD)
                                          for _ in range(28)]
    vals_b = [r.randrange(Q_MOD) for _ in range(32)]
    vals_b[0] = 0
    vals_b[1] = Q_MOD - 1
    a = jnp.asarray(NM.ints_to_cols(vals_a))
    b = jnp.asarray(NM.ints_to_cols(vals_b))
    out = _mul_T(a, b)
    got = NM.cols_to_ints(np.asarray(out))
    assert got == [x * y % Q_MOD for x, y in zip(vals_a, vals_b)]


def test_ntt_mul_chained_band_stable():
    """Outputs feed back as inputs across several rounds (the MSM scan
    kernel chains ~8 muls per point-add)."""
    r = random.Random(11)
    vals = [r.randrange(Q_MOD) for _ in range(16)]
    cur = jnp.asarray(NM.ints_to_cols(vals))
    want = list(vals)
    for _ in range(4):
        # Montgomery rep v*R squares to v^2*R under REDC-mul: plain
        # value squaring when both sides use ints_to/cols_to round-trip
        cur = _mul_T(cur, cur)
        want = [w * w % Q_MOD for w in want]
    got = NM.cols_to_ints(np.asarray(cur))
    assert got == want


def test_ntt_mul_fold_band_inputs():
    """Digits in the fold band ((-2, 320), value < ~6N) multiply
    exactly — the band the scan kernel's adds/subs produce."""
    r = random.Random(13)
    n = 8
    base = NM.ints_to_cols([r.randrange(Q_MOD) for _ in range(n)])
    # push values above N by adding N digit-wise (band-legal), and
    # perturb digit representation with (+256 at row i, -1 carry at
    # row i+1) rewrites that keep the value fixed but stress the band
    q_dig = NM.ints_to_cols([0])  # template shape
    n_dig = np.zeros((NM.PAD_IN, 1), np.int32)
    v = Q_MOD
    for j in range(NM.DIGITS):
        n_dig[j, 0] = v & 0xFF
        v >>= 8
    shifted = base + n_dig           # value + N, digits <= 510 -> carry
    # one manual carry round to bring digits under the 336 band
    carry = shifted >> 8
    shifted = (shifted & 255) + np.concatenate(
        [np.zeros((1, n), np.int32), carry[:-1]], axis=0)
    assert shifted.max() <= NM.DIGIT_BAND
    b = NM.ints_to_cols([r.randrange(Q_MOD) for _ in range(n)])
    out = _mul_T(jnp.asarray(shifted), jnp.asarray(b))
    got = NM.cols_to_ints(np.asarray(out))
    base_vals = NM.cols_to_ints(base)
    b_vals = NM.cols_to_ints(b)
    assert got == [x * y % Q_MOD for x, y in zip(base_vals, b_vals)]


@pytest.mark.parametrize("log_n", [6, 9])
def test_four_step_local_ntt_matches_host(log_n):
    """poly_jax._four_step_local (the chunked big-domain path that fixes
    the 64-byte 2^22 OOM) is bit-exact vs the host radix-2 NTT."""
    from aes_zero_knowledge_proof_circuit_tpu.ops import (
        poly_host,
        poly_jax as P,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
        digits_to_ints,
        fr_f32,
        ints_to_digits,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD

    F = fr_f32()
    r = random.Random(3)
    n = 1 << log_n
    vals = [r.randrange(R_MOD) for _ in range(n)]
    x = jnp.asarray(ints_to_digits(F, vals))
    got_f = digits_to_ints(F, P._four_step_local(log_n, x, inverse=False))
    assert got_f == poly_host.domain(log_n).ntt(vals)
    got_i = digits_to_ints(F, P._four_step_local(log_n, x, inverse=True))
    assert got_i == poly_host.domain(log_n).intt(vals)


def test_four_step_short_input_padded():
    from aes_zero_knowledge_proof_circuit_tpu.ops import (
        poly_host,
        poly_jax as P,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
        digits_to_ints,
        fr_f32,
        ints_to_digits,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD

    F = fr_f32()
    r = random.Random(5)
    vals = [r.randrange(R_MOD) for _ in range(40)]  # < n = 64
    x = jnp.asarray(ints_to_digits(F, vals))
    got = digits_to_ints(F, P._four_step_local(6, x, inverse=False))
    assert got == poly_host.domain(6).ntt(vals)
