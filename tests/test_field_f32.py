"""f32-digit field engine vs host bigint oracle (bit-exact)."""

import random

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
    digits_to_ints,
    fq_f32,
    fr_f32,
    ints_to_digits,
)

rng = random.Random(11)


@pytest.mark.parametrize("ops_fn", [fr_f32, fq_f32], ids=["fr", "fq"])
def test_mul_add_sub_neg(ops_fn):
    ops = ops_fn()
    mod = ops.ctx.modulus
    a_int = [0, 1, mod - 1] + [rng.randrange(mod) for _ in range(61)]
    b_int = [mod - 1, 0, 1] + [rng.randrange(mod) for _ in range(61)]
    import jax.numpy as jnp

    a = jnp.asarray(ints_to_digits(ops, a_int))
    b = jnp.asarray(ints_to_digits(ops, b_int))
    got_mul = digits_to_ints(ops, ops.mul(a, b))
    got_add = digits_to_ints(ops, ops.add(a, b))
    got_sub = digits_to_ints(ops, ops.sub(a, b))
    got_neg = digits_to_ints(ops, ops.neg(a))
    for x, y, gm, ga, gs, gn in zip(a_int, b_int, got_mul, got_add, got_sub,
                                    got_neg):
        assert gm == x * y % mod
        assert ga == (x + y) % mod
        assert gs == (x - y) % mod
        assert gn == (-x) % mod


@pytest.mark.parametrize("ops_fn", [fr_f32, fq_f32], ids=["fr", "fq"])
def test_deep_mul_chain(ops_fn):
    """Stress the redundant-band closure: long chains of mixed ops."""
    ops = ops_fn()
    mod = ops.ctx.modulus
    import jax.numpy as jnp

    a_int = [rng.randrange(mod) for _ in range(8)]
    b_int = [rng.randrange(mod) for _ in range(8)]
    a = jnp.asarray(ints_to_digits(ops, a_int))
    b = jnp.asarray(ints_to_digits(ops, b_int))
    ga, gb = list(a_int), list(b_int)
    for i in range(25):
        a, b = ops.mul(a, b), ops.add(ops.sub(a, b), ops.mul(b, b))
        ga, gb = (
            [x * y % mod for x, y in zip(ga, gb)],
            [(x - y + y * y) % mod for x, y in zip(ga, gb)],
        )
    assert digits_to_ints(ops, a) == ga
    assert digits_to_ints(ops, b) == gb


def test_batch_inv_f32():
    ops = fr_f32()
    mod = ops.ctx.modulus
    import jax.numpy as jnp

    vals = [0] + [rng.randrange(1, mod) for _ in range(31)]
    a = jnp.asarray(ints_to_digits(ops, vals))
    got = digits_to_ints(ops, ops.batch_inv(a))
    assert got[0] == 0
    for v, g in zip(vals[1:], got[1:]):
        assert v * g % mod == 1


def test_from_limb16_roundtrip():
    ops = fr_f32()
    mod = ops.ctx.modulus
    import jax.numpy as jnp

    vals = [rng.randrange(mod) for _ in range(10)]
    a = jnp.asarray(ints_to_digits(ops, vals))
    limbs = ops.to_canonical_limbs(a)
    back = ops.from_limb16(limbs)
    assert digits_to_ints(ops, back) == vals


def _f32_dot_precisions(closed):
    """Precision params of every f32 dot_general in a jaxpr, sub-jaxprs
    (jit, scan, cond bodies) included."""
    import jax.extend.core as jex

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if (eqn.primitive.name == "dot_general"
                    and eqn.invars[0].aval.dtype == np.float32):
                found.append(eqn.params["precision"])
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                    if isinstance(sub, jex.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return found


@pytest.mark.parametrize("prog", ["fr_mul", "fq_mul", "ntt", "msm_madd"])
def test_f32_dots_run_at_highest_precision(prog):
    """The REDC matmuls and the MSM's plane products are exact only in
    full f32: a reduced-precision pass (TF32 on a GPU) would corrupt
    products silently, so every f32 dot_general must request
    Precision.HIGHEST."""
    import jax
    import jax.numpy as jnp

    from aes_zero_knowledge_proof_circuit_tpu.ops.ntt_jax import ntt_engine

    if prog == "msm_madd":
        from aes_zero_knowledge_proof_circuit_tpu.ops import msm_mxu, mxu_field

        col = jnp.zeros((64, 4), jnp.int32)
        closed = jax.make_jaxpr(
            lambda a, q: msm_mxu.madd_in(mxu_field.const_arrays(), a, a, a,
                                         q, q, jnp.zeros((1, 4), bool)))(
            col, col)
    elif prog == "ntt":
        eng = ntt_engine(4)
        x = jnp.zeros((16, fr_f32().D), jnp.float32)
        closed = jax.make_jaxpr(eng._core)(x, eng._perm, eng._fwd_tab)
    else:
        ops = fr_f32() if prog == "fr_mul" else fq_f32()
        a = jnp.zeros((8, ops.D), jnp.float32)
        closed = jax.make_jaxpr(ops.mul)(a, a)
    precs = _f32_dot_precisions(closed)
    assert precs, "no f32 dot_general found"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs
