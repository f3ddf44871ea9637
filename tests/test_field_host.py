"""Host field tower tests (oracle layer for all device kernels)."""

import random

from aes_zero_knowledge_proof_circuit_tpu.ops import field_host as fh
from aes_zero_knowledge_proof_circuit_tpu.ops import field_params as fp

rng = random.Random(0)


def rand_fq2():
    return fh.Fq2(rng.randrange(fp.Q_MOD), rng.randrange(fp.Q_MOD))


def rand_fq6():
    return fh.Fq6(rand_fq2(), rand_fq2(), rand_fq2())


def rand_fq12():
    return fh.Fq12(rand_fq6(), rand_fq6())


def test_params_anchor_values():
    assert fp.R_MOD.bit_length() == 253
    assert fp.Q_MOD.bit_length() == 377
    assert (fp.R_MOD - 1) % (1 << 47) == 0


def test_root_of_unity_orders():
    for log_n in (1, 4, 10):
        w = fp.root_of_unity(log_n)
        assert pow(w, 1 << log_n, fp.R_MOD) == 1
        assert pow(w, 1 << (log_n - 1), fp.R_MOD) != 1


def test_fq2_field_axioms():
    a, b, c = rand_fq2(), rand_fq2(), rand_fq2()
    assert (a + b) * c == a * c + b * c
    assert a * b == b * a
    assert a * a.inv() == fh.Fq2.one()
    assert (a * b) * c == a * (b * c)


def test_fq2_sqrt_roundtrip():
    for _ in range(10):
        a = rand_fq2()
        sq = a * a
        s = sq.sqrt()
        assert s is not None
        assert s * s == sq


def test_fq6_field_axioms():
    a, b, c = rand_fq6(), rand_fq6(), rand_fq6()
    assert (a + b) * c == a * c + b * c
    assert a * a.inv() == fh.Fq6.one()
    assert a.mul_by_v() == a * fh.Fq6(fh.Fq2.zero(), fh.Fq2.one(), fh.Fq2.zero())


def test_fq12_field_axioms():
    a, b = rand_fq12(), rand_fq12()
    assert a * a.inv() == fh.Fq12.one()
    assert (a * b) * b.inv() == a
    assert fh.W * fh.W == fh.W2
    # w^6 = XI embedded
    w6 = fh.W.pow(6)
    assert w6 == fh.Fq12.from_fq2(fh.XI)


def test_fq12_conjugate_is_frobenius6():
    a = rand_fq12()
    assert a.pow(fp.Q_MOD**6) == a.conjugate()


def test_montgomery_ctx():
    for ctx in (fp.fr_ctx(), fp.fq_ctx()):
        a = rng.randrange(ctx.modulus)
        assert ctx.from_mont(ctx.to_mont(a)) == a
        # n0' * modulus == -1 mod 2^16
        assert (ctx.n0_prime * ctx.modulus) % (1 << fp.LIMB_BITS) == (
            (1 << fp.LIMB_BITS) - 1
        )
