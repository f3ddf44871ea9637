"""Host-side optimal ate pairing for BLS12-377.

Used only by the verifier (reference: verify_proof's KZG batch check + 2
pairings, src/lib.rs:130-136 via simpleworks; SURVEY.md §3.4 "pairing check on
host"). ms-to-s scale on host is acceptable; all prover-side heavy math runs
on the device.

e(P, Q) = f_{u,Q}(P) ^ ((q^12 - 1) / r)     (ate pairing, loop count u > 0)

The Miller loop runs over the untwisted Q in E(Fq12) with affine line
functions; the final exponentiation uses the conjugation-based easy part and a
direct power for the hard part (optimizable later with a u-addition chain).
"""

from __future__ import annotations

from .curve_host import FQ12_FIELD, AffinePoint, untwist
from .field_host import Fq12
from .field_params import Q_MOD, U


def _line(r: AffinePoint, s: AffinePoint, p: AffinePoint) -> Fq12:
    """Evaluate the line through R and S (or tangent if R==S) at P.

    All points in E(Fq12). Returns l(P) in Fq12.
    """
    f = FQ12_FIELD
    if r.inf or s.inf:
        # vertical through the finite one
        t = s if r.inf else r
        if t.inf:
            return Fq12.one()
        return f.sub(p.x, t.x)
    if f.is_zero(f.sub(r.x, s.x)):
        if f.is_zero(f.add(r.y, s.y)):
            # vertical line x - x_R
            return f.sub(p.x, r.x)
        # tangent
        num = f.mul(f.scalar(3), f.mul(r.x, r.x))
        den = f.mul(f.scalar(2), r.y)
        lam = f.mul(num, f.inv(den))
    else:
        lam = f.mul(f.sub(s.y, r.y), f.inv(f.sub(s.x, r.x)))
    # l(P) = (yP - yR) - lam (xP - xR)
    return f.sub(f.sub(p.y, r.y), f.mul(lam, f.sub(p.x, r.x)))


def miller_loop(p_g1: AffinePoint, q_g2: AffinePoint) -> Fq12:
    """f_{u,Q}(P) for P in G1(Fq) (embedded), Q in G2 (untwisted)."""
    if p_g1.inf or q_g2.inf:
        return Fq12.one()
    p12 = AffinePoint(
        Fq12.from_fq(p_g1.x), Fq12.from_fq(p_g1.y), FQ12_FIELD, Fq12.from_fq(1)
    )
    q12 = untwist(q_g2)
    f = Fq12.one()
    r = q12
    bits = bin(U)[3:]  # skip leading 1
    for b in bits:
        f = f * f * _line(r, r, p12)
        r = r.double()
        if b == "1":
            f = f * _line(r, q12, p12)
            r = r.add(q12)
    return f


import functools

from .field_host import XI, Fq6


@functools.lru_cache(maxsize=None)
def _frob_coeffs():
    """XI^(i (q-1)/6) for i = 0..5 — Frobenius twist constants on the
    {1, v, v^2, w, wv, wv^2} basis (q = 1 mod 6)."""
    e = (Q_MOD - 1) // 6
    return tuple(XI.pow(e * i) for i in range(6))


def frobenius(f: Fq12) -> Fq12:
    """x -> x^q on Fq12: conjugate every Fq2 coefficient, scale basis
    element i by XI^(i(q-1)/6) with i = m + 2b for w^m v^b."""
    g = _frob_coeffs()
    c0, c1 = f.c0, f.c1
    return Fq12(
        Fq6(
            c0.c0.conjugate(),
            c0.c1.conjugate() * g[2],
            c0.c2.conjugate() * g[4],
        ),
        Fq6(
            c1.c0.conjugate() * g[1],
            c1.c1.conjugate() * g[3],
            c1.c2.conjugate() * g[5],
        ),
    )


def _pow_u(f: Fq12) -> Fq12:
    """f^U with cyclotomic-subgroup inverse-free square-and-multiply."""
    result = Fq12.one()
    base = f
    e = U
    while e:
        if e & 1:
            result = result * base
        base = base.square()
        e >>= 1
    return result


def final_exponentiation(f: Fq12) -> Fq12:
    """Compute f^(3 (q^12-1)/r) — a fixed bilinear non-degenerate pairing
    (the cube of the ate pairing; 3 does not divide r so nothing collapses).

    Uses the BLS12 decomposition (verified against the curve constants):
        3 (q^4-q^2+1)/r = (u-1)^2 (u+q) (u^2+q^2-1) + 3
    after the easy part f <- (f^(q^6-1))^(q^2+1), inside which inversion is
    conjugation. ~500 Fq12 mults instead of a 1255-bit generic pow.
    """
    if f.is_zero():
        raise ZeroDivisionError("final exponentiation of zero")
    # easy part
    f1 = f.conjugate() * f.inv()
    f2 = frobenius(frobenius(f1)) * f1      # ^(q^2 + 1); now cyclotomic
    # hard part: m = f2^((u-1)^2) via two u-1 pows
    fu = _pow_u(f2) * f2.conjugate()        # f2^(u-1)
    fu = _pow_u(fu) * fu.conjugate()        # f2^((u-1)^2)
    # ^(u+q)
    fq = _pow_u(fu) * frobenius(fu)
    # ^(u^2+q^2-1)
    fuu = _pow_u(_pow_u(fq))
    out = fuu * frobenius(frobenius(fq)) * fq.conjugate()
    # * f2^3
    f2sq = f2.square()
    return out * f2sq * f2


def pairing(p_g1: AffinePoint, q_g2: AffinePoint) -> Fq12:
    """Full ate pairing e(P, Q) with P in G1, Q in G2 (twist coords)."""
    if p_g1.inf or q_g2.inf:
        return Fq12.one()
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(pairs) -> Fq12:
    """prod_i e(P_i, Q_i) sharing one final exponentiation."""
    f = Fq12.one()
    for p_g1, q_g2 in pairs:
        if p_g1.inf or q_g2.inf:
            continue
        f = f * miller_loop(p_g1, q_g2)
    if f == Fq12.one():
        return f
    return final_exponentiation(f)
