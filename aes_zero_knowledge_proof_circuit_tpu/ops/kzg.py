"""KZG10 polynomial commitments over BLS12-377 G1 (MarlinKZG10 semantics).

An equivalent of ark-poly-commit's MarlinKZG10 at the reference's
call sites (SURVEY.md §2b): commit = fixed-base MSM over SRS powers, batched
openings at a point with hiding randomness, pairing check on host
(SURVEY.md §3.4). The MSM backend is pluggable: host Pippenger for tests,
the native or device tiers for real proof sizes.

Hiding commitments (the reference proves in zero-knowledge):
    C = f(tau) G + r(tau) gamma G
    open at z: W = w_f(tau) G + w_r(tau) gamma G,  w_p = (p(X)-p(z))/(X-z)
    check: e(C - v G - r(z) gamma G, H) == e(W, tau H - z H)

Degree bounds (needed for Marlin's g_1/g_2 sumcheck polys) are enforced by
also committing to the shifted polynomial X^(D-d) g via `offset` commits; the
verifier checks shifted_eval == beta^(D-d) * eval.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from .curve_host import (
    AffinePoint,
    g1_generator,
    g1_infinity,
    g2_generator,
)
from .field_params import R_MOD
from .msm_host import msm as _host_msm
from .pairing_host import multi_pairing
from .poly_host import poly_div_linear, poly_eval

MsmFn = Callable[[Sequence[AffinePoint], Sequence[int]], AffinePoint]

HIDING_POWERS = 8  # gamma powers available for hiding randomness polys


@dataclass
class SRS:
    """Universal structured reference string (powers of tau).

    Reference analog: `generate_universal_srs` (src/lib.rs:141). Checkpointable
    to disk via utils/serialize.py (SURVEY.md §5 checkpoint/resume).
    """

    max_degree: int
    powers_g1: List[AffinePoint]          # tau^i G,        i = 0..max_degree
    gamma_powers_g1: List[AffinePoint]    # tau^i gamma G,  i = 0..HIDING_POWERS
    h: AffinePoint                        # H in G2
    tau_h: AffinePoint                    # tau H in G2

    def verifier_part(self) -> "VerifierKey":
        return VerifierKey(
            g=self.powers_g1[0],
            gamma_g=self.gamma_powers_g1[0],
            h=self.h,
            tau_h=self.tau_h,
            max_degree=self.max_degree,
        )


@dataclass
class VerifierKey:
    g: AffinePoint
    gamma_g: AffinePoint
    h: AffinePoint
    tau_h: AffinePoint
    max_degree: int


@dataclass
class Commitment:
    point: AffinePoint


@dataclass
class OpeningProof:
    w: AffinePoint        # combined witness commitment
    rand_eval: int        # combined hiding-poly evaluation at the point


def setup(max_degree: int, rng: _random.Random) -> SRS:
    """Generate the SRS from fresh toxic waste tau, gamma.

    Host-side incremental scalar ladder: P_{i+1} = tau * P_i. Fine for test
    scales; large SRS generation runs in parallel/srs_gen.py and is
    checkpointed.
    """
    tau = rng.randrange(1, R_MOD)
    gamma = rng.randrange(1, R_MOD)
    g = g1_generator()
    powers = [g]
    for _ in range(max_degree):
        powers.append(powers[-1].mul_scalar(tau))
    gamma_g = g.mul_scalar(gamma)
    gamma_powers = [gamma_g]
    for _ in range(HIDING_POWERS):
        gamma_powers.append(gamma_powers[-1].mul_scalar(tau))
    h = g2_generator()
    return SRS(
        max_degree=max_degree,
        powers_g1=powers,
        gamma_powers_g1=gamma_powers,
        h=h,
        tau_h=h.mul_scalar(tau),
    )


def commit(
    srs: SRS,
    coeffs: Sequence[int],
    hiding_bound: Optional[int] = None,
    rng: Optional[_random.Random] = None,
    offset: int = 0,
    msm_fn: MsmFn = _host_msm,
) -> Tuple[Commitment, Optional[List[int]]]:
    """Commit to sum_i coeffs[i] X^(offset+i). Returns (commitment, rand_poly).

    `offset` implements degree-shifted commitments X^(D-d) g without
    materializing the shifted coefficient vector.
    """
    coeffs = [c % R_MOD for c in coeffs]
    assert offset + len(coeffs) - 1 <= srs.max_degree, "degree exceeds SRS"
    point = msm_fn(srs.powers_g1[offset : offset + len(coeffs)], coeffs)
    rand_poly: Optional[List[int]] = None
    if hiding_bound is not None:
        assert rng is not None
        assert hiding_bound + 1 <= HIDING_POWERS
        rand_poly = [rng.randrange(R_MOD) for _ in range(hiding_bound + 1)]
        hid = _host_msm(srs.gamma_powers_g1[: len(rand_poly)], rand_poly)
        point = point.add(hid)
    return Commitment(point), rand_poly


def batch_open(
    srs: SRS,
    polys: Sequence[Tuple[Sequence[int], int, Optional[Sequence[int]]]],
    z: int,
    xi: int,
    msm_fn: MsmFn = _host_msm,
) -> OpeningProof:
    """Open several (coeffs, offset, rand_poly) at the same point z, combined
    with powers of the Fiat-Shamir challenge xi.

    The combined witness is w(X) = (F(X) - F(z))/(X - z) with
    F = sum_i xi^i X^(offset_i) f_i, committed with both G and gamma-G parts.
    """
    # combine coefficient vectors (offsets realized here; offsets are only
    # used for shifted degree-bound polys whose length stays <= D+1)
    max_len = max(off + len(c) for c, off, _ in polys)
    comb = [0] * max_len
    comb_rand = [0] * (HIDING_POWERS + 1)
    xi_pow = 1
    any_rand = False
    for coeffs, off, rand_poly in polys:
        for i, c in enumerate(coeffs):
            comb[off + i] = (comb[off + i] + xi_pow * c) % R_MOD
        if rand_poly is not None:
            any_rand = True
            for i, c in enumerate(rand_poly):
                comb_rand[i] = (comb_rand[i] + xi_pow * c) % R_MOD
        xi_pow = xi_pow * xi % R_MOD
    w_coeffs, _ = poly_div_linear(comb, z)
    w_point = msm_fn(srs.powers_g1[: len(w_coeffs)], w_coeffs) if w_coeffs else g1_infinity()
    rand_eval = 0
    if any_rand:
        wr_coeffs, rand_eval = poly_div_linear(comb_rand, z)
        if wr_coeffs:
            w_point = w_point.add(
                _host_msm(srs.gamma_powers_g1[: len(wr_coeffs)], wr_coeffs)
            )
    return OpeningProof(w=w_point, rand_eval=rand_eval)


def batch_check(
    vk: VerifierKey,
    commitments: Sequence[Commitment],
    z: int,
    values: Sequence[int],
    proof: OpeningProof,
    xi: int,
) -> bool:
    """Verify a batched opening at z: one 2-pairing product check."""
    assert len(commitments) == len(values)
    comb_c = g1_infinity()
    comb_v = 0
    xi_pow = 1
    for c, v in zip(commitments, values):
        comb_c = comb_c.add(c.point.mul_scalar(xi_pow))
        comb_v = (comb_v + xi_pow * v) % R_MOD
        xi_pow = xi_pow * xi % R_MOD
    # A = C' - v' G - r'(z) gamma G
    a = comb_c.add(vk.g.mul_scalar(comb_v).neg())
    if proof.rand_eval:
        a = a.add(vk.gamma_g.mul_scalar(proof.rand_eval).neg())
    # e(A, H) * e(W, zH - tauH) == 1
    z_h_minus_tau_h = vk.h.mul_scalar(z).add(vk.tau_h.neg())
    from .field_host import Fq12

    return multi_pairing([(a, vk.h), (proof.w, z_h_minus_tau_h)]) == Fq12.one()


def open_eval(coeffs: Sequence[int], z: int) -> int:
    return poly_eval(coeffs, z)
