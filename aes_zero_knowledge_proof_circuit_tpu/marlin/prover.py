"""Marlin AHP prover (three rounds + batched KZG openings).

A re-creation of the forked ark-marlin prover at the reference's hot
path (SURVEY.md §3.2: round 1 w/z_A/z_B + mask, round 2 outer sumcheck over H,
round 3 inner sumcheck over K, Fiat-Shamir between rounds, batched openings).
All polynomial arithmetic routes through the poly/NTT layer; the heavy
NTT/MSM calls are backend-pluggable so the same orchestration drives the host
oracle (tests) and the JAX device kernels (production sizes).

Zero-knowledge: witness-carrying polynomials are randomized with vanishing
multiples (bounded independence, one evaluation each) and committed hiding:
    w_hat += r_w(X) * (v_H/v_X)(X);  z_a += r_a(X) v_H(X);  z_b += r_b(X) v_H(X)
plus the masking polynomial s(X) with sum_H s = 0.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..ops import kzg
from ..ops.field_params import R_MOD, inv_mod
from ..ops.poly_host import (
    domain,
    poly_add,
    poly_div_vanishing,
    poly_eval,
    poly_mul,
    poly_scale,
    poly_sub,
    poly_trim,
)
from ..utils.transcript import Transcript
from .indexer import MarlinProvingKey


@dataclass
class MarlinProof:
    """Self-describing proof object (serializable via utils/serialize.py).

    Reference analog: simpleworks::marlin::MarlinProof (SURVEY.md §2b).
    """

    # round commitments
    comm_w: kzg.Commitment
    comm_za: kzg.Commitment
    comm_zb: kzg.Commitment
    comm_s: kzg.Commitment
    comm_t: kzg.Commitment
    comm_g1: kzg.Commitment
    comm_g1_shift: kzg.Commitment
    comm_h1: kzg.Commitment
    comm_g2: List[kzg.Commitment]        # per matrix
    comm_g2_shift: List[kzg.Commitment]  # per matrix
    comm_h2: List[kzg.Commitment]        # per matrix
    sigmas: List[int]                    # per matrix inner-sumcheck sums
    # evaluations at beta1 (H side): w, za, zb, s, t, g1, h1
    evals_beta1: List[int]
    # evaluations at beta2 (K side), per matrix: row, col, val, g2, h2
    evals_beta2: List[List[int]]
    # batched opening proofs
    open_beta1: kzg.OpeningProof
    open_beta2: kzg.OpeningProof


def _batch_inv(values: Sequence[int]) -> List[int]:
    """Montgomery batch inversion (host)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v else 1) % R_MOD
    inv_all = inv_mod(prefix[n], R_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = prefix[i] * inv_all % R_MOD
            inv_all = inv_all * v % R_MOD
    return out


def _instance_poly(pk: MarlinProvingKey, instance: Sequence[int]) -> List[int]:
    """x_hat: interpolation of the (padded) public input over X."""
    xd = domain(pk.log_x)
    padded = list(instance) + [0] * (xd.n - len(instance))
    return xd.intt(padded)


def prove(
    pk: MarlinProvingKey,
    instance: Sequence[int],
    witness: Sequence[int],
    rng: Optional[_random.Random] = None,
    zk: bool = True,
    msm_fn=None,
    ntt4_fn=None,
) -> MarlinProof:
    """msm_fn(points, scalars) and ntt4_fn(values, inverse) are pluggable
    backends for the commit MSMs and the 4n-domain outer-sumcheck NTTs —
    tests inject the host oracle, the multi-chip dry run injects the
    mesh-sharded device programs (parallel/sharded_{msm,ntt}) so one
    orchestration body drives every tier (SURVEY.md §2b parallelism)."""
    rng = rng or _random.Random()
    msm_kwargs = {"msm_fn": msm_fn} if msm_fn else {}
    r1cs = pk.r1cs
    assert len(instance) == r1cs.num_instance and instance[0] == 1
    assert len(witness) == r1cs.num_witness
    z = list(instance) + list(witness)

    n, log_n = pk.n, pk.log_n
    h = domain(log_n)
    h4 = domain(log_n + 2)
    x_size = pk.x_size
    srs = pk.srs
    d_max = srs.max_degree

    t = Transcript()
    pk.vk.absorb_into(t)
    t.absorb_fr_list(b"instance", instance)

    # ---- round 1: w_hat, z_a, z_b, mask s --------------------------------
    za_vals = r1cs.mat_vec(r1cs.a_rows, z) + [0] * (n - r1cs.num_constraints)
    zb_vals = r1cs.mat_vec(r1cs.b_rows, z) + [0] * (n - r1cs.num_constraints)
    za_coeffs = h.intt(za_vals)
    zb_coeffs = h.intt(zb_vals)

    z_slots = [0] * n
    for v_idx, s_idx in enumerate(pk.var_to_slot):
        z_slots[s_idx] = z[v_idx]
    x_poly = _instance_poly(pk, instance)
    x_on_h = h.ntt(x_poly)
    w_vals = [(zv - xv) % R_MOD for zv, xv in zip(z_slots, x_on_h)]
    w_coeffs_full = h.intt(w_vals)
    w_hat, w_rem = poly_div_vanishing(w_coeffs_full, x_size)
    assert not w_rem, "witness poly not divisible by v_X (instance mismatch)"

    if zk:
        # bounded-independence randomization (1 query point each)
        r_w = [rng.randrange(R_MOD) for _ in range(2)]
        r_a = [rng.randrange(R_MOD) for _ in range(2)]
        r_b = [rng.randrange(R_MOD) for _ in range(2)]
        # v_H/v_X = sum_j X^(j*x_size), j = 0..n/x_size - 1
        ratio = [0] * (n - x_size + 1)
        for j in range(0, n // x_size):
            ratio[j * x_size] = 1
        w_hat = poly_add(w_hat, poly_mul(r_w, ratio))
        v_h = [(-1) % R_MOD] + [0] * (n - 1) + [1]
        za_coeffs = poly_add(za_coeffs, poly_mul(r_a, v_h))
        zb_coeffs = poly_add(zb_coeffs, poly_mul(r_b, v_h))
        # mask s of degree 2n with sum_H s = 0
        s_coeffs = [rng.randrange(R_MOD) for _ in range(2 * n + 1)]
        s_coeffs[0] = (-(s_coeffs[n] + s_coeffs[2 * n])) % R_MOD
    else:
        s_coeffs = [0]

    hb = 1 if zk else None
    comm_w, rand_w = kzg.commit(srs, w_hat, hiding_bound=hb, rng=rng, **msm_kwargs)
    comm_za, rand_za = kzg.commit(srs, za_coeffs, hiding_bound=hb, rng=rng, **msm_kwargs)
    comm_zb, rand_zb = kzg.commit(srs, zb_coeffs, hiding_bound=hb, rng=rng, **msm_kwargs)
    comm_s, rand_s = kzg.commit(srs, s_coeffs, hiding_bound=hb, rng=rng, **msm_kwargs)
    for lbl, c in (
        (b"w", comm_w), (b"za", comm_za), (b"zb", comm_zb), (b"s", comm_s)
    ):
        t.absorb_g1(lbl, c.point)

    alpha = t.challenge_fr(b"alpha")
    eta_a = t.challenge_fr(b"eta_a")
    eta_b = t.challenge_fr(b"eta_b")
    eta_c = t.challenge_fr(b"eta_c")

    # ---- round 2: outer sumcheck over H ----------------------------------
    v_h_alpha = h.vanishing_eval(alpha)
    # t(Y): scatter val * v_H(alpha)/(alpha - row_elt) onto column slots
    t_vals = [0] * n
    etas = [eta_a, eta_b, eta_c]
    for eta, m in zip(etas, pk.matrices):
        denoms = _batch_inv([(alpha - re) % R_MOD for re in m.row_evals[: m.nnz]])
        for j in range(m.nnz):
            # int() guard: a jax-indexed pk stores vals as signed np.int64
            # (indexer_jax), and np.int64 * a 253-bit python int overflows
            contrib = int(m.vals[j]) % R_MOD * v_h_alpha % R_MOD * denoms[j] % R_MOD
            t_vals[m.col_slots[j]] = (t_vals[m.col_slots[j]] + eta * contrib) % R_MOD
    t_coeffs = h.intt(t_vals)

    # z poly: w_hat * v_X + x_hat
    w_vx = poly_sub([0] * x_size + w_hat, w_hat)  # w_hat * (X^x - 1)
    z_coeffs = poly_add(w_vx, x_poly)

    # q1 on the 4n grid
    if ntt4_fn is not None:
        pad4 = lambda c: list(c) + [0] * (h4.n - len(c))
        ntt4 = lambda c: ntt4_fn(pad4(c), False)
        intt4 = lambda e: ntt4_fn(list(e), True)
    else:
        ntt4, intt4 = h4.ntt, h4.intt
    s4 = ntt4(s_coeffs)
    za4 = ntt4(za_coeffs)
    zb4 = ntt4(zb_coeffs)
    t4 = ntt4(t_coeffs)
    z4 = ntt4(z_coeffs)
    # r(alpha, x) = (v_H(alpha) - v_H(x)) / (alpha - x) on the 4n grid
    elts4 = h4.elements
    # v_H(x) on H4 cycles with period 4: x^n = (w4n^i)^n = i-th power of 4th root
    wn4 = pow(h4.omega, n, R_MOD)
    vh_cycle = [(pow(wn4, i, R_MOD) - 1) % R_MOD for i in range(4)]
    denom4 = _batch_inv([(alpha - x) % R_MOD for x in elts4])
    q1_4 = []
    for i in range(h4.n):
        r_ax = (v_h_alpha - vh_cycle[i & 3]) % R_MOD * denom4[i] % R_MOD
        p = (eta_a * za4[i] + eta_b * zb4[i] + eta_c * za4[i] * zb4[i]) % R_MOD
        q1_4.append((s4[i] + r_ax * p - t4[i] * z4[i]) % R_MOD)
    q1_coeffs = intt4(q1_4)
    h1_coeffs, rem = poly_div_vanishing(q1_coeffs, n)
    rem = list(rem) + [0] * (n - len(rem))
    assert rem[0] == 0, "outer sumcheck sum nonzero (bad witness or mask)"
    g1_coeffs = poly_trim(rem[1:])
    g1_bound = n - 2  # deg(g1) <= n-2 enforced via shifted commitment
    g1_shift = d_max - g1_bound

    comm_t, _ = kzg.commit(srs, t_coeffs, **msm_kwargs)
    comm_g1, rand_g1 = kzg.commit(srs, g1_coeffs, hiding_bound=hb, rng=rng, **msm_kwargs)
    comm_g1s, rand_g1s = kzg.commit(
        srs, g1_coeffs, hiding_bound=hb, rng=rng, offset=g1_shift, **msm_kwargs
    )
    comm_h1, rand_h1 = kzg.commit(srs, h1_coeffs, hiding_bound=hb, rng=rng, **msm_kwargs)
    for lbl, c in (
        (b"t", comm_t), (b"g1", comm_g1), (b"g1s", comm_g1s), (b"h1", comm_h1)
    ):
        t.absorb_g1(lbl, c.point)

    beta1 = t.challenge_fr(b"beta1")

    # ---- round 3: per-matrix inner sumcheck over K_M ---------------------
    v_h_beta1 = h.vanishing_eval(beta1)
    scale = v_h_alpha * v_h_beta1 % R_MOD
    sigmas: List[int] = []
    g2_list, h2_list = [], []
    comm_g2, comm_g2s, comm_h2 = [], [], []
    g2_shifts: List[int] = []
    for m in pk.matrices:
        kd = domain(m.log_k)
        b_vals = [
            (alpha - re) * (beta1 - ce) % R_MOD
            for re, ce in zip(m.row_evals, m.col_evals)
        ]
        b_inv = _batch_inv(b_vals)
        f_vals = [scale * ve % R_MOD * bi % R_MOD for ve, bi in zip(m.val_evals, b_inv)]
        sigma = sum(f_vals) % R_MOD
        f_coeffs = kd.intt(f_vals)
        assert f_coeffs[0] == sigma * inv_mod(m.k, R_MOD) % R_MOD
        g2 = poly_trim(f_coeffs[1:])
        # h2 = (a - b*f) / v_K with a = scale*val(X), b = (alpha-row)(beta1-col)
        a_coeffs = poly_scale(m.val_coeffs, scale)
        b_coeffs = poly_mul(
            poly_sub([alpha], m.row_coeffs), poly_sub([beta1], m.col_coeffs)
        )
        bf = poly_mul(b_coeffs, f_coeffs)
        h2, h2_rem = poly_div_vanishing(poly_sub(a_coeffs, bf), m.k)
        assert not h2_rem, "inner sumcheck division not exact"
        g2_bound = m.k - 2
        g2_shift = d_max - g2_bound
        g2_shifts.append(g2_shift)
        c_g2, _ = kzg.commit(srs, g2, **msm_kwargs)
        c_g2s, _ = kzg.commit(srs, g2, offset=g2_shift, **msm_kwargs)
        c_h2, _ = kzg.commit(srs, h2, **msm_kwargs)
        sigmas.append(sigma)
        g2_list.append(g2)
        h2_list.append(h2)
        comm_g2.append(c_g2)
        comm_g2s.append(c_g2s)
        comm_h2.append(c_h2)
        t.absorb_fr(b"sigma", sigma)
        t.absorb_g1(b"g2", c_g2.point)
        t.absorb_g1(b"g2s", c_g2s.point)
        t.absorb_g1(b"h2", c_h2.point)

    beta2 = t.challenge_fr(b"beta2")

    # ---- evaluations + batched openings ----------------------------------
    evals_beta1 = [
        poly_eval(w_hat, beta1),
        poly_eval(za_coeffs, beta1),
        poly_eval(zb_coeffs, beta1),
        poly_eval(s_coeffs, beta1),
        poly_eval(t_coeffs, beta1),
        poly_eval(g1_coeffs, beta1),
        poly_eval(h1_coeffs, beta1),
    ]
    evals_beta2 = []
    for m, g2, h2 in zip(pk.matrices, g2_list, h2_list):
        evals_beta2.append(
            [
                poly_eval(m.row_coeffs, beta2),
                poly_eval(m.col_coeffs, beta2),
                poly_eval(m.val_coeffs, beta2),
                poly_eval(g2, beta2),
                poly_eval(h2, beta2),
            ]
        )
    t.absorb_fr_list(b"evals_beta1", evals_beta1)
    for e in evals_beta2:
        t.absorb_fr_list(b"evals_beta2", e)
    xi1 = t.challenge_fr(b"xi1")
    xi2 = t.challenge_fr(b"xi2")

    # order must match verifier's commitment list exactly
    open_beta1 = kzg.batch_open(
        srs,
        [
            (w_hat, 0, rand_w),
            (za_coeffs, 0, rand_za),
            (zb_coeffs, 0, rand_zb),
            (s_coeffs, 0, rand_s),
            (t_coeffs, 0, None),
            (g1_coeffs, 0, rand_g1),
            (g1_coeffs, g1_shift, rand_g1s),
            (h1_coeffs, 0, rand_h1),
        ],
        beta1,
        xi1,
        **msm_kwargs,
    )
    beta2_polys = []
    for m, g2, h2, shift in zip(pk.matrices, g2_list, h2_list, g2_shifts):
        beta2_polys += [
            (m.row_coeffs, 0, None),
            (m.col_coeffs, 0, None),
            (m.val_coeffs, 0, None),
            (g2, 0, None),
            (g2, shift, None),
            (h2, 0, None),
        ]
    open_beta2 = kzg.batch_open(srs, beta2_polys, beta2, xi2, **msm_kwargs)

    return MarlinProof(
        comm_w=comm_w,
        comm_za=comm_za,
        comm_zb=comm_zb,
        comm_s=comm_s,
        comm_t=comm_t,
        comm_g1=comm_g1,
        comm_g1_shift=comm_g1s,
        comm_h1=comm_h1,
        comm_g2=comm_g2,
        comm_g2_shift=comm_g2s,
        comm_h2=comm_h2,
        sigmas=sigmas,
        evals_beta1=evals_beta1,
        evals_beta2=evals_beta2,
        open_beta1=open_beta1,
        open_beta2=open_beta2,
    )
