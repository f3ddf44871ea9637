"""Marlin indexer: arithmetize R1CS matrices into committed index polynomials.

A re-creation of the forked ark-marlin's offline phase
(SURVEY.md §2b: "indexer (arithmetize A/B/C into ... indexed polys)",
call site src/lib.rs:173 generate_proving_and_verifying_keys).

Protocol layout (self-consistent Marlin variant, per-matrix inner sumchecks):

* H = <w_n>, |H| = n >= max(#constraints, #variables), the constraint/variable
  domain. Constraint i <-> H[i]. Variables are embedded via `var_to_slot`:
  instance variable j sits at H[j * (n/|X|)] so that the input domain
  X = <w_n^(n/|X|)> (a subgroup!) carries exactly the public input — witness
  variables fill the remaining slots.
* Per matrix M in {A,B,C}: domain K_M with |K_M| >= nnz(M); index polys
  row_M, col_M (H-elements) and val_M := value * col / n  (the 1/u_H(col,col)
  normalization with u_H(x,x) = n/x on H), interpolated over K_M, committed.
* The lincheck polynomial is then
      t(Y) = sum_M eta_M * sum_k val_M[k] * v_H(alpha)/(alpha - row_M[k]) * L_{col_M[k]}(Y)
  and the round-3 rational sumcheck over K_M proves
      sigma_M = sum_{k in K_M} v_H(alpha) v_H(beta1) val_M(k) / ((alpha-row_M(k))(beta1-col_M(k))).
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import List

from ..models.r1cs import R1CS
from ..ops import kzg
from ..ops.field_params import R_MOD, inv_mod
from ..ops.poly_host import domain
from ..utils.transcript import Transcript


def _next_pow2_log(x: int) -> int:
    return max(1, (max(1, x) - 1).bit_length())


@dataclass
class MatrixIndex:
    log_k: int
    nnz: int
    # COO over (constraint index, variable H-slot, value) — padded to |K|
    row_slots: List[int]      # H slot indices (constraint rows)
    col_slots: List[int]      # H slot indices (variable columns)
    vals: List[int]           # raw matrix values
    # K-domain evaluations (the interpolated polys' values on K)
    row_evals: List[int]      # H element at row slot
    col_evals: List[int]      # H element at col slot
    val_evals: List[int]      # val * col_elt / n
    # coefficient forms + commitments
    row_coeffs: List[int]
    col_coeffs: List[int]
    val_coeffs: List[int]
    comm_row: kzg.Commitment
    comm_col: kzg.Commitment
    comm_val: kzg.Commitment

    @property
    def k(self) -> int:
        return 1 << self.log_k


@dataclass
class MarlinVerifyingKey:
    kzg_vk: kzg.VerifierKey
    log_n: int
    log_x: int
    num_instance: int
    log_ks: List[int]          # per matrix A, B, C
    max_degree: int
    index_comms: List[kzg.Commitment]  # row,col,val for A,B,C (9)

    def absorb_into(self, t: Transcript) -> None:
        t.absorb_u64(b"log_n", self.log_n)
        t.absorb_u64(b"log_x", self.log_x)
        t.absorb_u64(b"num_instance", self.num_instance)
        for lk in self.log_ks:
            t.absorb_u64(b"log_k", lk)
        t.absorb_u64(b"max_degree", self.max_degree)
        for c in self.index_comms:
            t.absorb_g1(b"index_comm", c.point)


@dataclass
class MarlinProvingKey:
    srs: kzg.SRS
    vk: MarlinVerifyingKey
    r1cs: R1CS                 # finalized template
    log_n: int
    log_x: int
    var_to_slot: List[int]     # z index -> H slot
    matrices: List[MatrixIndex]

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def x_size(self) -> int:
        return 1 << self.log_x


def required_degree(num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """Universal SRS degree for given capacity (reference analog:
    generate_universal_srs(866_944, 513, 4_062_064), src/lib.rs:141)."""
    log_n = _next_pow2_log(max(num_constraints, num_variables))
    n = 1 << log_n
    log_k = _next_pow2_log(num_non_zero)
    k = 1 << log_k
    return max(2 * n + 2, 2 * k)


def generate_universal_srs(
    num_constraints: int,
    num_variables: int,
    num_non_zero: int,
    rng: _random.Random,
    setup_fn=kzg.setup,
) -> kzg.SRS:
    return setup_fn(required_degree(num_constraints, num_variables, num_non_zero), rng)


def index(
    r1cs: R1CS,
    srs: kzg.SRS,
    msm_fn=None,
) -> MarlinProvingKey:
    """Build proving/verifying key material from a finalized R1CS template."""
    msm_kwargs = {"msm_fn": msm_fn} if msm_fn else {}

    log_x = _next_pow2_log(r1cs.num_instance)
    x_size = 1 << log_x
    log_n = _next_pow2_log(max(r1cs.num_constraints, r1cs.num_variables))
    # witness slots must fit beside the reserved input slots
    while (1 << log_n) - x_size < r1cs.num_witness or (1 << log_n) < x_size:
        log_n += 1
    n = 1 << log_n
    h = domain(log_n)

    # variable -> H slot embedding
    stride = n // x_size
    var_to_slot = [0] * r1cs.num_variables
    reserved = set(range(0, n, stride))
    for j in range(r1cs.num_instance):
        var_to_slot[j] = j * stride
    free_slots = [s for s in range(n) if s not in reserved]
    for w in range(r1cs.num_witness):
        var_to_slot[r1cs.num_instance + w] = free_slots[w]

    n_inv = inv_mod(n, R_MOD)
    h_elts = h.elements

    matrices: List[MatrixIndex] = []
    comms: List[kzg.Commitment] = []
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        row_slots, col_slots, vals = [], [], []
        for i, row in enumerate(rows):
            for c, v in sorted(row.items()):
                row_slots.append(i)
                col_slots.append(var_to_slot[c])
                vals.append(v)
        nnz = len(vals)
        log_k = _next_pow2_log(nnz)
        k = 1 << log_k
        # pad with zero-valued entries at (H[0], H[0])
        row_slots += [0] * (k - nnz)
        col_slots += [0] * (k - nnz)
        vals += [0] * (k - nnz)
        row_evals = [h_elts[s] for s in row_slots]
        col_evals = [h_elts[s] for s in col_slots]
        val_evals = [v * ce % R_MOD * n_inv % R_MOD for v, ce in zip(vals, col_evals)]
        kd = domain(log_k)
        row_coeffs = kd.intt(row_evals)
        col_coeffs = kd.intt(col_evals)
        val_coeffs = kd.intt(val_evals)
        comm_row, _ = kzg.commit(srs, row_coeffs, **msm_kwargs)
        comm_col, _ = kzg.commit(srs, col_coeffs, **msm_kwargs)
        comm_val, _ = kzg.commit(srs, val_coeffs, **msm_kwargs)
        comms += [comm_row, comm_col, comm_val]
        matrices.append(
            MatrixIndex(
                log_k=log_k,
                nnz=nnz,
                row_slots=row_slots,
                col_slots=col_slots,
                vals=vals,
                row_evals=row_evals,
                col_evals=col_evals,
                val_evals=val_evals,
                row_coeffs=row_coeffs,
                col_coeffs=col_coeffs,
                val_coeffs=val_coeffs,
                comm_row=comm_row,
                comm_col=comm_col,
                comm_val=comm_val,
            )
        )

    need = max(2 * n + 2, 2 * max(m.k for m in matrices))
    assert srs.max_degree >= need, (
        f"SRS degree {srs.max_degree} below required {need}"
    )

    vk = MarlinVerifyingKey(
        kzg_vk=srs.verifier_part(),
        log_n=log_n,
        log_x=log_x,
        num_instance=r1cs.num_instance,
        log_ks=[m.log_k for m in matrices],
        max_degree=srs.max_degree,
        index_comms=comms,
    )
    return MarlinProvingKey(
        srs=srs,
        vk=vk,
        r1cs=r1cs,
        log_n=log_n,
        log_x=log_x,
        var_to_slot=var_to_slot,
        matrices=matrices,
    )
