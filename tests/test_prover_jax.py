"""JAX prover vs host prover: identical non-zk proofs, verifying zk proofs."""

import random

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover, verifier
from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import JaxProver
from aes_zero_knowledge_proof_circuit_tpu.models.r1cs import R1CS
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD

rng = random.Random(21)


@pytest.fixture(scope="module")
def toy():
    from tests.test_marlin import build_toy_circuit

    cs, assignment = build_toy_circuit()
    na, nb, nc = cs.nnz()
    srs = indexer.generate_universal_srs(
        cs.num_constraints, cs.num_variables, max(na, nb, nc), rng
    )
    pk = indexer.index(cs, srs)
    return cs, assignment, pk


@pytest.mark.slow
def test_jax_prover_matches_host_nonzk(toy):
    cs, assignment, pk = toy
    inst, wit = assignment(3, 4)
    host_proof = prover.prove(pk, inst, wit, rng=rng, zk=False)
    jp = JaxProver(pk)
    jax_proof = jp.prove(inst, np.asarray(wit, np.int32), rng=rng, zk=False)
    # deterministic without zk: proofs must agree field-for-field
    assert jax_proof.sigmas == host_proof.sigmas
    assert jax_proof.evals_beta1 == host_proof.evals_beta1
    assert jax_proof.evals_beta2 == host_proof.evals_beta2
    assert jax_proof.comm_w.point == host_proof.comm_w.point
    assert jax_proof.comm_t.point == host_proof.comm_t.point
    assert jax_proof.comm_g1.point == host_proof.comm_g1.point
    assert jax_proof.comm_h1.point == host_proof.comm_h1.point
    for a, b in zip(jax_proof.comm_h2, host_proof.comm_h2):
        assert a.point == b.point
    assert jax_proof.open_beta1.w == host_proof.open_beta1.w
    assert jax_proof.open_beta2.w == host_proof.open_beta2.w
    assert verifier.verify(pk.vk, inst, jax_proof)


@pytest.mark.slow
def test_jax_prover_zk_verifies(toy):
    cs, assignment, pk = toy
    inst, wit = assignment(6, 2)
    jp = JaxProver(pk)
    proof = jp.prove(inst, np.asarray(wit, np.int32), rng=rng, zk=True)
    assert verifier.verify(pk.vk, inst, proof)
    bad = list(inst)
    bad[1] = (bad[1] + 1) % R_MOD
    assert not verifier.verify(pk.vk, bad, proof)


def test_schedule_msms_makespan():
    """Latency-aware hybrid split: small MSMs stay native, big ones go
    to the device, and the greedy beats both single-lane extremes."""
    from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import (
        _schedule_msms,
    )

    lat, r_dev, r_nat = 1.5, 0.28e6, 0.11e6
    # round-3 shape of the 16B proof: (g2, g2-shift, h2) per matrix
    sizes = [2**18, 2**18, 2**19, 2**19, 2**19, 2**20, 2**19, 2**19, 2**20]
    dev = _schedule_msms(sizes, lat, r_dev, r_nat)
    assert 0 < len(dev) < len(sizes)

    def makespan(device_set):
        t_dev = sum(lat + sizes[i] / r_dev for i in device_set)
        t_nat = sum(sizes[i] / r_nat
                    for i in range(len(sizes)) if i not in device_set)
        return max(t_dev, t_nat)

    chosen = makespan(dev)
    assert chosen <= makespan(set())  # all-native
    assert chosen <= makespan(set(range(len(sizes))))  # all-device
    # exhaustive optimum for small batches: no subset beats it
    n = len(sizes)
    assert all(chosen <= makespan({i for i in range(n) if (m >> i) & 1})
               for m in range(1 << n))
    # at least one of the two largest MSMs (h2 at 2^20) is on the device
    assert dev & {5, 8}

    # a single small MSM is cheaper on the host than one device latency
    assert _schedule_msms([4096, 4096], lat, r_dev, r_nat) == set()


def test_device_lane_routing(monkeypatch):
    """The device MSM lane is off unless ZKAES_MSM_MXU=1 forces it, and
    never on a mesh; msm_device runs the plain f32 Pippenger without loading any
    Pallas module."""
    import sys

    import jax.numpy as jnp

    from aes_zero_knowledge_proof_circuit_tpu.marlin import prover_jax as PJ
    from aes_zero_knowledge_proof_circuit_tpu.ops import msm_host, msm_jax
    from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
        g1_generator,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.curve_jax import (
        affine_to_device,
    )

    monkeypatch.delenv("ZKAES_MSM_MXU", raising=False)
    assert not PJ.device_lane_on()
    monkeypatch.setenv("ZKAES_MSM_MXU", "1")
    assert PJ.device_lane_on()
    assert not PJ.device_lane_on(mesh=object())
    monkeypatch.setenv("ZKAES_MSM_MXU", "0")
    assert not PJ.device_lane_on()

    g = g1_generator()
    pts = [g.mul_scalar(k) for k in (3, 5, 7, 11)]
    scalars = [rng.randrange(R_MOD) for _ in pts]
    got = msm_jax.msm_device(
        affine_to_device(pts),
        jnp.asarray(msm_jax.scalars_to_digit_limbs(scalars)))
    assert got == msm_host.msm(pts, scalars)
    assert not [m for m in sys.modules if "pallas" in m.split(".")[-1]
                and m.startswith("aes_zero_knowledge_proof_circuit_tpu")]
