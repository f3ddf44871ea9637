#!/usr/bin/env python
"""Device-path Plonk proof at scale (synthetic circuit, on the accelerator).

Builds a ~2^14-gate arithmetic circuit (squaring/add chain with copy
constraints), proves it with plonk/backend_jax.py's JaxPlonkProver (all
polynomial math on the device kernels, commits on the native MSM tier)
and verifies with the unchanged host verifier, plus the tamper-negative
case. Writes timings to stdout.

Run:  python scripts/run_plonk_device.py [log_gates]
"""

import logging
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
log = logging.getLogger("plonk-dev")


def build_chain(num_gates: int):
    """public out; private x; chain x_{i+1} = x_i^2 + x_i (+ copy
    constraints throughout), out = last."""
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
    from aes_zero_knowledge_proof_circuit_tpu.plonk import PlonkCircuit

    c = PlonkCircuit()
    out_pub = c.public_input()
    x = c.var()
    assign = {x: 3}
    cur, val = x, 3
    while len(c.gates) < num_gates - 2:
        sq = c.mul(cur, cur)
        assign[sq] = val * val % R_MOD
        s = c.add(sq, cur)
        assign[s] = (val * val + val) % R_MOD
        cur, val = s, (val * val + val) % R_MOD
    c.assert_equal(cur, out_pub)
    return c, assign, val


def main() -> None:
    log_gates = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    import jax

    from aes_zero_knowledge_proof_circuit_tpu.plonk import setup, verify
    from aes_zero_knowledge_proof_circuit_tpu.plonk.backend_jax import (
        JaxPlonkProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD

    log.info("devices: %s", jax.devices())
    t0 = time.time()
    circuit, assign, out_val = build_chain(1 << log_gates)
    log.info("circuit: %d gates built in %.1fs",
             len(circuit.gates), time.time() - t0)

    t0 = time.time()
    pk = setup(circuit, rng=random.Random(1))
    log.info("setup (SRS + preprocess): %.1fs  n=%d", time.time() - t0,
             pk.data.n)

    t0 = time.time()
    jp = JaxPlonkProver(pk)
    log.info("device prover init: %.1fs", time.time() - t0)

    public = [out_val % R_MOD]
    t0 = time.time()
    proof = jp.prove(assign, public, circuit, rng=random.Random(2))
    log.info("device prove (first, incl. compiles): %.1fs",
             time.time() - t0)
    t0 = time.time()
    proof = jp.prove(assign, public, circuit, rng=random.Random(3))
    log.info("device prove (warm): %.1fs", time.time() - t0)

    t0 = time.time()
    ok = verify(pk.vk, proof, public)
    log.info("verify: %s in %.1fs", ok, time.time() - t0)
    assert ok, "device plonk proof must verify"
    assert not verify(pk.vk, proof, [(public[0] + 1) % R_MOD]), (
        "tampered public input must be rejected"
    )
    log.info("tampered public input correctly rejected — DEVICE PLONK OK")


if __name__ == "__main__":
    main()
