#!/usr/bin/env python
"""AES-128 proved with the Plonk backend on the accelerator.

The reference README's roadmap lists a Plonk backend (README.md:5);
round 4 proved a synthetic chain circuit only.  This drives the full
AES-128 mapping (plonk/aes_map.py, ~272k gates, domain 2^19) through
the device prover (plonk/backend_jax.py), verifies with the host
verifier, and runs the tampered-ciphertext negative case.

Run:  python scripts/run_plonk_aes.py
Writes timings to stdout.
"""

import logging
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
log = logging.getLogger("plonk-aes")


def main() -> None:
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)
    faulthandler.dump_traceback_later(600, repeat=True)
    import jax

    log.info("devices: %s", jax.devices())

    from aes_zero_knowledge_proof_circuit_tpu.ops.aes_host import encrypt_ecb
    from aes_zero_knowledge_proof_circuit_tpu.plonk import backend
    from aes_zero_knowledge_proof_circuit_tpu.plonk.aes_map import (
        AesPlonkCircuit,
    )
    from aes_zero_knowledge_proof_circuit_tpu.plonk.backend_jax import (
        JaxPlonkProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu.utils.config import CONFIG
    from aes_zero_knowledge_proof_circuit_tpu.utils.serialize import load_srs

    t0 = time.time()
    ac = AesPlonkCircuit()
    data = ac.circuit.compile()
    log.info("AES plonk circuit: %d gates, domain n=%d (built %.1fs)",
             len(ac.circuit.gates), data.n, time.time() - t0)

    from aes_zero_knowledge_proof_circuit_tpu import api

    need = data.n + 8  # backend.setup requires max_degree >= n + 5
    srs_path = CONFIG.srs_dir / f"srs_bls377_v2_d{need}.npz"
    t0 = time.time()
    if srs_path.exists():
        srs = load_srs(str(srs_path))
    else:
        larger = api._find_larger_srs(need)
        assert larger is not None, (
            f"no SRS checkpoint of degree >= {need} under {CONFIG.srs_dir}"
        )
        srs = api._truncate_srs(load_srs(str(larger)), need)
    log.info("SRS d=%d loaded %.1fs", srs.max_degree, time.time() - t0)

    t0 = time.time()
    pk = backend.setup(ac.circuit, srs=srs, rng=random.Random(11))
    log.info("plonk setup (selector/sigma interpolation+commits): %.1fs",
             time.time() - t0)

    msg = bytes(range(16))
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ct = bytes(encrypt_ecb(msg, key))
    public = ac.public_values(ct)
    t0 = time.time()
    assign = ac.assign(msg, key)
    log.info("witness replay: %.2fs", time.time() - t0)

    jp = JaxPlonkProver(pk)
    t0 = time.time()
    proof = jp.prove(assign, public, ac.circuit, rng=random.Random(12))
    log.info("plonk prove (first, incl. compiles): %.1fs", time.time() - t0)
    t0 = time.time()
    proof = jp.prove(assign, public, ac.circuit, rng=random.Random(13))
    log.info("plonk prove (warm): %.1fs", time.time() - t0)

    t0 = time.time()
    ok = backend.verify(pk.vk, proof, public)
    log.info("verify: %s in %.2fs", ok, time.time() - t0)
    assert ok, "AES plonk proof failed to verify"

    bad = bytearray(ct)
    bad[0] ^= 1
    bad_ok = backend.verify(pk.vk, proof,
                            ac.public_values(bytes(bad)))
    log.info("tampered ciphertext rejected: %s", not bad_ok)
    assert not bad_ok
    log.info("PLONK AES E2E COMPLETE")


if __name__ == "__main__":
    main()
