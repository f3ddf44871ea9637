#!/usr/bin/env python
"""Benchmark matrix — the criterion harness analog.

Mirrors the reference's bench configurations (benches/benchmark.rs:8-10:
16/32/64-byte messages; benches/benchmark_encrypt.rs:39-48: synthesize_keys
outside the loop, proving time only), emitting one JSON line per config:

    python scripts/bench_matrix.py [--sizes 16,32,64] [--iters 3] [--profile]

--profile additionally captures a jax.profiler trace of one proof per size
(the pprof-flamegraph analog, benches/benchmark.rs:13-18) under
<cache_dir>/traces/ (utils/config.py).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="16,32,64")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--backend", default="jax", choices=("jax", "host"))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)

    from aes_zero_knowledge_proof_circuit_tpu import api

    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    for size in [int(s) for s in args.sizes.split(",")]:
        msg = bytes(i & 0xFF for i in range(size))
        t0 = time.time()
        pk, vk = api.synthesize_keys(size, backend=args.backend)
        setup_s = time.time() - t0

        t0 = time.time()
        proof = api.encrypt(msg, key, pk)  # warm-up incl. compiles
        warm_s = time.time() - t0
        ct = api.compute_ciphertext(msg, key)
        assert api.verify_encryption(vk, proof, ct), f"size={size} bad proof"

        if args.profile:
            import jax

            from aes_zero_knowledge_proof_circuit_tpu.utils.config import (
                CONFIG,
            )
            from pathlib import Path

            tdir = Path(CONFIG.cache_dir) / "traces" / f"prove_{size}"
            tdir.mkdir(parents=True, exist_ok=True)
            with jax.profiler.trace(str(tdir)):
                api.encrypt(msg, key, pk)

        t0 = time.time()
        for _ in range(args.iters):
            api.encrypt(msg, key, pk)
        dt = (time.time() - t0) / args.iters
        print(json.dumps({
            "metric": f"aes128_prove_{size}B",
            "value": round(dt, 3),
            "unit": "s",
            "proofs_per_sec": round(1.0 / dt, 4),
            "setup_s": round(setup_s, 1),
            "first_prove_s": round(warm_s, 1),
            "constraints": pk.template.r1cs.num_constraints,
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
