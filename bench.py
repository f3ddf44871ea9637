#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line.

Headline metric: AES-128 16-byte block proofs/sec (proving only, setup
excluded — the reference's criterion measurement boundary,
benches/benchmark_encrypt.rs:39-48), the median of three warm proofs.
Needs a GPU: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import sys
import time


def _stage(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _bench_block_proof():
    """Full prove path: synthesize once (cached), then time encrypt()."""
    from aes_zero_knowledge_proof_circuit_tpu import api

    _stage("synthesize_keys(16) start")
    pk, vk = api.synthesize_keys(16, backend="jax")
    _stage("synthesize_keys done; warm-up prove start")
    msg = bytes(range(16))
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    proof = api.encrypt(msg, key, pk)          # warm-up (compiles)
    ct = api.compute_ciphertext(msg, key)
    if not api.verify_encryption(vk, proof, ct):
        raise SystemExit("bench proof failed to verify")
    _stage("verified; timing warm proves")
    times = []
    for i in range(3):
        t0 = time.time()
        api.encrypt(msg, key, pk)
        times.append(time.time() - t0)
        _stage(f"warm prove {i + 1}/3: {times[-1]:.1f}s")
    dt = sorted(times)[1]
    return {
        "metric": "aes128_block_proofs_per_sec",
        "value": 1.0 / dt,
        "unit": "proofs/s",
        "warm_prove_s": times,
        "stage_times": getattr(pk._jax_prover, "last_stage_times", None),
    }


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"# no GPU (JAX found {dev.platform}); not benchmarking",
              file=sys.stderr)
        sys.exit(1)
    result = _bench_block_proof()
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
