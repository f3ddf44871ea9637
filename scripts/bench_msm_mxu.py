#!/usr/bin/env python
"""Time the device MSM lane (ops/msm_mxu) against the native Pippenger.

Generates an SRS of 2^max_log points with the native tier, then for each
size and each (window bits c, lanes) setting: checks that both lanes give
the same point and prints the warm device time beside the native time.
Prints to stdout only; needs a GPU.

Usage: python scripts/bench_msm_mxu.py [--logs 16 18 20] [--c 13]
           [--lanes 4096 16384 65536]
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logs", type=int, nargs="+", default=[16, 18, 20])
    ap.add_argument("--c", type=int, nargs="+", default=[13])
    ap.add_argument("--lanes", type=int, nargs="+", default=[1 << 14])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU (JAX found {dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    print(f"card: {card}  ({dev.device_kind}, {os.cpu_count()} host cores)",
          flush=True)

    from aes_zero_knowledge_proof_circuit_tpu import native
    from aes_zero_knowledge_proof_circuit_tpu.ops import msm_mxu as MM
    from aes_zero_knowledge_proof_circuit_tpu.parallel.srs_gen import (
        generate_srs_native,
    )

    if not native.available():
        sys.exit("native host library unavailable")
    t0 = time.time()
    packed = generate_srs_native(1 << max(args.logs),
                                 random.Random(7)).powers_g1.packed
    print(f"SRS 2^{max(args.logs)} (native): {time.time() - t0:.1f}s",
          flush=True)
    pts = MM.PlainPoints.from_packed(packed[: 1 << max(args.logs)])
    rng = np.random.default_rng(7)
    for log_n in args.logs:
        n = 1 << log_n
        limbs = rng.integers(0, 1 << 16, size=(n, 16)).astype(np.uint32)
        limbs[:, 15] %= 0x12AB                          # scalars below r
        u64 = native.limbs16_to_u64(limbs)
        nat = []
        for _ in range(args.reps):
            t0 = time.time()
            want = native.g1_msm_packed(packed[:n], u64)
            nat.append(time.time() - t0)
        print(f"2^{log_n} native: {min(nat):.3f}s  [{card}]", flush=True)
        for c in args.c:
            for lanes in args.lanes:
                t0 = time.time()
                got = MM.msm_mxu(pts.slice(0, n), limbs, c=c, lanes=lanes)
                cold = time.time() - t0
                if got != want:
                    sys.exit(f"MISMATCH 2^{log_n} c={c} lanes={lanes}")
                warm = []
                for _ in range(args.reps):
                    t0 = time.time()
                    MM.msm_mxu(pts.slice(0, n), limbs, c=c, lanes=lanes)
                    warm.append(time.time() - t0)
                print(f"2^{log_n} device c={c} lanes={lanes}: "
                      f"{min(warm):.3f}s warm, {cold:.1f}s cold, "
                      f"== native  [{card}]", flush=True)
    print(f"peak_bytes_in_use: {dev.memory_stats()['peak_bytes_in_use']}")


if __name__ == "__main__":
    main()
