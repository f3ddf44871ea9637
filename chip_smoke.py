#!/usr/bin/env python
"""Smoke run of the prover on one GPU, through the public API.

    python chip_smoke.py            # one card: kernels + 16-byte proof
    python chip_smoke.py --four     # four cards: mesh proof only

One card:
  device  JAX's devices, the card's name and power limit (nvidia-smi), and
          the native host library (the commit MSMs' CPU tier).
  proof   api.synthesize_keys(16) -> api.encrypt (cold, then warm) ->
          api.verify_encryption, which must accept the proof and reject a
          ciphertext with one bit flipped; set-up, prove, per-stage and
          verify times and peak device memory.
  kernels each device kernel of that path at a real width against an
          independent reference, with zero tolerance: the f32-digit field
          multiply (Fr and Fq) against Python integers, the 2^20 NTT
          against Python integers on sampled rows and, with its inverse,
          against the same program compiled for the CPU, and
          the device MSM at 2^16 and 2^20 SRS points against the native
          Pippenger.

--four runs only the 16-byte zk=False proof on a 4-card mesh, compares it
field by field with the single-card zk=False proof, verifies it, and
checks that the outer-sumcheck 4n-domain NTT runs on all four cards.

Any failure exits non-zero. The last line of stdout is one JSON object
naming the device; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import subprocess
import sys
import time

import numpy as np

MSG = bytes(range(16))
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CARD = "?"  # "name, power limit" from nvidia-smi
NTT_LOG = 20          # field multiply and NTT width
MSM_LOGS = (16, 20)   # device MSM sizes checked against native


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, seconds: float) -> None:
    say(f"{label}: {seconds:.3f} s  [{CARD}]")


def device_phase(count: int):
    global CARD
    import jax

    devs = jax.devices()
    say(f"jax.devices(): {devs}")
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is on {devs[0].platform!r}")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    say(f"device_kind: {devs[0].device_kind}")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi printed no card")
    for ln in lines:
        say(f"nvidia-smi: {ln}")
    CARD = lines[0]

    from aes_zero_knowledge_proof_circuit_tpu import native

    check(native.available(), "native host library failed to build")
    say("native host library: available")
    return devs


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def proof_phase(seed: int, dev):
    from aes_zero_knowledge_proof_circuit_tpu import api

    rng = random.Random(seed)
    t0 = time.time()
    pk, vk = api.synthesize_keys(16, rng=rng)
    timed("set-up (template + SRS + index)", time.time() - t0)
    mpk = pk.marlin_pk
    say(f"circuit: {mpk.r1cs.num_constraints} constraints, "
        f"H = 2^{mpk.log_n}, SRS degree {mpk.srs.max_degree}")
    ct = api.compute_ciphertext(MSG, KEY)
    bad = bytearray(ct)
    bad[0] ^= 1

    for label in ("first proof (cold)", "warm proof"):
        t0 = time.time()
        proof = api.encrypt(MSG, KEY, pk, rng=rng)
        timed(label, time.time() - t0)
        for stage, s in pk._jax_prover.last_stage_times.items():
            timed(f"  stage {stage}", s)
        t0 = time.time()
        ok = api.verify_encryption(vk, proof, ct)
        timed("  verify", time.time() - t0)
        check(ok, f"{label} did not verify")
        check(not api.verify_encryption(vk, proof, bytes(bad)),
              f"{label} verified against a tampered ciphertext")
        say(f"  {label}: verified; tampered ciphertext rejected")
    say(f"peak_bytes_in_use after proofs: {peak_bytes(dev)}  [{CARD}]")
    return pk


def _rand_digits(rng: np.random.Generator, n: int, d: int):
    """n random values below the modulus as [n, d] f32 digits (the top
    three digits zero)."""
    raw = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    raw[:, d - 3:] = 0
    return raw


def _digits_int(row) -> int:
    v = 0
    for x in reversed(np.asarray(row, np.float64).tolist()):
        v = v * 256 + int(x)
    return v


def _ntt_rows(vals, omega: int, rows, r: int):
    """sum_j vals[j] * omega^(j k) mod r for each k in rows, in Python
    integers."""
    out = []
    for k in rows:
        wk, acc, s = pow(omega, int(k), r), 1, 0
        for v in vals:
            s += v * acc
            acc = acc * wk % r
        out.append(s % r)
    return out


def kernel_phase(packed, seed: int, dev):
    import jax
    import jax.numpy as jnp

    from aes_zero_knowledge_proof_circuit_tpu import native
    from aes_zero_knowledge_proof_circuit_tpu.ops import msm_mxu as MM
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
        fq_f32,
        fr_f32,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import (
        root_of_unity,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops.ntt_jax import ntt_engine

    rng = np.random.default_rng(seed)
    n = 1 << NTT_LOG

    # -- f32-digit field multiply vs Python integers -----------------------
    for name, F in (("Fr", fr_f32()), ("Fq", fq_f32())):
        a0 = jnp.asarray(_rand_digits(rng, n, F.D))
        b0 = jnp.asarray(_rand_digits(rng, n, F.D))
        # Montgomery forms in the engine's redundant band, then the product
        a, b = F.mul(a0, F.r2_digits), F.mul(b0, F.r2_digits)
        c = F.mul(a, b)
        jax.block_until_ready(c)
        t0 = time.time()
        jax.block_until_ready(F.mul(a, b))
        timed(f"{name} mul 2^{NTT_LOG} (warm)", time.time() - t0)
        rows = rng.choice(n, size=min(n, 4096), replace=False)
        an, bn, cn = (np.asarray(x)[rows] for x in (a, b, c))
        m, rinv = F.ctx.modulus, F.ctx.R_inv
        bad = sum(
            _digits_int(cr) % m != _digits_int(ar) * _digits_int(br) * rinv % m
            for ar, br, cr in zip(an, bn, cn))
        check(bad == 0, f"{name} mul: {bad} of {len(rows)} sampled rows wrong")
        say(f"{name} mul 2^{NTT_LOG}: {len(rows)} sampled rows exact vs "
            "Python ints")

    # -- NTT 2^20 vs Python integers and the same program on the CPU -----
    F = fr_f32()
    eng = ntt_engine(NTT_LOG)
    raw = _rand_digits(rng, n, F.D)
    x = F.mul(jnp.asarray(raw), F.r2_digits)         # Montgomery: raw * R
    y = eng.ntt(x)
    xi = eng.intt(y)
    jax.block_until_ready(xi)
    t0 = time.time()
    jax.block_until_ready(eng.ntt(x))
    timed(f"NTT 2^{NTT_LOG} (warm)", time.time() - t0)
    t0 = time.time()
    jax.block_until_ready(eng.intt(y))
    timed(f"iNTT 2^{NTT_LOG} (warm)", time.time() - t0)
    # sampled rows against Python integers: independent of every compiled
    # program (and of any compile cache) except the NTT under test
    r = F.ctx.modulus
    raw_ints = [int.from_bytes(row.astype(np.uint8).tobytes(), "little")
                for row in raw]
    rows = [0, 1] + rng.choice(n, size=6, replace=False).tolist()
    want = _ntt_rows(raw_ints, root_of_unity(NTT_LOG), rows, r)
    y_h = np.asarray(y)
    scale = F.ctx.R_mod                             # the Montgomery radix
    bad = sum(_digits_int(y_h[k]) % r != w * scale % r
              for k, w in zip(rows, want))
    check(bad == 0, f"NTT 2^{NTT_LOG}: {bad} of {len(rows)} sampled rows "
          "differ from Python integers")
    say(f"NTT 2^{NTT_LOG}: {len(rows)} sampled rows exact vs Python ints")
    cpu = jax.devices("cpu")[0]
    put = lambda v: jax.device_put(v, cpu)
    y_cpu = eng._ntt_j(put(x), put(eng._perm), put(eng._fwd_tab))
    xi_cpu = eng._intt_j(put(y), put(eng._perm), put(eng._inv_tab),
                         put(eng._n_inv))
    canon = lambda v: np.asarray(F.to_canonical_limbs(v))
    for label, got, want_c in (("NTT", y, y_cpu), ("iNTT", xi, xi_cpu)):
        got_h, want_h = np.asarray(got), np.asarray(want_c)
        same_bits = np.array_equal(got_h, want_h)
        same_vals = same_bits or np.array_equal(
            canon(got), canon(jnp.asarray(want_h)))
        check(same_vals, f"{label} 2^{NTT_LOG} differs from the CPU program")
        say(f"{label} 2^{NTT_LOG} vs CPU program: values equal"
            f" (digits bit-identical: {same_bits})")
    check(np.array_equal(canon(xi), canon(x)), "iNTT(NTT(x)) != x")
    xi_h = np.asarray(xi)
    check(all(_digits_int(xi_h[k]) % r == raw_ints[k] * scale % r
              for k in rows), "iNTT(NTT(x)) != x on sampled rows")
    say(f"NTT 2^{NTT_LOG} round trip: exact")

    # -- device MSM vs native Pippenger on SRS points ----------------------
    pts = MM.PlainPoints.from_packed(packed[: 1 << max(MSM_LOGS, default=0)])
    for log_n in MSM_LOGS:
        m = 1 << log_n
        limbs = rng.integers(0, 1 << 16, size=(m, 16)).astype(np.uint32)
        limbs[:, 15] %= 0x12AB                      # scalars below r
        got = MM.msm_mxu(pts.slice(0, m), limbs)    # compiles
        t0 = time.time()
        got = MM.msm_mxu(pts.slice(0, m), limbs)
        dev_s = time.time() - t0
        t0 = time.time()
        want = native.g1_msm_packed(packed[:m], native.limbs16_to_u64(limbs))
        nat_s = time.time() - t0
        check(got == want, f"device MSM 2^{log_n} != native Pippenger")
        say(f"MSM 2^{log_n}: device lane == native Pippenger")
        timed(f"  MSM 2^{log_n} device lane (warm)", dev_s)
        timed(f"  MSM 2^{log_n} native Pippenger", nat_s)
    say(f"peak_bytes_in_use after kernels: {peak_bytes(dev)}  [{CARD}]")


def four_card_phase(seed: int):
    import jax

    from aes_zero_knowledge_proof_circuit_tpu import api
    from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import (
        JaxProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu.ops import poly_jax as P
    from aes_zero_knowledge_proof_circuit_tpu.parallel.mesh import make_mesh

    t0 = time.time()
    pk, vk = api.synthesize_keys(16, rng=random.Random(seed))
    timed("set-up (template + SRS + index)", time.time() - t0)
    mesh = make_mesh(4)
    t0 = time.time()
    one = api.encrypt(MSG, KEY, pk, zk=False)
    timed("single-card zk=False proof", time.time() - t0)
    t0 = time.time()
    four = api.encrypt(MSG, KEY, pk, zk=False, mesh=mesh)
    timed("4-card mesh zk=False proof", time.time() - t0)
    for f in dataclasses.fields(four):
        same = getattr(four, f.name) == getattr(one, f.name)
        say(f"  field {f.name}: {'identical' if same else 'DIFFERS'}")
        check(same, f"mesh proof field {f.name} differs from single-card")
    ct = api.compute_ciphertext(MSG, KEY)
    check(api.verify_encryption(vk, four, ct), "mesh proof did not verify")
    bad = bytearray(ct)
    bad[0] ^= 1
    check(not api.verify_encryption(vk, four, bytes(bad)),
          "mesh proof verified against a tampered ciphertext")
    say("mesh proof: verified; tampered ciphertext rejected")

    prover = JaxProver(pk.marlin_pk, mesh=mesh)
    n4 = 4 << prover.log_n
    out = prover._ntt4(P.dpoly(list(range(1, 9))))
    shards = out.addressable_shards
    devs = {s.device for s in shards}
    rows = sorted(s.data.shape[0] for s in shards)
    say(f"4n-domain NTT output: {out.shape}, {out.sharding.spec}, shards on "
        f"{len(devs)} devices, rows per shard {rows}")
    check(out.shape[0] == n4 and len(devs) == 4,
          "the 4n-domain NTT did not run on the four cards")
    for d in jax.devices()[:4]:
        say(f"peak_bytes_in_use {d}: {peak_bytes(d)}  [{CARD}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh proof check")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    count = 4 if args.four else 1
    devs = device_phase(count)
    if args.four:
        four_card_phase(args.seed)
    else:
        pk = proof_phase(args.seed, devs[0])
        kernel_phase(pk.marlin_pk.srs.powers_g1.packed, args.seed, devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
