"""Top-level prove/verify API — the reference's L4 surface (src/lib.rs:60-174).

    synthesize_keys(plaintext_length) -> (AESProvingKey, MarlinVerifyingKey)
    encrypt(message, secret_key, proving_key) -> MarlinProof
    verify_encryption(verifying_key, proof, ciphertext) -> bool

plus re-exports generate_rand / deserialize_proof / Fr mirroring
src/lib.rs:47,52. Public-input convention: ciphertext bytes as LSB-first bit
field elements (src/helpers/mod.rs:84-93).

Heavy lifting is backend-selected: "host" (pure python oracle, tiny circuits)
or "jax" (device path: template cache, SRS checkpoint, JaxProver).
"""

from __future__ import annotations

import logging
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .marlin import indexer as _indexer
from .marlin import verifier as _verifier
from .marlin.indexer import MarlinProvingKey, MarlinVerifyingKey
from .marlin.prover import MarlinProof
from .models.aes_circuit import Template, build_template
from .ops import kzg
from .ops.field_params import R_MOD
from .utils.config import CONFIG
from .utils.errors import (
    CapacityError,
    InvalidInputError,
    ProofError,
    SerializationError,
    SynthesisError,
    ZkAesError,
    require,
)
from .utils.rng import generate_rand
from .utils.serialize import deserialize_proof, load_srs, save_srs, serialize_proof

Fr = R_MOD  # the scalar-field modulus (reference re-exports the Fr type)

__all__ = [
    "synthesize_keys", "encrypt", "verify_encryption", "compute_ciphertext",
    "bits_lsb_first", "generate_rand", "deserialize_proof", "serialize_proof",
    "Fr", "ZkAesError", "SynthesisError", "InvalidInputError",
    "CapacityError", "SerializationError", "ProofError",
]

log = logging.getLogger(__name__)

TEMPLATE_VERSION = 1


@dataclass
class AESProvingKey:
    marlin_pk: MarlinProvingKey
    template: Template
    backend: str = "jax"
    _jax_prover: object = None


def _template_cached(msg_len: int, mode: str = "ecb") -> Template:
    path = CONFIG.template_dir / (
        f"aes128_{mode}_{msg_len}_v{TEMPLATE_VERSION}.pkl"
    )
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    log.info("building AES-%s circuit template for %d bytes", mode, msg_len)
    tpl = build_template(msg_len, mode=mode)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tpl, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return tpl


def bits_lsb_first(data: bytes) -> List[int]:
    """byte_to_field_array semantics (src/helpers/mod.rs:84-93)."""
    out: List[int] = []
    for byte in data:
        for i in range(8):
            out.append((byte >> i) & 1)
    return out


def _find_larger_srs(need: int):
    """Smallest on-disk SRS checkpoint with degree >= need, if any."""
    best = None
    best_d = None
    for p in CONFIG.srs_dir.glob("srs_bls377_v2_d*.npz"):
        try:
            d = int(p.stem.rsplit("_d", 1)[1])
        except (IndexError, ValueError):
            continue
        if d >= need and (best_d is None or d < best_d):
            best, best_d = p, d
    return best


def _truncate_srs(srs: kzg.SRS, need: int) -> kzg.SRS:
    """Degree-d prefix of a powers-of-tau SRS (same tau, valid SRS)."""
    from .parallel.srs_gen import PackedPowers

    powers = srs.powers_g1
    packed = getattr(powers, "packed", None)
    if packed is not None:
        powers = PackedPowers(np.ascontiguousarray(packed[: need + 1]))
    else:
        powers = powers[: need + 1]
    return kzg.SRS(
        max_degree=need,
        powers_g1=powers,
        gamma_powers_g1=srs.gamma_powers_g1,
        h=srs.h,
        tau_h=srs.tau_h,
    )


def synthesize_keys(
    plaintext_length: int,
    rng=None,
    backend: str = "jax",
    srs: Optional[kzg.SRS] = None,
    mode: str = "ecb",
) -> Tuple[AESProvingKey, MarlinVerifyingKey]:
    """Trusted setup + circuit indexing (src/lib.rs:138-174).

    The universal SRS is sized from the template (the reference hard-codes
    capacity 866_944/513/4_062_064 at src/lib.rs:141); it is generated once
    and checkpointed to disk (SURVEY.md §5). mode="cbc" enables the chained
    block cipher variant (reference roadmap, tests/integration_tests.rs:1)."""
    require(
        plaintext_length > 0 and plaintext_length % 16 == 0,
        InvalidInputError,
        f"plaintext_length must be a positive multiple of 16, got "
        f"{plaintext_length}",
    )
    require(mode in ("ecb", "cbc"), InvalidInputError,
            f"mode must be 'ecb' or 'cbc', got {mode!r}")
    rng = rng or generate_rand()
    caller_srs = srs is not None
    tpl = _template_cached(plaintext_length, mode)
    na, nb, nc = tpl.r1cs.nnz()
    need = _indexer.required_degree(
        tpl.r1cs.num_constraints, tpl.r1cs.num_variables, max(na, nb, nc)
    )
    if srs is None:
        # v2: standard ark-bls12-377 generators (SRS depends on the G1 base)
        srs_path = CONFIG.srs_dir / f"srs_bls377_v2_d{need}.npz"
        larger = _find_larger_srs(need) if not srs_path.exists() else None
        if srs_path.exists():
            log.info("loading SRS checkpoint %s", srs_path)
            srs = load_srs(str(srs_path))
        elif larger is not None:
            # A powers-of-tau SRS is universal downward: the degree-d
            # prefix of a larger checkpoint is itself a valid SRS for the
            # same tau (the reference's SRS is likewise sized once for
            # the largest message, src/lib.rs:140-141). Reuse by
            # truncation instead of regenerating ~minutes of fixed-base
            # MSM.
            log.info("truncating SRS checkpoint %s to degree %d",
                     larger, need)
            srs = _truncate_srs(load_srs(str(larger)), need)
        else:
            log.info("generating SRS of degree %d (backend=%s)", need, backend)
            from . import native as _native

            if _native.available():
                from .parallel.srs_gen import generate_srs_native

                srs = generate_srs_native(need, rng)
            elif backend == "jax":
                from .parallel.srs_gen import generate_srs_device

                srs = generate_srs_device(need, rng)
            else:
                srs = kzg.setup(need, rng)
            save_srs(str(srs_path), srs)
    if backend == "jax":
        pk = _indexed_pk_cached(plaintext_length, mode, tpl, srs,
                                use_disk_cache=not caller_srs)
    else:
        pk = _indexer.index(tpl.r1cs, srs)
    apk = AESProvingKey(marlin_pk=pk, template=tpl, backend=backend)
    return apk, pk.vk


INDEX_VERSION = 2


def _srs_digest(srs: kzg.SRS) -> str:
    """Short content digest binding a pk checkpoint to its exact SRS.

    Hashes the generator plus a spread of power points — enough to detect a
    regenerated/substituted SRS without walking all ~1M points."""
    import hashlib

    h = hashlib.blake2s(digest_size=8)
    packed = getattr(srs.powers_g1, "packed", None)
    if packed is not None:
        n = packed.shape[0]
        for i in (0, 1, n // 2, n - 1):
            h.update(packed[i].tobytes())
    else:
        n = len(srs.powers_g1)
        for i in (0, 1, n // 2, n - 1):
            p = srs.powers_g1[i]
            h.update(b"inf" if p.inf else int(p.x).to_bytes(48, "little"))
    h.update(int(srs.max_degree).to_bytes(8, "little"))
    return h.hexdigest()


def _indexed_pk_cached(msg_len: int, mode: str, tpl: Template,
                       srs: kzg.SRS, use_disk_cache: bool = True,
                       ) -> MarlinProvingKey:
    """index_jax with a disk checkpoint (SURVEY.md §5 checkpoint/resume).

    Indexing at AES scale costs ~10+ min per process (device NTTs + 9
    commit MSMs + the COO walk); the indexed key is deterministic given
    (template, SRS), so cache everything but the SRS itself. The cache
    filename carries an SRS content digest so a regenerated checkpoint (or
    a caller-supplied SRS, which skips the disk cache entirely) can never
    pair with a stale pk."""
    if not use_disk_cache:
        from .marlin.indexer_jax import index_jax

        return index_jax(tpl.r1cs, srs)
    path = CONFIG.template_dir / (
        f"pk_{mode}_{msg_len}_v{TEMPLATE_VERSION}_srs{srs.max_degree}"
        f"_{_srs_digest(srs)}_ix{INDEX_VERSION}.pkl"
    )
    if path.exists():
        log.info("loading indexed proving key %s", path)
        with open(path, "rb") as f:
            state = pickle.load(f)
        pk = MarlinProvingKey(
            srs=srs, vk=state["vk"], r1cs=tpl.r1cs, log_n=state["log_n"],
            log_x=state["log_x"], var_to_slot=state["var_to_slot"],
            matrices=state["matrices"],
        )
        pk.coo_np = state["coo_np"]
        return pk
    from .marlin.indexer_jax import index_jax

    pk = index_jax(tpl.r1cs, srs)
    state = dict(
        vk=pk.vk, log_n=pk.log_n, log_x=pk.log_x,
        var_to_slot=pk.var_to_slot, matrices=pk.matrices,
        coo_np=pk.coo_np,
    )
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return pk


def encrypt(
    message: bytes,
    secret_key: bytes,
    proving_key: AESProvingKey,
    rng=None,
    zk: bool = True,
    iv: Optional[bytes] = None,
    mesh=None,
) -> MarlinProof:
    """Prove knowledge of (message, key) for the AES-128 ciphertext
    (src/lib.rs:60-114). The witness is generated by the vectorized trace
    engine, not by re-synthesizing the circuit. CBC templates require iv.
    mesh: optional jax.sharding.Mesh — multi-chip proving (sharded
    4n-domain NTTs + sharded commit MSMs; see JaxProver)."""
    rng = rng or generate_rand()
    tpl = proving_key.template
    require(
        len(message) == tpl.msg_len,
        InvalidInputError,
        f"message is {len(message)} bytes; the proving key was synthesized "
        f"for {tpl.msg_len}",
    )
    require(len(secret_key) == 16, InvalidInputError,
            "secret_key must be exactly 16 bytes (AES-128)")
    if tpl.mode == "cbc":
        require(iv is not None and len(iv) == 16, InvalidInputError,
                "CBC proving keys require a 16-byte iv")
    else:
        require(iv is None, InvalidInputError,
                "iv given but the proving key is for ECB mode")
    z = _witness_bits(tpl, message, secret_key, proving_key.backend, iv=iv)
    instance = [1] + [int(v) for v in z[1 : tpl.r1cs.num_instance]]
    witness = z[tpl.r1cs.num_instance :]
    if proving_key.backend == "jax":
        from .marlin.prover_jax import JaxProver

        if mesh is not None:
            return JaxProver(proving_key.marlin_pk, mesh=mesh).prove(
                instance, witness, rng=rng, zk=zk
            )
        if proving_key._jax_prover is None:
            proving_key._jax_prover = JaxProver(proving_key.marlin_pk)
        return proving_key._jax_prover.prove(instance, witness, rng=rng, zk=zk)
    from .marlin import prover as _prover

    return _prover.prove(
        proving_key.marlin_pk, instance, [int(v) for v in witness], rng=rng,
        zk=zk,
    )


def encrypt_batch(
    messages: List[bytes],
    secret_key: bytes,
    proving_key: AESProvingKey,
    rng=None,
    zk: bool = True,
    mesh=None,
) -> List[MarlinProof]:
    """Prove N independent messages under one key (BASELINE config #3:
    batched independent proofs).

    The witness fill is vmapped over the batch on device — sharded over
    `mesh`'s first axis when a jax.sharding.Mesh is given (data parallelism
    over blocks; ECB blocks/messages are independent, reference analog
    src/lib.rs:194 `message.chunks(16)`). Proofs are then generated per
    message from the precomputed witness columns; each verifies
    independently against its own ciphertext."""
    require(len(messages) > 0, InvalidInputError, "empty message batch")
    tpl = proving_key.template
    require(tpl.mode == "ecb", InvalidInputError,
            "encrypt_batch supports ECB proving keys (CBC chains blocks)")
    for m in messages:
        require(len(m) == tpl.msg_len, InvalidInputError,
                f"every message must be {tpl.msg_len} bytes")
    require(len(secret_key) == 16, InvalidInputError,
            "secret_key must be exactly 16 bytes (AES-128)")
    rng = rng or generate_rand()

    import jax
    import jax.numpy as jnp

    from .ops.witness_jax import evaluator_for

    ev = evaluator_for(tpl.plan)
    batch = len(messages)
    mb = np.stack(
        [np.asarray(bits_lsb_first(m), np.int32) for m in messages]
    )
    kb = np.tile(
        np.asarray(bits_lsb_first(secret_key), np.int32), (batch, 1)
    )
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        pad = (-batch) % mesh.devices.size
        if pad:
            mb = np.concatenate([mb, np.zeros((pad, mb.shape[1]), mb.dtype)])
            kb = np.concatenate([kb, np.tile(kb[:1], (pad, 1))])
        sharding = NamedSharding(mesh, P(axis, None))
        mb = jax.device_put(mb, sharding)
        kb = jax.device_put(kb, sharding)
    zs = np.asarray(
        jax.jit(jax.vmap(lambda m, k: ev._evaluate(
            {"message": m, "key": k})))(jnp.asarray(mb), jnp.asarray(kb))
    )[:batch]

    # Per-proof deterministic rngs drawn from the caller's stream up-front
    # (proofs are generated concurrently below; a shared Random would be
    # racy and nondeterministic).
    import random as _random

    seeds = [rng.randrange(1 << 62) for _ in range(batch)]

    def one(i: int) -> MarlinProof:
        z = zs[i]
        instance = [1] + [int(v) for v in z[1 : tpl.r1cs.num_instance]]
        witness = z[tpl.r1cs.num_instance :]
        prng = _random.Random(seeds[i])
        if proving_key.backend == "jax":
            return proving_key._jax_prover.prove(instance, witness,
                                                 rng=prng, zk=zk)
        from .marlin import prover as _prover

        return _prover.prove(proving_key.marlin_pk, instance,
                             [int(v) for v in witness], rng=prng, zk=zk)

    if proving_key.backend == "jax":
        from .marlin.prover_jax import JaxProver

        if proving_key._jax_prover is None:
            proving_key._jax_prover = JaxProver(proving_key.marlin_pk)
        # two-deep proof pipeline: proof i's host-side commit MSMs (native
        # tier, GIL released) overlap proof i+1's device NTT/sumcheck work
        # (SURVEY.md §2b "pipeline across AHP rounds", lifted to the batch).
        # Measured 0.90x on a 2-CPU host (both proofs' OpenMP MSMs fight
        # for the same cores — artifacts/cbc_batch_tpu.json), so the
        # pipeline engages only when host cores exist to absorb it.
        import os as _os

        if (_os.cpu_count() or 1) >= 4:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=2) as ex:
                return list(ex.map(one, range(batch)))
    return [one(i) for i in range(batch)]


def _witness_bits(tpl: Template, message: bytes, key: bytes,
                  backend: str, iv: Optional[bytes] = None) -> np.ndarray:
    inputs = {
        "message": np.asarray(bits_lsb_first(message), np.int32),
        "key": np.asarray(bits_lsb_first(key), np.int32),
    }
    if tpl.mode == "cbc":
        inputs["iv"] = np.asarray(bits_lsb_first(iv), np.int32)
    if backend == "jax":
        from .ops.witness_jax import evaluator_for

        ev = evaluator_for(tpl.plan)
        return np.asarray(ev.evaluate(inputs))
    return tpl.plan.evaluate(inputs)


def compute_ciphertext(message: bytes, secret_key: bytes,
                       iv: Optional[bytes] = None) -> bytes:
    """Native AES-128 ECB/CBC (oracle; src/main.rs:28-34
    primitive_encrypt)."""
    if iv is not None:
        from .ops.aes_host import encrypt_cbc

        return bytes(encrypt_cbc(message, secret_key, iv))
    from .ops.aes_host import encrypt_ecb

    return bytes(encrypt_ecb(message, secret_key))


def verify_encryption(
    verifying_key: MarlinVerifyingKey,
    proof: MarlinProof,
    ciphertext: bytes,
    iv: Optional[bytes] = None,
) -> bool:
    """src/lib.rs:116-136: ciphertext bytes -> LSB-first bit field elements
    -> Marlin verify. For CBC, the public input is [1] + iv bits + ct bits."""
    require(len(ciphertext) % 16 == 0 and len(ciphertext) > 0,
            InvalidInputError,
            f"ciphertext must be a positive multiple of 16 bytes, got "
            f"{len(ciphertext)}")
    if iv is not None:
        require(len(iv) == 16, InvalidInputError, "iv must be 16 bytes")
    instance = [1]
    if iv is not None:
        instance += bits_lsb_first(iv)
    instance += bits_lsb_first(ciphertext)
    return _verifier.verify(verifying_key, instance, proof)
