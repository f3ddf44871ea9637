"""Full AES-128 prove -> verify integration tests (the reference's
tests/integration_tests.rs:312-337 and :339-372).

The complete pipeline — cached template -> SRS checkpoint -> device/native
indexing -> JaxProver -> host verifier — takes minutes at AES scale, so the
positive/negative 16-byte case is marked `gpu` and skips without a card
(`ZKAES_TEST_GPU=1 python -m pytest -m gpu tests/` on the card;
chip_smoke.py runs the same flow). The FIPS round-by-round oracle tiers
live in tests/test_aes_circuit.py."""

import pytest

from aes_zero_knowledge_proof_circuit_tpu import api


@pytest.mark.gpu
@pytest.mark.slow
def test_encrypt_a_16_bytes_plaintext(gpu):
    """integration_tests.rs:312-337: synthesize -> encrypt -> verify, plus
    the tampered-ciphertext rejection."""
    pk, vk = api.synthesize_keys(16, backend="jax")
    msg = bytes(range(16))
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    proof = api.encrypt(msg, key, pk)
    ct = api.compute_ciphertext(msg, key)
    assert api.verify_encryption(vk, proof, ct)
    bad = bytearray(ct)
    bad[0] ^= 1
    assert not api.verify_encryption(vk, proof, bytes(bad))


@pytest.mark.gpu
@pytest.mark.slow
def test_serialized_proof_roundtrip_verifies(gpu):
    from aes_zero_knowledge_proof_circuit_tpu.utils.serialize import (
        deserialize_proof,
        serialize_proof,
    )

    pk, vk = api.synthesize_keys(16, backend="jax")
    msg = b"\x00" * 16
    key = b"\x01" * 16
    proof = api.encrypt(msg, key, pk)
    ct = api.compute_ciphertext(msg, key)
    blob = serialize_proof(proof)
    assert api.verify_encryption(vk, deserialize_proof(blob), ct)
