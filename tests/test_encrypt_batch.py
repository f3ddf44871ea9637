"""Batched proving API: mesh-sharded witness fill + independent proofs.

The full prove path at AES scale runs on the card (marked gpu); the CPU-mesh
tier validates the batched, sharded witness fill produces the correct
ciphertext bits for every message in the batch."""

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu import api
from aes_zero_knowledge_proof_circuit_tpu.ops.aes_host import encrypt_ecb
from aes_zero_knowledge_proof_circuit_tpu.utils.errors import (
    InvalidInputError,
)


def test_encrypt_batch_input_validation():
    tpl = api._template_cached(16)
    pk = api.AESProvingKey(marlin_pk=None, template=tpl)
    with pytest.raises(InvalidInputError):
        api.encrypt_batch([], b"k" * 16, pk)
    with pytest.raises(InvalidInputError):
        api.encrypt_batch([b"x" * 15], b"k" * 16, pk)
    with pytest.raises(InvalidInputError):
        api.encrypt_batch([b"x" * 16], b"short", pk)


@pytest.mark.slow
def test_batched_witness_fill_sharded_matches_oracle():
    import jax

    from aes_zero_knowledge_proof_circuit_tpu.parallel.mesh import make_mesh
    from aes_zero_knowledge_proof_circuit_tpu.ops.witness_jax import (
        evaluator_for,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    ndev = min(8, len(jax.devices()))
    mesh = make_mesh(ndev)
    tpl = api._template_cached(16)
    ev = evaluator_for(tpl.plan)
    batch = ndev
    msgs = [bytes([i] * 16) for i in range(batch)]
    key = bytes(range(16))
    mb = np.stack([np.asarray(api.bits_lsb_first(m), np.int32) for m in msgs])
    kb = np.tile(np.asarray(api.bits_lsb_first(key), np.int32), (batch, 1))
    sharding = NamedSharding(mesh, P(mesh.axis_names[0], None))
    mbd = jax.device_put(mb, sharding)
    kbd = jax.device_put(kb, sharding)
    zs = np.asarray(
        jax.jit(jax.vmap(lambda m, k: ev._evaluate(
            {"message": m, "key": k})))(jnp.asarray(mbd), jnp.asarray(kbd))
    )
    for i in range(batch):
        ct_bits = zs[i, 1 : tpl.r1cs.num_instance].reshape(16, 8)
        ct = (ct_bits * (1 << np.arange(8))).sum(1).astype(np.uint8)
        assert bytes(ct) == bytes(encrypt_ecb(msgs[i], key))
