"""JAX zero-knowledge proving stack with the capabilities of
lambdaclass/AES_zero_knowledge_proof_circuit.

Top-level surface mirrors the reference crate root (src/lib.rs:47-174):
`synthesize_keys`, `encrypt`, `verify_encryption`, plus the re-exports
`generate_rand`, `deserialize_proof` and `Fr` (src/lib.rs:47,52).

Imports are lazy so that `import aes_zero_knowledge_proof_circuit_tpu`
stays cheap (no jax import) until an API symbol is touched.
"""

from __future__ import annotations

__version__ = "0.1.0"

_API_SYMBOLS = (
    "synthesize_keys",
    "encrypt",
    "verify_encryption",
    "compute_ciphertext",
    "bits_lsb_first",
    "generate_rand",
    "deserialize_proof",
    "Fr",
    # typed error tier (reference src/helpers/traits.rs:4-20)
    "ZkAesError",
    "SynthesisError",
    "InvalidInputError",
    "CapacityError",
    "SerializationError",
    "ProofError",
)

__all__ = list(_API_SYMBOLS) + ["api", "__version__"]


def __getattr__(name: str):
    if name in _API_SYMBOLS or name == "api":
        import importlib

        _api = importlib.import_module(".api", __name__)
        if name == "api":
            return _api
        return getattr(_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
