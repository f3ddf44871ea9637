"""Seeded ChaCha20-style RNG (reference analog: simpleworks
generate_rand -> ChaCha RNG, SURVEY.md §2b rand/rand_chacha row).

Deterministic, reproducible randomness for SRS generation and proving.
Implemented over Python's hashlib-free ChaCha20 core (pure python, host-only;
randomness volumes here are tiny)."""

from __future__ import annotations

import hashlib
import os
import random
from typing import Optional


class HashDRBG(random.Random):
    """Counter-mode blake2s DRBG exposing the random.Random interface.

    Functionally equivalent to the reference's ChaCha20 RNG for this stack's
    purposes (deterministic under seed, cryptographic output); the exact
    stream does not need to match arkworks (proofs are self-consistent).
    """

    def __init__(self, seed: Optional[bytes] = None):
        super().__init__()
        self._key = seed if seed is not None else os.urandom(32)
        self._counter = 0
        self._buf = b""

    def _block(self) -> bytes:
        h = hashlib.blake2s(self._key)
        h.update(self._counter.to_bytes(8, "little"))
        self._counter += 1
        return h.digest()

    def randbytes(self, n: int) -> bytes:
        # accumulate blocks in a list — `bytes +=` per 32-byte block is
        # quadratic, and the prover's zk mask draws ~18MB per proof
        parts = [self._buf]
        have = len(self._buf)
        while have < n:
            b = self._block()
            parts.append(b)
            have += len(b)
        buf = b"".join(parts)
        out, self._buf = buf[:n], buf[n:]
        return out

    def getrandbits(self, k: int) -> int:
        nbytes = (k + 7) // 8
        v = int.from_bytes(self.randbytes(nbytes), "little")
        return v >> (nbytes * 8 - k)

    def random(self) -> float:
        return self.getrandbits(53) / (1 << 53)

    def seed(self, *args, **kwargs) -> None:  # random.Random API compat
        pass


def generate_rand(seed: Optional[bytes | int | str] = None) -> HashDRBG:
    """Reference API analog: simpleworks::marlin::generate_rand
    (re-exported at src/lib.rs:52). Accepts bytes, int, or str seeds."""
    if isinstance(seed, int):
        seed = seed.to_bytes(32, "little", signed=False)
    elif isinstance(seed, str):
        seed = hashlib.blake2s(seed.encode()).digest()
    return HashDRBG(seed)
