"""AES-128 R1CS circuit template (static, input-independent).

A re-creation of the reference's circuit layer
(src/aes_circuit.rs + src/helpers/mod.rs + the orchestration of
src/lib.rs:176-293 `encrypt_and_generate_constraints`). The circuit SHAPE is
input-independent (SURVEY.md §3.3), so this module synthesizes ONCE per
message length into a `Template`: finalized R1CS matrices + a compiled
witness-evaluation plan + per-stage constraint counts (the reference's
debug_constraint_system_status checkpoints, src/helpers/mod.rs:66-82).

Gadget semantics mirror the reference:
* S-box via conditional-select tree over the bit decomposition against 256
  byte constants (src/aes_circuit.rs:243-248 substitute_byte ->
  conditionally_select_power_of_two_vector; table :433-694).
* Key schedule over 44 32-bit words with per-4th-word rotate/substitute/
  round-constant xor (src/aes_circuit.rs:20-129 derive_keys).
* shift_rows as a pure wire permutation (src/aes_circuit.rs:268-334).
* mix_columns / gmix_column via shift, masked high bit, multiply-by-0x1B with
  ripple-carry adds, and the fixed xor chain (src/aes_circuit.rs:336-427,
  src/helpers/mod.rs:11-64).
* ciphertext allocated as public-input bits at the end and enforced equal
  (src/lib.rs:282-286), LSB-first per byte (src/helpers/mod.rs:84-93).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.aes_host import RCON, SBOX
from .gadgets import (
    Bool,
    Byte,
    Synth,
    Word,
    byte_const,
    byte_shift_left,
    byte_shift_right,
    byte_xor,
    bytes_to_word,
    word_const,
    word_to_bytes,
    word_xor,
)
from .witness_plan import CompiledPlan


# ---------------------------------------------------------------------------
# helpers (src/helpers/mod.rs)
# ---------------------------------------------------------------------------


def ripple_add(sy: Synth, a: Byte, b: Byte) -> Byte:
    """8-bit ripple-carry add, truth table of src/helpers/mod.rs:11-42:
    sum_i = carry ^ a_i ^ b_i;  carry' = (!carry & (a&b)) | (carry & (a|b))."""
    out: List[Bool] = []
    carry = Bool.const(0)
    for ai, bi in zip(a, b):  # LSB first (reference iterates BE reversed)
        out.append(sy.b_xor(sy.b_xor(carry, ai), bi))
        and_ab = sy.b_and(ai, bi)
        or_ab = sy.b_or(ai, bi)
        carry = sy.b_or(sy.b_and(carry.negate(), and_ab), sy.b_and(carry, or_ab))
    return tuple(out)


def multiply(sy: Synth, multiplicand: Byte, multiplier_const: int) -> Byte:
    """Shift-and-add multiply by a synthesis-time constant
    (src/helpers/mod.rs:44-64; the only call site uses the constant 0x1B,
    src/aes_circuit.rs:381, which keeps the circuit shape static)."""
    product = byte_const(0)
    for i in range(8):
        if (multiplier_const >> i) & 1:
            addend = byte_shift_left(multiplicand, i) if i else multiplicand
            product = ripple_add(sy, product, addend)
    return product


# ---------------------------------------------------------------------------
# AES circuit steps (src/aes_circuit.rs)
# ---------------------------------------------------------------------------


def lookup_table() -> List[Byte]:
    """256 S-box byte constants (src/aes_circuit.rs:433-694)."""
    return [byte_const(int(v)) for v in SBOX]


def substitute_byte(sy: Synth, byte: Byte, table: Sequence[Byte]) -> Byte:
    """S-box lookup: conditional-select tree over the 8 selector bits
    (src/aes_circuit.rs:243-248). Folding LSB-up halves the table per level;
    level 1 (constant operands) folds to wires, levels 2+ allocate one
    constraint per differing bit."""
    vals = list(table)
    for bit in byte:  # LSB first
        vals = [
            tuple(sy.b_select(bit, hi[j], lo[j]) for j in range(8))
            for lo, hi in zip(vals[0::2], vals[1::2])
        ]
    assert len(vals) == 1
    return vals[0]


def substitute_bytes(sy: Synth, state: Sequence[Byte],
                     table: Sequence[Byte]) -> List[Byte]:
    """src/aes_circuit.rs:250-266."""
    assert len(state) == 16
    return [substitute_byte(sy, b, table) for b in state]


def add_round_key(sy: Synth, state: Sequence[Byte],
                  round_key: Sequence[Byte]) -> List[Byte]:
    """Byte-wise XOR (src/aes_circuit.rs:214-241)."""
    assert len(state) == 16 and len(round_key) == 16
    return [byte_xor(sy, a, b) for a, b in zip(state, round_key)]


# shift_rows wire permutation (src/aes_circuit.rs:268-334): column-major 4x4
# state, row r rotated left by r.
_SHIFT_IDX = [(((c + r) % 4) * 4 + r) for c in range(4) for r in range(4)]


def shift_rows(state: Sequence[Byte]) -> List[Byte]:
    assert len(state) == 16
    return [state[i] for i in _SHIFT_IDX]


def gmix_column(sy: Synth, col: Sequence[Byte]) -> List[Byte]:
    """src/aes_circuit.rs:360-427: b_i = xtime(a_i) via shift/mask/xor-0x1B,
    then the fixed xor-chain matrix."""
    b: List[Byte] = []
    for c in col:
        # h = (c >> 7) & 0x01  (src/aes_circuit.rs:369-377)
        shifted = byte_shift_right(c, 7)
        one = byte_const(1)
        h = tuple(sy.b_and(x, y) for x, y in zip(shifted, one))
        partial = byte_shift_left(c, 1)
        b.append(byte_xor(sy, partial, multiply(sy, h, 0x1B)))
    a = list(col)
    x = byte_xor
    return [
        x(sy, x(sy, x(sy, x(sy, b[0], a[3]), a[2]), b[1]), a[1]),
        x(sy, x(sy, x(sy, x(sy, b[1], a[0]), a[3]), b[2]), a[2]),
        x(sy, x(sy, x(sy, x(sy, b[2], a[1]), a[0]), b[3]), a[3]),
        x(sy, x(sy, x(sy, x(sy, b[3], a[2]), a[1]), b[0]), a[0]),
    ]


def mix_columns(sy: Synth, state: Sequence[Byte]) -> List[Byte]:
    """src/aes_circuit.rs:336-357: per 4-byte column."""
    out: List[Byte] = []
    for i in range(4):
        out.extend(gmix_column(sy, state[4 * i : 4 * i + 4]))
    return out


def rotate_word_bytes(bts: Sequence[Byte]) -> List[Byte]:
    """rotate_left(1) on the 4 bytes of a word (src/aes_circuit.rs:169-185)."""
    return [bts[1], bts[2], bts[3], bts[0]]


def derive_keys(sy: Synth, secret_key: Sequence[Byte],
                table: Sequence[Byte]) -> List[List[Byte]]:
    """44-word key schedule -> 11 round keys of 16 bytes
    (src/aes_circuit.rs:20-129)."""
    assert len(secret_key) == 16
    words: List[Word] = [
        bytes_to_word(secret_key[0:4]),
        bytes_to_word(secret_key[4:8]),
        bytes_to_word(secret_key[8:12]),
        bytes_to_word(secret_key[12:16]),
    ]
    for i in range(4, 44):
        if i % 4 == 0:
            prev_bytes = word_to_bytes(words[i - 1])
            rotated = rotate_word_bytes(prev_bytes)
            substituted = [substitute_byte(sy, b, table) for b in rotated]
            sub_word = bytes_to_word(substituted)
            res = word_xor(sy, words[i - 4], sub_word)
            rcon = word_const(int(RCON[i // 4 - 1]) << 24)
            res = word_xor(sy, res, rcon)
        else:
            res = word_xor(sy, words[i - 4], words[i - 1])
        words.append(res)
    round_keys: List[List[Byte]] = []
    for r in range(11):
        rk: List[Byte] = []
        for w in words[4 * r : 4 * r + 4]:
            rk.extend(word_to_bytes(w))
        round_keys.append(rk)
    return round_keys


# ---------------------------------------------------------------------------
# full circuit (src/lib.rs:176-293)
# ---------------------------------------------------------------------------


@dataclass
class Template:
    """A compiled AES proof circuit for a fixed message length."""

    msg_len: int
    r1cs: object            # finalized models.r1cs.R1CS
    plan: CompiledPlan
    stage_log: List[Tuple[str, Dict[str, int]]]
    mode: str = "ecb"
    # per-round wire probes (build_template(probe=True) only): stage name
    # -> list of 16-Byte states, each Byte an 8-tuple of Bool wires. Lets
    # tests assert the TEMPLATE's intermediate values against the FIPS-197
    # round table, not just the oracle trace (integration_tests.rs:49-310).
    probes: object = None

    def probe_bytes(self, stage: str, index: int, z) -> bytes:
        """Decode a probed 16-byte state from a full z vector."""
        assert self.probes is not None, "build with probe=True"
        state = self.probes[stage][index]
        out = []
        for byte in state:
            v = 0
            for j, b in enumerate(byte):
                if b.var is None:
                    bit = b.c
                else:
                    zi = b.var if b.var >= 0 else self.r1cs.witness_z_index(
                        b.var)
                    bit = (b.c + b.q * int(z[zi])) % 2
                v |= bit << j
            out.append(v)
        return bytes(out)

    def witness_z(self, message: bytes, key: bytes,
                  iv: bytes | None = None) -> np.ndarray:
        """Full z vector (int32 bits) for concrete inputs (host evaluator;
        the JAX evaluator lives in ops/witness_jax.py)."""
        inputs = {
            "message": _bytes_to_bits(message),
            "key": _bytes_to_bits(key),
        }
        if self.mode == "cbc":
            assert iv is not None and len(iv) == 16
            inputs["iv"] = _bytes_to_bits(iv)
        return self.plan.evaluate(inputs)


def _bytes_to_bits(data: bytes) -> np.ndarray:
    arr = np.frombuffer(bytes(data), np.uint8)
    return ((arr[:, None] >> np.arange(8)) & 1).astype(np.int32).reshape(-1)


def build_template(msg_len: int, log_stages: bool = False,
                   mode: str = "ecb", probe: bool = False) -> Template:
    """Synthesize the full template for a msg_len-byte message (multiple of
    16). Mirrors encrypt() allocation order: message witnesses, key
    witnesses, circuit, ciphertext public inputs (src/lib.rs:60-114).

    mode="cbc" adds the reference's roadmap capability
    (tests/integration_tests.rs:1): a public 16-byte IV, with each block
    XORed with the previous ciphertext block before encryption."""
    assert msg_len % 16 == 0 and msg_len > 0
    assert mode in ("ecb", "cbc")
    sy = Synth()
    stage_log: List[Tuple[str, Dict[str, int]]] = []

    def log(stage: str) -> None:
        stage_log.append((stage, sy.cs.stats()))

    chain: List[Byte] | None = None
    if mode == "cbc":
        iv_bits = [sy.alloc_instance_input_bit("iv", i) for i in range(128)]
        chain = [tuple(iv_bits[8 * i : 8 * i + 8]) for i in range(16)]
        log("After allocating the IV")

    message = [
        tuple(sy.alloc_input_bit("message", 8 * i + j) for j in range(8))
        for i in range(msg_len)
    ]
    log("After allocating the message")
    key = [
        tuple(sy.alloc_input_bit("key", 8 * i + j) for j in range(8))
        for i in range(16)
    ]
    log("After allocating the secret key")

    table = lookup_table()
    log("After generating the lookup table")
    round_keys = derive_keys(sy, key, table)
    log("After deriving the round keys")

    probes = (
        {"start": [], "after_sub": [], "after_shift": [], "after_mix": []}
        if probe else None
    )

    def rec(stage: str, st) -> None:
        if probes is not None:
            probes[stage].append(list(st))

    computed_ct: List[Byte] = []
    for blk in range(msg_len // 16):
        block = message[16 * blk : 16 * blk + 16]
        if mode == "cbc":
            block = [byte_xor(sy, a, b) for a, b in zip(block, chain)]
        # round 0: raw key is round key 0 (src/lib.rs:196)
        state = add_round_key(sy, block, key)
        log(f"block {blk}: after add_round_key round 0")
        if blk == 0:
            rec("start", state)
        for rnd in range(1, 10):
            state = substitute_bytes(sy, state, table)
            if blk == 0:
                rec("after_sub", state)
            state = shift_rows(state)
            if blk == 0:
                rec("after_shift", state)
            state = mix_columns(sy, state)
            if blk == 0:
                rec("after_mix", state)
            state = add_round_key(sy, state, round_keys[rnd])
            if blk == 0:
                rec("start", state)
            log(f"block {blk}: after round {rnd}")
        # round 10: no mix_columns (src/lib.rs:241-270)
        state = substitute_bytes(sy, state, table)
        if blk == 0:
            rec("after_sub", state)
        state = shift_rows(state)
        if blk == 0:
            rec("after_shift", state)
        state = add_round_key(sy, state, round_keys[10])
        if blk == 0:
            rec("start", state)  # == the block-0 ciphertext
        log(f"block {blk}: after round 10")
        computed_ct.extend(state)
        if mode == "cbc":
            chain = state  # next block chains on this ciphertext

    # ciphertext as public input, LSB-first bits per byte (src/lib.rs:282-286)
    for byte in computed_ct:
        for bit in byte:
            sy.alloc_instance_bit(bit)
    log("After enforcing ciphertext equality")

    r1cs = sy.cs.finalized()
    plan = sy.plan.compile(r1cs)
    if log_stages:
        import logging

        lg = logging.getLogger(__name__)
        for stage, stats in stage_log:
            lg.debug("CONSTRAINT SYSTEM STATUS: %s %s", stage, stats)
    return Template(msg_len=msg_len, r1cs=r1cs, plan=plan,
                    stage_log=stage_log, mode=mode, probes=probes)
