"""Plonk AES mapping tests (plonk/aes_map.py).

Fast tier checks the S-box/xtime pieces gate-by-gate against the native
AES tables; the full-circuit satisfaction + tamper case is slow-marked
(the ~272k-gate build takes ~a minute on the 2-CPU host); the device
proof runs through scripts/run_plonk_aes.py.
"""

import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops.aes_host import SBOX, encrypt_ecb
from aes_zero_knowledge_proof_circuit_tpu.plonk.aes_map import AesPlonkCircuit
from aes_zero_knowledge_proof_circuit_tpu.utils.errors import ZkAesError

MSG = bytes(range(16))
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def _eval_trace(ac, inputs):
    vals = {0: 0}
    for var, op in ac.trace:
        k = op[0]
        if k == 0:
            vals[var] = inputs[(op[1], op[2])]
        elif k == 1:
            _, x, y, qm, ql, qr, qc = op
            vals[var] = (qm * vals[x] * vals[y] + ql * vals[x]
                         + qr * vals[y] + qc) % (2**255)
        else:
            _, x, y, cx, cy = op
            vals[var] = cx * vals[x] + cy * vals[y]
    return vals


class TestPieces:
    def test_sbox_gates(self):
        ac = AesPlonkCircuit(build=False)
        bits = [ac._input(0, i) for i in range(8)]
        out = ac._sbox(bits)
        for byte in (0x00, 0x53, 0xFF, 0x3A):
            inputs = {(0, i): (byte >> i) & 1 for i in range(8)}
            vals = _eval_trace(ac, inputs)
            got = sum(vals[out[j]] << j for j in range(8))
            assert got == int(SBOX[byte])

    def test_xtime_gates(self):
        ac = AesPlonkCircuit(build=False)
        bits = [ac._input(0, i) for i in range(8)]
        out = ac._xtime(bits)
        for byte in (0x01, 0x80, 0xC3, 0x57):
            inputs = {(0, i): (byte >> i) & 1 for i in range(8)}
            vals = _eval_trace(ac, inputs)
            got = sum(vals[out[j]] << j for j in range(8))
            exp = ((byte << 1) ^ (0x1B if byte & 0x80 else 0)) & 0xFF
            assert got == exp


@pytest.mark.slow
class TestFullCircuit:
    def test_satisfies_and_tamper(self):
        ac = AesPlonkCircuit()
        ct = bytes(encrypt_ecb(MSG, KEY))
        assign = ac.assign(MSG, KEY)
        ac.circuit.wire_columns(assign, ac.public_values(ct))  # eager check
        bad = bytearray(ct)
        bad[5] ^= 0x40
        with pytest.raises(ZkAesError):
            ac.circuit.wire_columns(assign, ac.public_values(bytes(bad)))
