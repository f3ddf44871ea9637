"""The device MSM's segmented bucket scan (ops/msm_mxu._scan) against a
host reference: per lane, a running sum of +-q that restarts at every
segment start and skips padding."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_mxu as MM
from aes_zero_knowledge_proof_circuit_tpu.ops import mxu_field as mf
from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    g1_generator,
    g1_infinity,
    g1_point,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import (
    Q_MOD,
    R_MOD,
    inv_mod,
)

STEPS = 5


def _affine(x, y, z):
    X, Y, Z = (int(v) for v in (x, y, z))
    if Z % Q_MOD == 0:
        return g1_infinity()
    zi = inv_mod(Z, Q_MOD)
    return g1_point(X * zi * zi % Q_MOD, Y * zi * zi * zi % Q_MOD)


@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_segmented_scan_vs_host(lanes):
    r = random.Random(lanes)
    g = g1_generator()
    n = STEPS * lanes
    # independent random points: the scan's incomplete add needs operands
    # with no small linear relations (msm_mxu module contract)
    pts = [g.mul_scalar(r.randrange(1, R_MOD)) for _ in range(n)]
    seg = np.array([[r.random() < 0.35 for _ in range(lanes)]
                    for _ in range(STEPS)])
    seg[0] = True
    neg = np.array([[r.random() < 0.5 for _ in range(lanes)]
                    for _ in range(STEPS)])
    valid = np.array([[r.random() < 0.8 for _ in range(lanes)]
                      for _ in range(STEPS)])
    valid[1, 0] = False                       # padding mid-segment
    seg[2, 0], valid[2, 0] = True, False      # segment starting on padding

    pp = MM.PlainPoints.from_affine(pts)      # [64, n], point s*lanes + l
    sx = jnp.asarray(np.asarray(pp.x).reshape(64, STEPS, lanes)
                     .transpose(1, 0, 2))
    sy = jnp.asarray(np.asarray(pp.y).reshape(64, STEPS, lanes)
                     .transpose(1, 0, 2))
    ox, oy, oz = MM._scan_jit(mf.const_arrays(), sx, sy, jnp.asarray(seg),
                              jnp.asarray(neg), jnp.asarray(valid))
    assert ox.shape == (STEPS, 64, lanes) and ox.dtype == jnp.int16
    ox, oy, oz = (np.asarray(a).astype(np.int64) for a in (ox, oy, oz))

    for lane in range(lanes):
        acc = g1_infinity()
        for s in range(STEPS):
            q = pts[s * lanes + lane]
            q = q.neg() if neg[s, lane] else q
            if not valid[s, lane]:
                q = g1_infinity()
            acc = q if seg[s, lane] else acc.add(q)
            got = _affine(*(mf.cols_to_ints(a[s][:, lane:lane + 1])[0]
                            for a in (ox, oy, oz)))
            assert got == acc, (lane, s)
