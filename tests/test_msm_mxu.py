"""Tests for the plain-form int8-MXU field engine and MSM.

Mirrors the reference's kernel-vs-host exactness strategy (SURVEY.md §4:
"NTT/MSM kernel tests vs slow host reference implementations"): every
device op is checked bit-exactly against Python bigints / the host
curve.  CPU runs use c=8 windows (small merge/fold graphs); on the card,
chip_smoke.py and scripts/bench_msm_mxu.py cross-check the lane against
the native Pippenger.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_mxu as MM
from aes_zero_knowledge_proof_circuit_tpu.ops import mxu_field as mf
from aes_zero_knowledge_proof_circuit_tpu.ops import msm_host
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
from aes_zero_knowledge_proof_circuit_tpu.ops.msm_jax import (
    scalars_to_digit_limbs,
)

CS = mf.const_arrays()


def _cols(vals):
    return jnp.asarray(mf.ints_to_cols(vals))


def _host_mul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = p if acc is None else acc.add(p)
        p = p.double()
        k >>= 1
    return acc


def _jac_to_affine(x, y, z):
    xs, ys, zs = (mf.cols_to_ints(np.asarray(a)) for a in (x, y, z))
    out = []
    for X, Y, Z in zip(xs, ys, zs):
        if Z % Q_MOD == 0:
            out.append(g1_infinity())
            continue
        zi = inv_mod(Z, Q_MOD)
        out.append(g1_point(X * zi * zi % Q_MOD,
                            Y * zi * zi * zi % Q_MOD))
    return out


class TestPlainField:
    def test_mul_add_sub_exact(self):
        random.seed(10)
        n = 32
        a = [random.randrange(Q_MOD) for _ in range(n)]
        b = [random.randrange(Q_MOD) for _ in range(n)]
        ac, bc = _cols(a), _cols(b)
        got = mf.cols_to_ints(mf.mul_pp(ac, bc, CS))
        assert got == [x * y % Q_MOD for x, y in zip(a, b)]
        got = mf.cols_to_ints(mf.add_pp(ac, bc))
        assert got == [(x + y) % Q_MOD for x, y in zip(a, b)]
        got = mf.cols_to_ints(mf.sub_pp(ac, bc, CS))
        assert got == [(x - y) % Q_MOD for x, y in zip(a, b)]

    def test_deep_chain_exact(self):
        """madd-shaped recurrence: every recurrent value passes through a
        (value-reducing) multiply each iteration — the band/value bounds
        the module documents."""
        random.seed(11)
        n = 16
        xv = [random.randrange(Q_MOD) for _ in range(n)]
        yv = [random.randrange(Q_MOD) for _ in range(n)]
        x, y = _cols(xv), _cols(yv)
        for _ in range(10):
            x2 = mf.mul_pp(x, x, CS)
            s = mf.add_pp(x2, y)
            d = mf.sub_pp(x2, x, CS, big=True)
            nx = mf.mul_pp(s, d, CS)
            ny = mf.sub_pp(mf.add_pp(nx, nx), mf.mul_pp(y, x, CS), CS)
            x, y = nx, ny
            xv, yv = (
                [(v * v + w) * (v * v - v) % Q_MOD
                 for v, w in zip(xv, yv)],
                [(2 * ((v * v + w) * (v * v - v)) - w * v) % Q_MOD
                 for v, w in zip(xv, yv)],
            )
        assert mf.cols_to_ints(x) == xv
        assert mf.cols_to_ints(y) == yv

    def test_fold_val(self):
        random.seed(12)
        vals = [random.randrange(2 ** 399) for _ in range(8)]
        cols = np.zeros((mf.PAD_IN, 8), np.int32)
        for i, v in enumerate(vals):
            for j in range(mf.PAD_IN):
                cols[j, i] = v & 0xFF
                v >>= 8
        out = mf.fold_val(jnp.asarray(cols), CS)
        got = mf.cols_to_ints(out)
        assert got == [v % Q_MOD for v in vals]
        # folded value < ~6N (rows above 48 clear) and band restored
        assert int(jnp.max(jnp.abs(out[49:]))) == 0
        assert int(jnp.max(out)) < 400


class TestPointOps:
    def setup_method(self):
        g = g1_generator()
        self.pts = [_host_mul(g, k) for k in (1, 5, 7, 11, 13, 17, 19, 23)]

    def test_madd_chain(self):
        P = self.pts
        ax, ay, az = _cols([int(P[0].x)]), _cols([int(P[0].y)]), _cols([1])
        exp = P[0]
        for q in P[1:5]:
            ax, ay, az = MM.madd_in(
                CS, ax, ay, az, _cols([int(q.x)]), _cols([int(q.y)]),
                jnp.zeros((1, 1), bool))
            exp = exp.add(q)
        got = _jac_to_affine(ax, ay, az)[0]
        assert (got.x, got.y) == (exp.x, exp.y)

    def test_madd_infinities(self):
        P = self.pts
        ax, ay, az = _cols([int(P[0].x)]), _cols([int(P[0].y)]), _cols([1])
        qx, qy = _cols([int(P[1].x)]), _cols([int(P[1].y)])
        # acc at infinity -> q
        ox, oy, oz = MM.madd_in(CS, ax * 0, ay * 0, az * 0, qx, qy,
                                jnp.zeros((1, 1), bool))
        got = _jac_to_affine(ox, oy, oz)[0]
        assert (got.x, got.y) == (P[1].x, P[1].y)
        # q at infinity -> acc
        ox, oy, oz = MM.madd_in(CS, ax, ay, az, qx, qy,
                                jnp.ones((1, 1), bool))
        got = _jac_to_affine(ox, oy, oz)[0]
        assert (got.x, got.y) == (P[0].x, P[0].y)

    def test_jac_add_and_double_guard(self):
        P = self.pts
        a = (_cols([int(P[2].x)]), _cols([int(P[2].y)]), _cols([1]))
        b = (_cols([int(P[3].x)]), _cols([int(P[3].y)]), _cols([1]))
        ox, oy, oz = MM.jac_add_in(CS, a, b)
        got = _jac_to_affine(ox, oy, oz)[0]
        exp = P[2].add(P[3])
        assert (got.x, got.y) == (exp.x, exp.y)
        # digit-identical operands take the doubling branch
        ox, oy, oz = MM.jac_add_in(CS, a, a)
        got = _jac_to_affine(ox, oy, oz)[0]
        exp = P[2].double()
        assert (got.x, got.y) == (exp.x, exp.y)

    def test_jac_double(self):
        P = self.pts
        a = (_cols([int(P[4].x)]), _cols([int(P[4].y)]), _cols([1]))
        ox, oy, oz = MM.jac_double_in(CS, a)
        got = _jac_to_affine(ox, oy, oz)[0]
        exp = P[4].double()
        assert (got.x, got.y) == (exp.x, exp.y)


class TestSignedDigits:
    @pytest.mark.parametrize("c", [8, 13])
    def test_round_trip(self, c):
        random.seed(13)
        sc = [random.randrange(R_MOD) for _ in range(16)]
        sc[:5] = [0, 1, R_MOD - 1, 1 << (c - 1), (1 << c) - 1]
        limbs = jnp.asarray(scalars_to_digit_limbs(sc))
        b, ng = MM.signed_digits(limbs, c)
        b = np.asarray(b).astype(np.int64)
        ng = np.asarray(ng)
        half = 1 << (c - 1)
        assert int(b.max()) <= half
        for i, s in enumerate(sc):
            v = sum(int(b[w, i]) * (-1 if ng[w, i] else 1) * (1 << (c * w))
                    for w in range(b.shape[0]))
            assert v == s


class TestMsmMxu:
    @pytest.mark.slow  # XLA:CPU scan over 32 windows
    def test_vs_host_msm(self):
        random.seed(14)
        g = g1_generator()
        n = 300
        # full-range multipliers: the engine's incomplete-add contract needs
        # points with no small linear relations (see msm_mxu docstring)
        ks = [random.randrange(1, R_MOD) for _ in range(n)]
        pts = [_host_mul(g, k) for k in ks]
        scalars = [random.randrange(R_MOD) for _ in range(n)]
        scalars[:4] = [0, 1, R_MOD - 1, 255]
        exp = msm_host.msm(pts, scalars)
        pp = MM.PlainPoints.from_affine(pts)
        limbs = scalars_to_digit_limbs(scalars)
        got = MM.msm_mxu(pp, limbs, c=8)
        assert (got.x, got.y, got.inf) == (exp.x, exp.y, exp.inf)

    def test_from_packed_matches_from_affine(self):
        g = g1_generator()
        pts = [_host_mul(g, k) for k in (3, 9, 27)]
        packed = np.zeros((3, 2, 24), np.uint32)
        for i, p in enumerate(pts):
            x, y = int(p.x), int(p.y)
            for j in range(24):
                packed[i, 0, j] = (x >> (16 * j)) & 0xFFFF
                packed[i, 1, j] = (y >> (16 * j)) & 0xFFFF
        a = MM.PlainPoints.from_packed(packed)
        b = MM.PlainPoints.from_affine(pts)
        assert bool(jnp.all(a.x == b.x)) and bool(jnp.all(a.y == b.y))


class TestMsmMxuSegmented:
    @pytest.mark.slow  # XLA:CPU scan, two segments
    def test_multi_segment_merge_vs_host(self, monkeypatch):
        """Forces the >MAX_SEGMENT path (64-byte-config MSM shape): two
        512-point segments per window, bucket-table merge, and the
        per-window dispatch-window sync (the 64B round-3 OOM fix)."""
        monkeypatch.setattr(MM, "MAX_SEGMENT_LOG", 9)
        random.seed(23)
        g = g1_generator()
        n = 600  # pads to 1024 = 2 segments
        ks = [random.randrange(1, R_MOD) for _ in range(n)]
        pts = [_host_mul(g, k) for k in ks]
        scalars = [random.randrange(R_MOD) for _ in range(n)]
        exp = msm_host.msm(pts, scalars)
        got = MM.msm_mxu(MM.PlainPoints.from_affine(pts),
                         scalars_to_digit_limbs(scalars), c=8, lanes=64)
        assert (got.x, got.y, got.inf) == (exp.x, exp.y, exp.inf)
