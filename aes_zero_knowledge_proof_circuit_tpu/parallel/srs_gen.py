"""SRS generation (powers of tau): native host ladder or device ladder.

The reference's `generate_universal_srs` (src/lib.rs:141) performs a ~4M-term
fixed-base G1 MSM on CPU (SURVEY.md §3.1 "HOT"). Here the scalar ladder and
the fixed-base multiplication run on device:

  1. host: 8-bit window tables T[w][d] = d * 2^(8w) G  (32 x 256 points)
  2. device: tau powers via log-depth scan; per power, gather one table
     entry per window and tree-add the 32 partials
  3. device: batched Jacobian -> affine normalization (one batch inversion)

The SRS is checkpointed by the caller (SURVEY.md §5 checkpoint/resume: "SRS
generation is the expensive restartable step worth checkpointing").
"""

from __future__ import annotations

import random as _random
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kzg
from ..ops.curve_host import AffinePoint, g1_generator, g1_infinity, g1_point, g2_generator
from ..ops.curve_jax import JacPoint, jac_add
from ..ops.field_f32 import fq_f32

from ..ops.field_params import R_MOD

from ..ops import poly_jax as P

FQ = fq_f32()
WINDOW = 8
N_WINDOWS = 32  # 256-bit scalars in 8-bit windows


class PackedPowers:
    """Lazy list-like view over packed affine G1 powers.

    Stores [N, 2, 24] uint32 standard-form limbs (the SRS checkpoint layout);
    materializes host AffinePoints only on item access, and exposes `.packed`
    for direct device upload (ops.msm_jax.DevicePoints.from_packed).
    """

    def __init__(self, packed: np.ndarray):
        self.packed = packed

    def __len__(self) -> int:
        return self.packed.shape[0]

    def _point(self, i: int) -> AffinePoint:
        x = sum(int(self.packed[i, 0, j]) << (16 * j) for j in range(24))
        y = sum(int(self.packed[i, 1, j]) << (16 * j) for j in range(24))
        if x == 0 and y == 0:
            return g1_infinity()
        return g1_point(x, y)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            rng = range(*idx.indices(len(self)))
            return [self._point(i) for i in rng]
        return self._point(idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self._point(i)


def _window_tables(g: AffinePoint) -> List[List[AffinePoint]]:
    """T[w][d] = d * 2^(8w) * G for d in 0..255 (host, ~8k point adds)."""
    tables = []
    base = g
    for w in range(N_WINDOWS):
        row = [g1_infinity(), base]
        for d in range(2, 256):
            row.append(row[-1].add(base))
        tables.append(row)
        for _ in range(WINDOW):
            base = base.double()
    return tables


def _tables_to_device(tables) -> JacPoint:
    """[W, 256] affine tables -> device Jacobian digit tensors (z=0 for
    d=0)."""
    from ..ops.field_f32 import ints_to_digits

    xs, ys, zs = [], [], []
    for row in tables:
        for p in row:
            if p.inf:
                xs.append(0)
                ys.append(0)
                zs.append(0)
            else:
                xs.append(p.x)
                ys.append(p.y)
                zs.append(1)
    d = FQ.D
    mont = lambda vals: jnp.asarray(ints_to_digits(FQ, vals)).reshape(
        N_WINDOWS, 256, d
    )
    return JacPoint(mont(xs), mont(ys), mont(zs))


def fixed_base_msm_device(table_dev: JacPoint, digits8: jnp.ndarray) -> JacPoint:
    """G_i = sum_w T[w][digit8[i, w]] via gathered tree-add (device)."""

    def body(w, acc):
        d = digits8[:, w]
        pt = JacPoint(
            table_dev.x[w, d], table_dev.y[w, d], table_dev.z[w, d]
        )
        return jac_add(acc, pt)

    n = digits8.shape[0]
    d0 = digits8[:, 0]
    acc = JacPoint(table_dev.x[0, d0], table_dev.y[0, d0], table_dev.z[0, d0])
    return jax.lax.fori_loop(1, N_WINDOWS, body, acc)


def jacobian_to_affine_packed(pts: JacPoint) -> np.ndarray:
    """Batched normalization: [N] Jacobian -> [N, 2, 24] packed standard-form
    affine limbs (infinity -> zeros). One batched Fq inversion."""
    one_digits = jnp.zeros((FQ.D,), jnp.float32).at[0].set(1.0)
    zinv = FQ.batch_inv(pts.z)
    zinv2 = FQ.mul(zinv, zinv)
    zinv3 = FQ.mul(zinv2, zinv)
    # de-montgomery-ize: REDC-mul by 1
    ax = FQ.mul(FQ.mul(pts.x, zinv2), one_digits[None, :])
    ay = FQ.mul(FQ.mul(pts.y, zinv3), one_digits[None, :])
    ax16 = np.asarray(FQ.to_canonical_limbs(ax))[:, :24]
    ay16 = np.asarray(FQ.to_canonical_limbs(ay))[:, :24]
    return np.stack([ax16, ay16], axis=1).astype(np.uint32)


def generate_srs_native(max_degree: int, rng: _random.Random) -> kzg.SRS:
    """Universal SRS via the native C++ fixed-base window ladder
    (native/zkhost.cpp zk_g1_powers_fixed_base) — the host-runtime analog of
    arkworks' KZG10::setup MSM (SURVEY.md §3.1). Returns None-equivalent by
    raising if the native library is unavailable; callers fall back to
    generate_srs_device / kzg.setup."""
    import logging

    from .. import native

    log = logging.getLogger(__name__)
    tau = rng.randrange(1, R_MOD)
    gamma = rng.randrange(1, R_MOD)
    g = g1_generator()
    n = max_degree + 1
    scalars = [1] * n
    for i in range(1, n):
        scalars[i] = scalars[i - 1] * tau % R_MOD
    log.info("native SRS: %d fixed-base powers", n)
    packed = native.g1_powers_fixed_base_packed(g, scalars)
    if packed is None:
        raise RuntimeError("native zkhost library unavailable")
    powers = PackedPowers(packed)
    assert powers[0] == g and powers[1] == g.mul_scalar(tau)
    gamma_g = g.mul_scalar(gamma)
    gamma_powers = [gamma_g]
    for _ in range(kzg.HIDING_POWERS):
        gamma_powers.append(gamma_powers[-1].mul_scalar(tau))
    h = g2_generator()
    return kzg.SRS(
        max_degree=max_degree,
        powers_g1=powers,
        gamma_powers_g1=gamma_powers,
        h=h,
        tau_h=h.mul_scalar(tau),
    )


def generate_srs_device(max_degree: int, rng: _random.Random,
                        chunk: int = 1 << 16) -> kzg.SRS:
    """Universal SRS with device fixed-base ladder, host-equivalent output."""
    tau = rng.randrange(1, R_MOD)
    gamma = rng.randrange(1, R_MOD)
    g = g1_generator()
    tables = _window_tables(g)
    table_dev = _tables_to_device(tables)

    n = max_degree + 1
    # tau powers (standard form) on device, chunked to bound memory
    packed_out = np.zeros((n, 2, 24), np.uint32)
    from ..ops.field_f32 import fr_f32

    fr = fr_f32()
    tau_mont = P.scalar(tau)
    start = 0
    tau_chunk_base = 1  # tau^start as python int
    while start < n:
        m = min(chunk, n - start)
        # powers tau^start .. tau^(start+m-1)
        pw = P.powers(tau_mont, m)
        base_mont = P.scalar(tau_chunk_base)
        pw = fr.mul(pw, base_mont[None, :])
        std16 = fr.to_canonical_limbs(pw)[..., :16]    # [m, 16] uint32
        digits8 = jnp.stack(
            [std16 & jnp.uint32(0xFF), (std16 >> jnp.uint32(8)) & jnp.uint32(0xFF)],
            axis=-1,
        ).reshape(m, 32).astype(jnp.int32)
        jac = fixed_base_msm_device(table_dev, digits8)
        packed_out[start : start + m] = jacobian_to_affine_packed(jac)
        tau_chunk_base = tau_chunk_base * pow(tau, m, R_MOD) % R_MOD
        start += m

    powers = PackedPowers(packed_out)
    # sanity anchors
    assert powers[0] == g
    assert powers[1] == g.mul_scalar(tau)

    gamma_g = g.mul_scalar(gamma)
    gamma_powers = [gamma_g]
    for _ in range(kzg.HIDING_POWERS):
        gamma_powers.append(gamma_powers[-1].mul_scalar(tau))
    h = g2_generator()
    return kzg.SRS(
        max_degree=max_degree,
        powers_g1=powers,
        gamma_powers_g1=gamma_powers,
        h=h,
        tau_h=h.mul_scalar(tau),
    )
