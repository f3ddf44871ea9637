"""Batched BLS12-377 G1 arithmetic over Fq float32-digit tensors (JAX).

A JAX equivalent of ark-ec's projective G1 ops (SURVEY.md §2b: "G1 point
add/double in Jacobian coords over 377-bit Fq as limb tensors"). Points are
pytrees (X, Y, Z) of [..., 50] float32 digit tensors (ops/field_f32.py);
Z digit-zero encodes infinity (infinity is only ever *created* as explicit
zeros, and exact zeros propagate through the f32 engine, so the digit test
is sound). The unified `add` is branchless — general and doubling formulas
evaluated and selected per lane — so it is safe inside scans (msm_jax.py).

Equality of intermediate values (the P==±Q detection) uses value-based
zero tests (f32 digits are redundant: h == 0 mod q does NOT mean digit-zero).

Bit-exact against ops/curve_host.AffinePoint (tests/test_msm_jax.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from .curve_host import g1_infinity, g1_point
from .field_f32 import F32Ops, digits_to_ints, fq_f32, ints_to_digits


class JacPoint(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray


def _is_inf(p: JacPoint) -> jnp.ndarray:
    return jnp.all(p.z == 0, axis=-1)


def jac_infinity(batch_shape: Tuple[int, ...] = ()) -> JacPoint:
    d = fq_f32().D
    z = jnp.zeros(batch_shape + (d,), jnp.float32)
    return JacPoint(z, z, z)


def jac_double(p: JacPoint, ops: F32Ops | None = None) -> JacPoint:
    """Jacobian doubling, a = 0 curve (y^2 = x^3 + 1)."""
    f = ops or fq_f32()
    a = f.mul(p.x, p.x)                  # X1^2
    b = f.mul(p.y, p.y)                  # Y1^2
    c = f.mul(b, b)                      # B^2
    t = f.add(p.x, b)
    d = f.sub(f.sub(f.mul(t, t), a), c)
    d = f.add(d, d)                      # 2((X1+B)^2 - A - C)
    e = f.add(f.add(a, a), a)            # 3A
    ff = f.mul(e, e)
    x3 = f.sub(ff, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(f.add(p.y, p.y), p.z)
    inf = _is_inf(p)
    zero = jnp.zeros_like(x3)
    return JacPoint(
        f.select(inf, zero, x3), f.select(inf, zero, y3), f.select(inf, zero, z3)
    )


def jac_add(p: JacPoint, q: JacPoint, ops: F32Ops | None = None) -> JacPoint:
    """Unified branchless Jacobian addition (handles O, P==Q, P==-Q)."""
    f = ops or fq_f32()
    z1z1 = f.mul(p.z, p.z)
    z2z2 = f.mul(q.z, q.z)
    u1 = f.mul(p.x, z2z2)
    u2 = f.mul(q.x, z1z1)
    s1 = f.mul(f.mul(p.y, q.z), z2z2)
    s2 = f.mul(f.mul(q.y, p.z), z1z1)
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)
    h2 = f.mul(h, h)
    h3 = f.mul(h, h2)
    v = f.mul(u1, h2)
    r2 = f.mul(r, r)
    x3 = f.sub(f.sub(r2, h3), f.add(v, v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, h3))
    z3 = f.mul(f.mul(p.z, q.z), h)
    general = JacPoint(x3, y3, z3)

    dbl = jac_double(p, f)
    p_inf = _is_inf(p)
    q_inf = _is_inf(q)
    x_eq = f.is_zero(h)   # value-based: digits are redundant
    y_eq = f.is_zero(r)
    both = jnp.logical_and(jnp.logical_not(p_inf), jnp.logical_not(q_inf))
    is_dbl = jnp.logical_and(both, jnp.logical_and(x_eq, y_eq))
    is_neg = jnp.logical_and(both, jnp.logical_and(x_eq, jnp.logical_not(y_eq)))

    sel = f.select
    out_x = sel(p_inf, q.x, sel(q_inf, p.x, sel(is_dbl, dbl.x, general.x)))
    out_y = sel(p_inf, q.y, sel(q_inf, p.y, sel(is_dbl, dbl.y, general.y)))
    out_z = sel(p_inf, q.z, sel(q_inf, p.z, sel(is_dbl, dbl.z, general.z)))
    zero = jnp.zeros_like(out_z)
    out_z = sel(is_neg, zero, out_z)
    return JacPoint(out_x, out_y, out_z)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def affine_to_device(points) -> JacPoint:
    """List of host AffinePoints -> batched Jacobian digit tensors."""
    ops = fq_f32()
    xs, ys, zs = [], [], []
    for p in points:
        if p.inf:
            xs.append(0)
            ys.append(0)
            zs.append(0)
        else:
            xs.append(p.x)
            ys.append(p.y)
            zs.append(1)
    return JacPoint(
        jnp.asarray(ints_to_digits(ops, xs)),
        jnp.asarray(ints_to_digits(ops, ys)),
        jnp.asarray(ints_to_digits(ops, zs)),
    )


def device_to_affine(p: JacPoint):
    """Batched Jacobian -> list of host AffinePoints.

    Normalizes on device with one batched inversion, then converts."""
    ops = fq_f32()
    inf = np.asarray(_is_inf(p))
    zinv = ops.batch_inv(p.z.reshape(-1, ops.D))
    zinv2 = ops.mul(zinv, zinv)
    zinv3 = ops.mul(zinv2, zinv)
    ax = digits_to_ints(ops, ops.mul(p.x.reshape(-1, ops.D), zinv2))
    ay = digits_to_ints(ops, ops.mul(p.y.reshape(-1, ops.D), zinv3))
    out = []
    for i, (x, y) in enumerate(zip(ax, ay)):
        if inf.reshape(-1)[i]:
            out.append(g1_infinity())
        else:
            out.append(g1_point(x, y))
    return out
