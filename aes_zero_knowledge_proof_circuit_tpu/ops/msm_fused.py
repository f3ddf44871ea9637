"""Work-optimal fused Pippenger MSM — single-dispatch bucket phase.

A re-creation of ark-ec VariableBaseMSM at the KZG commit/open call
sites (SURVEY.md §2b, §3.2 "KZG commit (MSM); HOT").

It is an alternative to two other formulations:
  * eager per-level dispatch (msm_jax._window_sums): ~10k dispatches per
    2^20 MSM;
  * fully-traced sort+segmented-scan: one dispatch, but log2(chunk) full
    width passes per window => ~512n point-adds vs Pippenger's ~W*n.

This module does the work-OPTIMAL bucket accumulation (exactly W adds per
point, the same count as CPU Pippenger's data phase) in one traced program:

  lanes: points are strided across P lanes; each lane owns a private
  bucket table, so a step's P*W scatter targets are unique by construction
  (no conflicts, no sort). One fori_loop step gathers the P*W bucket rows,
  mixed-adds the step's P points (broadcast over their W window digits),
  and scatters back. n/P sequential steps of [P*W, D]-wide vector math —
  wide enough to saturate the f32-digit engine, sequential-shallow enough
  to keep the graph at ONE mixed-add instance (flat compile time).

  merge: lane tables are halved log2(P) times with a batched jac_add
  (separate small dispatches — 9 launches, negligible); bucket suffix
  scans then produce  sum_d d*B_d  per window (eager hillis_scan at
  [W, B] width, trivial).

Digit 0 lands in bucket 0, which the suffix weighting never reads, so
zero digits and zero-padded points need no masking. Padding points are
infinity (z=0) and are skipped by the mixed-add's infinity select.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .curve_jax import JacPoint, jac_add, jac_double
from .field_f32 import fq_f32


def jac_madd(p: JacPoint, qx: jnp.ndarray, qy: jnp.ndarray,
             q_inf: jnp.ndarray) -> JacPoint:
    """Branchless mixed addition p(Jacobian) + q(affine) (madd-2007-bl).

    q_inf marks padding points; p at infinity (z == 0) yields q. The
    doubling degenerate (p == q as group elements) falls back to
    jac_double so the formula is total."""
    f = fq_f32()
    one = f.one_mont
    z1z1 = f.mul(p.z, p.z)
    u2 = f.mul(qx, z1z1)
    s2 = f.mul(f.mul(qy, p.z), z1z1)
    h = f.sub(u2, p.x)
    hh = f.mul(h, h)
    i4 = f.add(hh, hh)
    i4 = f.add(i4, i4)                      # 4*HH
    j = f.mul(h, i4)
    r = f.sub(s2, p.y)
    r = f.add(r, r)                          # 2*(S2-Y1)
    v = f.mul(p.x, i4)
    r2 = f.mul(r, r)
    x3 = f.sub(f.sub(r2, j), f.add(v, v))
    y1j = f.mul(p.y, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(y1j, y1j))
    zh = f.add(p.z, h)
    z3 = f.sub(f.sub(f.mul(zh, zh), z1z1), hh)
    general = JacPoint(x3, y3, z3)

    # degenerate handling
    p_inf = jnp.all(p.z == 0, axis=-1)
    x_eq = f.is_zero(h)
    y_eq = f.is_zero(f.sub(s2, p.y))
    is_dbl = jnp.logical_and(
        jnp.logical_not(p_inf), jnp.logical_and(x_eq, y_eq)
    )
    is_neg = jnp.logical_and(
        jnp.logical_not(p_inf), jnp.logical_and(x_eq, jnp.logical_not(y_eq))
    )
    dbl = jac_double(p, f)

    sel = f.select
    q_as_jac_z = jnp.broadcast_to(one, p.z.shape)
    out_x = sel(p_inf, qx, sel(is_dbl, dbl.x, general.x))
    out_y = sel(p_inf, qy, sel(is_dbl, dbl.y, general.y))
    out_z = sel(p_inf, q_as_jac_z, sel(is_dbl, dbl.z, general.z))
    zero = jnp.zeros_like(out_z)
    out_z = sel(is_neg, zero, out_z)
    # q at infinity: p unchanged
    out_x = sel(q_inf, p.x, out_x)
    out_y = sel(q_inf, p.y, out_y)
    out_z = sel(q_inf, p.z, out_z)
    return JacPoint(out_x, out_y, out_z)


def _expand_digits(digits16: jnp.ndarray, window_bits: int) -> jnp.ndarray:
    """[.., 16] 16-bit limbs -> [.., n_win] little-endian window digits."""
    per_limb = 16 // window_bits
    mask = jnp.uint32((1 << window_bits) - 1)
    parts = [
        (digits16 >> jnp.uint32(window_bits * j)) & mask
        for j in range(per_limb)
    ]
    return jnp.stack(parts, axis=-1).reshape(
        digits16.shape[:-1] + (digits16.shape[-1] * per_limb,)
    )


@functools.partial(jax.jit, static_argnums=(4, 5))
def _bucket_phase(px, py, pz, digits16, window_bits: int, lanes: int):
    """Lane-private bucket accumulation.

    px/py/pz: [steps, lanes, D] point coordinate digits (z==one for affine,
    all-zero rows = infinity padding); digits16: [steps, lanes, 16].
    Returns flattened bucket tables [lanes, W, B, D] x3."""
    steps = px.shape[0]
    d = px.shape[-1]
    w = 16 * (16 // window_bits)
    b = 1 << window_bits
    lane_w = jnp.arange(lanes * w, dtype=jnp.int32) // w * (w * b) \
        + (jnp.arange(lanes * w, dtype=jnp.int32) % w) * b

    tbl = jnp.zeros((lanes * w * b, d), jnp.float32)

    def step(i, st):
        tx, ty, tz = st
        qx = px[i]
        qy = py[i]
        qz = pz[i]
        dg = _expand_digits(digits16[i], window_bits).astype(jnp.int32)
        idx = lane_w + dg.reshape(-1)                      # [lanes*w]
        cur = JacPoint(tx[idx], ty[idx], tz[idx])
        rep = lambda a: jnp.repeat(a, w, axis=0)
        q_inf = jnp.all(qz == 0, axis=-1)
        out = jac_madd(cur, rep(qx), rep(qy), rep(q_inf))
        tx = tx.at[idx].set(out.x, unique_indices=True)
        ty = ty.at[idx].set(out.y, unique_indices=True)
        tz = tz.at[idx].set(out.z, unique_indices=True)
        return tx, ty, tz

    tx, ty, tz = jax.lax.fori_loop(0, steps, step, (tbl, tbl, tbl))
    return tx, ty, tz


@functools.lru_cache(maxsize=None)
def _halve_fn():
    def halve(x, y, z):
        h = x.shape[0] // 2
        a = JacPoint(x[:h], y[:h], z[:h])
        b = JacPoint(x[h:], y[h:], z[h:])
        o = jac_add(a, b)
        return o.x, o.y, o.z

    return jax.jit(halve)


def fused_window_sums(points: JacPoint, digits16: jnp.ndarray,
                      window_bits: int = 8, lanes: int = 512) -> JacPoint:
    """[n_win]-batched window sums, work-optimal single-dispatch bucket
    phase + log2(lanes) merge dispatches + eager bucket suffix fold."""
    from .scan_utils import hillis_scan
    from .msm_jax import _add_fn

    n = digits16.shape[0]
    w = 16 * (16 // window_bits)
    b = 1 << window_bits
    # lanes must be a power of two (the merge halves) and <= n
    lanes = min(lanes, 1 << max(0, n.bit_length() - 1))
    pad = (-n) % lanes
    if pad:
        zp = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
        )
        points = JacPoint(zp(points.x), zp(points.y), zp(points.z))
        digits16 = zp(digits16)
    steps = (n + pad) // lanes
    rs = lambda a: a.reshape((steps, lanes) + a.shape[1:])
    tx, ty, tz = _bucket_phase(
        rs(points.x), rs(points.y), rs(points.z), rs(digits16),
        window_bits, lanes,
    )
    # merge lane tables: halve log2(lanes) times
    halve = _halve_fn()
    cur = lanes
    while cur > 1:
        tx, ty, tz = halve(tx, ty, tz)
        cur //= 2
    buckets = JacPoint(
        tx.reshape(w, b, -1), ty.reshape(w, b, -1), tz.reshape(w, b, -1)
    )
    # window sum = sum_{j>=1} S_j,  S_j = sum_{d>=j} B_d  (per window,
    # batched over the leading W axis; scans along the bucket axis)
    add = _add_fn()
    swap = lambda p: JacPoint(
        jnp.swapaxes(p.x, 0, 1), jnp.swapaxes(p.y, 0, 1),
        jnp.swapaxes(p.z, 0, 1)
    )
    bt = swap(buckets)                       # [B, W, D]
    suffix = hillis_scan(add, bt, reverse=True)
    tail = JacPoint(suffix.x[1:], suffix.y[1:], suffix.z[1:])
    pad1 = JacPoint(
        jnp.zeros_like(tail.x[:1]), jnp.zeros_like(tail.y[:1]),
        jnp.zeros_like(tail.z[:1]),
    )
    tail = JacPoint(
        jnp.concatenate([tail.x, pad1.x]),
        jnp.concatenate([tail.y, pad1.y]),
        jnp.concatenate([tail.z, pad1.z]),
    )
    total = hillis_scan(add, tail, reverse=True)
    return JacPoint(total.x[0], total.y[0], total.z[0])
