"""Pippenger multi-scalar multiplication over the f32-digit field engine.

A JAX re-creation of ark-ec's VariableBaseMSM at the reference's KZG
commit/open call sites (SURVEY.md §2b, §3.2 "KZG commit (MSM); HOT").

SIMD-friendly Pippenger (SURVEY.md §7 "bucket scatter/accumulate without
data-dependent control flow — sort-based or segment-sum formulations"):

  window = 16 bits == one scalar limb, so the digit decomposition IS the
  standard-form limb tensor (no host bigint work on the hot path).
  Per window:
    1. argsort digits; gather points into digit order.
    2. segmented inclusive scan (associative, branchless jac_add) over the
       sorted points with segment flags at digit boundaries.
    3. scatter segment tails into the bucket table (digit 0 -> dump slot).
    4. suffix-scan buckets and tree-reduce:  sum_d d * B_d = sum_j S_j.
  Window results are combined host-side (16 tiny double/add chains).

Multi-chip sharding (points split across devices, psum of window sums) lives
in parallel/sharded_msm.py.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .curve_host import AffinePoint
from .curve_jax import JacPoint, affine_to_device, device_to_affine, jac_add, jac_infinity
from .field_params import FR_LIMBS, R_MOD
from .limbs import ints_to_limbs

WINDOW_BITS = 16
NUM_WINDOWS = FR_LIMBS  # 16 windows of 16 bits cover the 253-bit scalar


def _jit_off_cpu(fn):
    """Jit `fn` as one program on an accelerator; on the CPU compose its
    individually-jitted field kernels instead (jac_add alone takes >80 s
    to compile on XLA:CPU)."""
    return fn if jax.default_backend() == "cpu" else jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _add_fn():
    """Point-add unit for the scan levels, which are orchestrated eagerly
    in Python: one compiled shape, one dispatch per level."""
    return _jit_off_cpu(jac_add)


@functools.lru_cache(maxsize=None)
def _seg_combine_fn():
    """Segmented-scan combine (flag-gated jac_add)."""

    def combine(a, b):
        fa, pa = a
        fb, pb = b
        summed = jac_add(pa, pb)
        keep_b = fb[..., None] != 0
        x = jnp.where(keep_b, pb.x, summed.x).astype(pb.x.dtype)
        y = jnp.where(keep_b, pb.y, summed.y).astype(pb.y.dtype)
        z = jnp.where(keep_b, pb.z, summed.z).astype(pb.z.dtype)
        return (fa | fb, JacPoint(x, y, z))

    return _jit_off_cpu(combine)


def _segmented_add(flags: jnp.ndarray, pts: JacPoint) -> JacPoint:
    """Inclusive segmented scan: within each flagged segment, running sums.

    Constant-shape Hillis-Steele levels (ops/scan_utils.py) run eagerly with
    the platform-chosen combine granularity: one compile shape, log2(n)
    dispatches."""
    from .scan_utils import hillis_scan

    _, out = hillis_scan(_seg_combine_fn(), (flags, pts))
    return out


def _tree_reduce_sum(pts: JacPoint) -> JacPoint:
    """Sum all points along axis 0 (constant-shape suffix scan, element 0)."""
    from .scan_utils import hillis_scan

    suffix = hillis_scan(_add_fn(), pts, reverse=True)
    return JacPoint(suffix.x[0], suffix.y[0], suffix.z[0])


def _window_sums(points: JacPoint, digits16: jnp.ndarray,
                 window_bits: int) -> JacPoint:
    """Per window, sum_d d * B_d. Returns a [num_windows]-batched JacPoint.

    digits16 is the [N, 16] 16-bit limb decomposition; windows of
    window_bits in {4, 8, 16} are re-derived from it. The per-window body is
    traced ONCE via lax.map (unrolling all windows explodes compile time).
    """
    assert 16 % window_bits == 0
    num_buckets = 1 << window_bits
    per_limb = 16 // window_bits
    n = digits16.shape[0]
    add = _add_fn()
    # expand to [N, num_windows] little-endian window digits
    parts = [
        (digits16 >> jnp.uint32(window_bits * j)) & jnp.uint32(num_buckets - 1)
        for j in range(per_limb)
    ]
    digits = jnp.stack(parts, axis=-1).reshape(n, NUM_WINDOWS * per_limb)

    def one_window(d):
        d = d.astype(jnp.int32)
        order = jnp.argsort(d)
        ds = d[order]
        pw = JacPoint(points.x[order], points.y[order], points.z[order])
        first = jnp.ones((1,), jnp.uint32)
        flags = jnp.concatenate(
            [first, (ds[1:] != ds[:-1]).astype(jnp.uint32)]
        )
        scanned = _segmented_add(flags, pw)
        is_tail = jnp.concatenate([(ds[1:] != ds[:-1]), jnp.ones((1,), bool)])
        dump = num_buckets
        target = jnp.where(is_tail & (ds > 0), ds, dump)
        bx = jnp.zeros((num_buckets + 1, points.x.shape[-1]), points.x.dtype)
        by = jnp.zeros_like(bx)
        bz = jnp.zeros_like(bx)
        bx = bx.at[target].set(scanned.x)
        by = by.at[target].set(scanned.y)
        bz = bz.at[target].set(scanned.z)
        buckets = JacPoint(bx[:num_buckets], by[:num_buckets], bz[:num_buckets])
        # suffix sums S_j = sum_{d >= j} B_d for j >= 1; then sum_j S_j
        from .scan_utils import hillis_scan

        suffix = hillis_scan(add, buckets, reverse=True)
        tail = JacPoint(suffix.x[1:], suffix.y[1:], suffix.z[1:])
        pad = num_buckets - 1
        size = 1 << (pad - 1).bit_length()
        inf = jac_infinity((size - pad,))
        tail = JacPoint(
            jnp.concatenate([tail.x, inf.x]),
            jnp.concatenate([tail.y, inf.y]),
            jnp.concatenate([tail.z, inf.z]),
        )
        return _tree_reduce_sum(tail)

    # ALL windows in one batched op stream (vmap over the window axis).
    # The previous per-window Python loop multiplied the eager dispatch
    # count by num_windows — ~105s per 8-shard mesh MSM on the CPU-mesh
    # dryrun (round-4 faulthandler trace pinned it inside one_window's
    # hillis levels) — and, inside the traced shard_map program, unrolled
    # the graph 64x. vmap keeps one window's op count with batched shapes.
    return jax.vmap(one_window, in_axes=1, out_axes=0)(digits)


def scalars_to_digit_limbs(scalars: Sequence[int]) -> np.ndarray:
    """Standard-form scalars -> [N, 16] uint32 16-bit digits (host path;
    on-device path converts Montgomery coefficients with one REDC mul)."""
    return ints_to_limbs([s % R_MOD for s in scalars], FR_LIMBS)


def pick_window_bits(n: int) -> int:
    """Pippenger window heuristic constrained to divisors of the limb width:
    the bucket phase costs ~2*2^c adds/window, the data phase ~2n."""
    if n >= (1 << 14):
        return 16
    if n >= (1 << 6):
        return 8
    return 4


import os

# Bucket-phase chunk: bounds device memory (the segmented scan keeps ~5
# copies of the chunk live; 2^16 Jacobian f32-digit points ~ 40 MB/copy).
MSM_CHUNK = int(os.environ.get("ZKAES_MSM_CHUNK", 1 << 16))


def msm_device(points: JacPoint, digits16: jnp.ndarray,
               window_bits: int | None = None) -> AffinePoint:
    """MSM over device-resident points / 16-bit digit limbs; returns a host
    affine point.

    Default path: the eager per-level sort + segmented-scan formulation
    below, chunked above MSM_CHUNK points.  ZKAES_MSM_FUSED=1 selects the
    single-dispatch lane-private bucket program in msm_fused.py."""
    n = digits16.shape[0]
    # the fused single-dispatch program is opt-in (its scatter inside a
    # fori_loop compiles slowly); correctness is proven on CPU
    # (tests/test_msm_fused.py)
    if os.environ.get("ZKAES_MSM_FUSED") == "1":
        from .msm_fused import fused_window_sums

        wb = 8 if n >= 256 else 4
        wsums = fused_window_sums(points, digits16, wb)
        return _fold_windows(wsums, wb)
    if window_bits is None:
        window_bits = pick_window_bits(n)
    if n > MSM_CHUNK:
        # pad to a chunk multiple (zero digits land in the dump slot; padded
        # points are infinity) so every chunk reuses ONE compiled scan shape
        pad = (-n) % MSM_CHUNK
        if pad:
            zpad = jnp.zeros((pad,) + points.x.shape[1:], points.x.dtype)
            points = JacPoint(
                jnp.concatenate([points.x, zpad]),
                jnp.concatenate([points.y, zpad]),
                jnp.concatenate([points.z, zpad]),
            )
            digits16 = jnp.concatenate(
                [digits16, jnp.zeros((pad, digits16.shape[1]), digits16.dtype)]
            )
        add = _add_fn()
        wsums = None
        for s in range(0, n + pad, MSM_CHUNK):
            e = s + MSM_CHUNK
            part = _window_sums(
                JacPoint(points.x[s:e], points.y[s:e], points.z[s:e]),
                digits16[s:e], window_bits,
            )
            wsums = part if wsums is None else add(wsums, part)
    else:
        wsums = _window_sums(points, digits16, window_bits)
    return _fold_windows(wsums, window_bits)


def _fold_windows(wsums: JacPoint, window_bits: int) -> AffinePoint:
    """Combine [n_win] window sums host-side: result = sum_w 2^(c w) S_w."""
    window_pts = device_to_affine(wsums)
    from .curve_host import g1_infinity

    acc = g1_infinity()
    for p in reversed(window_pts):
        for _ in range(window_bits):
            acc = acc.double()
        acc = acc.add(p)
    return acc


def msm(points: Sequence[AffinePoint], scalars: Sequence[int]) -> AffinePoint:
    """Drop-in host-API MSM running the bucket phase on device.

    Signature-compatible with ops/msm_host.msm so kzg.commit can swap
    backends (msm_fn=msm_jax.msm).
    """
    from .curve_host import g1_infinity

    if len(points) == 0:
        return g1_infinity()
    pts = affine_to_device(points)
    digits = jnp.asarray(scalars_to_digit_limbs(scalars))
    return msm_device(pts, digits)


class DevicePoints:
    """SRS powers cached on device for repeated commits (prover hot path)."""

    def __init__(self, points):
        packed = getattr(points, "packed", None)
        if packed is not None:
            self.n = packed.shape[0]
            self.jac = self._from_packed(packed)
        else:
            self.n = len(points)
            self.jac = affine_to_device(points)

    @staticmethod
    def _from_packed(packed: np.ndarray) -> JacPoint:
        """[N, 2, 24] standard-form affine limbs -> device Jacobian digit
        tensors (no per-point host bigint work — the SRS checkpoint path).
        Converted in slices: the REDC mul's [m, 2D] temporaries would
        otherwise transiently cost several GB at SRS scale (~1M points)."""
        from .field_f32 import fq_f32

        fq = fq_f32()
        n = packed.shape[0]
        step = 1 << 17
        xs, ys, zs = [], [], []
        for s in range(0, n, step):
            raw = jnp.asarray(packed[s : s + step].astype(np.uint32))
            xd = fq.from_limb16(raw[:, 0, :])
            yd = fq.from_limb16(raw[:, 1, :])
            # to Montgomery form: REDC-mul standard digits by R^2
            xs.append(fq.mul(xd, fq.r2_digits[None, :]))
            ys.append(fq.mul(yd, fq.r2_digits[None, :]))
            finite = jnp.logical_or(
                jnp.any(raw[:, 0, :] != 0, axis=-1),
                jnp.any(raw[:, 1, :] != 0, axis=-1),
            )
            zs.append(
                jnp.where(finite[:, None], fq.one_mont[None, :], 0.0).astype(
                    jnp.float32
                )
            )
        cat = jnp.concatenate
        return JacPoint(cat(xs), cat(ys), cat(zs))

    def slice(self, start: int, length: int) -> JacPoint:
        # jnp slicing clips out-of-range silently; a short slice would
        # misalign points with scalars downstream — fail loudly instead
        assert start + length <= self.n, (
            f"SRS slice [{start}:{start + length}] exceeds {self.n} points"
        )
        return JacPoint(
            self.jac.x[start : start + length],
            self.jac.y[start : start + length],
            self.jac.z[start : start + length],
        )

    def msm(self, scalars: Sequence[int], offset: int = 0) -> AffinePoint:
        digits = jnp.asarray(scalars_to_digit_limbs(scalars))
        return msm_device(self.slice(offset, digits.shape[0]), digits)
