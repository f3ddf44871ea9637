"""Multi-chip Pippenger MSM: points sharded across the mesh.

SURVEY.md §2b "MSM parallelism: points+scalars sharded across chips, per-
window bucket accumulation local, bucket sums reduced". Each
device runs the local window-sum program (ops/msm_jax._window_sums) on its
point shard; the tiny [windows] point outputs are combined host-side
(num_devices * num_windows Jacobian adds — microseconds)."""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..ops.curve_host import AffinePoint, g1_infinity
from ..ops.curve_jax import JacPoint, device_to_affine
from ..ops.msm_jax import _window_sums, pick_window_bits


def msm_sharded(
    mesh: Mesh,
    points: JacPoint,
    digits16: jnp.ndarray,
    window_bits: int | None = None,
) -> AffinePoint:
    """MSM with the point array sharded over the mesh's (single) axis.

    Points/digits may be host or device arrays; each shard is placed on its
    device, the per-shard window sums run there, and the per-device
    partials are folded on host."""
    ndev = mesh.devices.size
    n = digits16.shape[0]
    # a shorter point array would silently misalign the per-device shards
    # after padding (scalar i must pair with point i everywhere)
    assert points.x.shape[0] == n, (
        f"points/scalars length mismatch: {points.x.shape[0]} vs {n}"
    )
    if window_bits is None:
        window_bits = pick_window_bits(max(1, n // ndev))
    # pad N to a multiple of the mesh size (zero digits contribute nothing)
    pad = (-n) % ndev
    if pad:
        zpad = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
        )
        points = JacPoint(zpad(points.x), zpad(points.y), zpad(points.z))
        digits16 = zpad(digits16)

    # Each device's shard runs the local window-sum program on that device
    # (jitted per device off the CPU, composed from field kernels on it;
    # see ops/msm_jax._jit_off_cpu); the per-device partials come to the
    # host for the fold.
    total = points.x.shape[0]
    shard_n = total // ndev
    devs = list(mesh.devices.flat)
    parts = []
    for d in range(ndev):
        sl = slice(d * shard_n, (d + 1) * shard_n)
        put = lambda a: jax.device_put(a, devs[d])
        local_pts = JacPoint(
            put(points.x[sl]), put(points.y[sl]), put(points.z[sl])
        )
        parts.append(
            _window_sums(local_pts, jax.device_put(digits16[sl], devs[d]),
                         window_bits)
        )
    # per-device partials live on different devices; pull each to host
    # before combining (a direct jnp.concatenate raises
    # "Received incompatible devices")
    host = [jax.device_get((p.x, p.y, p.z)) for p in parts]
    sx = jnp.asarray(np.concatenate([h[0] for h in host]))
    sy = jnp.asarray(np.concatenate([h[1] for h in host]))
    sz = jnp.asarray(np.concatenate([h[2] for h in host]))
    # [ndev * W] window sums -> host fold
    per_dev = device_to_affine(JacPoint(sx, sy, sz))
    n_win = len(per_dev) // ndev
    acc = g1_infinity()
    for w in reversed(range(n_win)):
        for _ in range(window_bits):
            acc = acc.double()
        for dev in range(ndev):
            acc = acc.add(per_dev[dev * n_win + w])
    return acc
