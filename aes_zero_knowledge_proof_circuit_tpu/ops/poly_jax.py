"""Device-side polynomial toolbox over Fr f32-digit tensors.

The JAX counterpart of ops/poly_host.py used by the device Marlin prover
(marlin/prover_jax.py). A "dpoly" is a [len, D] float32 digit tensor of
Montgomery-form coefficients (low -> high). Everything composes the f32
field engine, the NTT engines, and constant-shape scans; no host round-trips
on the hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .field_f32 import _sync1, fr_f32, ints_to_digits
from .ntt_jax import ntt_engine

F = fr_f32()
D = F.D


def dpoly(ints) -> jnp.ndarray:
    """Host ints -> device Montgomery digit coefficients."""
    return jnp.asarray(ints_to_digits(F, ints))


def scalar(v: int) -> jnp.ndarray:
    """Host int -> [D] Montgomery digit vector."""
    return jnp.asarray(ints_to_digits(F, [v])[0])


def pad_to(p: jnp.ndarray, n: int) -> jnp.ndarray:
    assert p.shape[0] <= n, (p.shape, n)
    return jnp.pad(p, ((0, n - p.shape[0]), (0, 0)))


def add(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    n = max(p.shape[0], q.shape[0])
    return F.add(pad_to(p, n), pad_to(q, n))


def sub(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    n = max(p.shape[0], q.shape[0])
    return F.sub(pad_to(p, n), pad_to(q, n))


def scale(p: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    return F.mul(p, s[None, :])


# Above this log-size route through the chunked four-step decomposition:
# the monolithic radix-2 program keeps many [n, 34] f32 stage tensors
# live (the 64-byte config's 4n domain is 2^22), the chunked passes ~2.
import os as _os

FOURSTEP_LOG = int(_os.environ.get("ZKAES_NTT_FOURSTEP_LOG", "20"))


def ntt_to(log_n: int, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate a dpoly (len <= 2^log_n) on the canonical 2^log_n domain."""
    if log_n > FOURSTEP_LOG:
        return _four_step_local(log_n, coeffs, inverse=False)
    eng = ntt_engine(log_n)
    return eng.ntt(pad_to(coeffs, eng.n))


def intt(log_n: int, evals: jnp.ndarray) -> jnp.ndarray:
    if log_n > FOURSTEP_LOG:
        return _four_step_local(log_n, evals, inverse=True)
    return ntt_engine(log_n).intt(evals)


@functools.lru_cache(maxsize=None)
def _chunk_prog(log_sub: int, inverse: bool, post_twiddle: bool):
    """Jitted one-chunk program of the four-step NTT: a batched local
    (i)NTT along axis 0 of [n_sub, C, D], optionally followed by the
    inter-pass twiddle multiply."""
    from ..parallel.sharded_ntt import _batched_ntt

    def run(chunk, tw_chunk, args):
        out = _batched_ntt(log_sub, chunk, inverse, args)
        if post_twiddle:
            out = F.mul(out, tw_chunk)
        return out

    return jax.jit(run, static_argnames=())


def _four_step_local(log_n: int, x: jnp.ndarray, inverse: bool,
                     max_chunk_cols: int = 256) -> jnp.ndarray:
    """Single-device Bailey four-step (i)NTT for large domains.

    Identical math to parallel/sharded_ntt.py (which shards the n1 axis
    over a mesh); here the two batched passes run in COLUMN CHUNKS so the
    peak device footprint is ~2 full copies + one chunk instead of the
    monolithic program's ~30 stage buffers."""
    from ..parallel.sharded_ntt import _engine_args, _twiddle_matrix

    log_n1 = (log_n + 1) // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    n = n1 * n2
    a = pad_to(x, n).reshape(n2, n1, D)
    args1 = _engine_args(log_n1, inverse)
    args2 = _engine_args(log_n2, inverse)
    tw = jnp.asarray(_twiddle_matrix(log_n1, log_n2, inverse))

    # pass 1: NTT_n2 along axis 0, then twiddle — chunked over n1 columns
    c1 = min(max_chunk_cols, n1)
    prog1 = _chunk_prog(log_n2, inverse, True)
    parts = []
    for c0 in range(0, n1, c1):
        parts.append(prog1(a[:, c0 : c0 + c1], tw[:, c0 : c0 + c1], args2))
        _sync1(parts[-1])
    b = jnp.concatenate(parts, axis=1)
    del a, parts
    ct = jnp.transpose(b, (1, 0, 2))               # [n1, n2, D]
    del b

    # pass 2: NTT_n1 along axis 0 — chunked over n2 columns
    c2 = min(max_chunk_cols, n2)
    prog2 = _chunk_prog(log_n1, inverse, False)
    parts = []
    for c0 in range(0, n2, c2):
        parts.append(prog2(ct[:, c0 : c0 + c2], None, args1))
        _sync1(parts[-1])
    out = jnp.concatenate(parts, axis=1)
    # d[k1][k2] = X[k1*n2 + k2]: row-major flatten IS the output order
    # (inverse: both passes scale by 1/n1 and 1/n2 -> total 1/n)
    return out.reshape(n, D)


@functools.lru_cache(maxsize=None)
def _coset_powers(log_n: int, g: int, inverse: bool) -> jnp.ndarray:
    """Cached device table of coset scale factors g^i (or g^-i), i < n —
    recomputing it per ntt_coset call cost a scan per round-3 NTT."""
    from .field_params import R_MOD, inv_mod

    gg = inv_mod(g % R_MOD, R_MOD) if inverse else g % R_MOD
    return powers(scalar(gg), 1 << log_n)


def ntt_coset(log_n: int, coeffs: jnp.ndarray, g: int) -> jnp.ndarray:
    """Evaluate a dpoly on the coset g*<w_n>: scale coeff i by g^i, NTT.

    The coset trick lets round-3 compute h2 = (a - b f)/v_K directly on 2k
    points instead of materializing the 3k-degree product b*f on a 4k
    domain — the 2^21+ tensors there were the prover's OOM site. Routes
    through ntt_to/intt so big domains take the chunked four-step path."""
    n = 1 << log_n
    pw = _coset_powers(log_n, g, False)
    return ntt_to(log_n, F.mul(pad_to(coeffs, n), pw))


def intt_coset(log_n: int, evals: jnp.ndarray, g: int) -> jnp.ndarray:
    """Interpolate from evaluations on g*<w_n> (exact for deg < 2^log_n)."""
    pw = _coset_powers(log_n, g, True)
    return F.mul(intt(log_n, evals), pw)


def mul_polys(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Coefficient product via NTT (output length = len(p)+len(q)-1)."""
    out_len = p.shape[0] + q.shape[0] - 1
    log_n = max(1, (out_len - 1).bit_length())
    fp = ntt_to(log_n, p)
    fq = ntt_to(log_n, q)
    return intt(log_n, F.mul(fp, fq))[:out_len]


# Each log-depth scan helper below is wrapped in a shape-keyed jit: the
# eager composition costs O(log n) dispatches PER CALL. One dispatch per
# call.


# Scan programs above this length are CHUNKED: XLA's scheduler keeps ~30
# level temporaries of [n, D] live in one monolithic hillis program, so
# the working set grows with n; chunks bound it.
BIG_SCAN_N = 1 << 19


def _tree_sum_body(vals: jnp.ndarray) -> jnp.ndarray:
    from .scan_utils import hillis_scan

    return hillis_scan(F.add, vals, reverse=True)[0]


_tree_sum_j = jax.jit(_tree_sum_body)


def tree_sum(vals: jnp.ndarray) -> jnp.ndarray:
    """Sum along axis 0 (mod r): log-depth suffix scan; lengths above
    BIG_SCAN_N sum per chunk and combine (memory-bounded graphs)."""
    n = vals.shape[0]
    if n <= BIG_SCAN_N:
        return _tree_sum_j(vals)
    parts = []
    for c0 in range(0, n, BIG_SCAN_N):
        parts.append(_tree_sum_j(vals[c0 : c0 + BIG_SCAN_N]))
        _sync1(parts[-1])
    return _tree_sum_j(jnp.stack(parts))


def _powers_body(z: jnp.ndarray, n: int) -> jnp.ndarray:
    from .scan_utils import hillis_scan

    base = jnp.broadcast_to(z, (n, D)).astype(jnp.float32)
    first = jnp.broadcast_to(F.one_mont, (1, D)).astype(jnp.float32)
    seq = jnp.concatenate([first, base[: n - 1]], axis=0)
    return hillis_scan(F.mul, seq)


_powers_j = jax.jit(_powers_body, static_argnums=1)


def powers_chunks(z: jnp.ndarray, n: int, chunk: int | None = None):
    """1, z, ..., z^(n-1) as a list of [<=chunk, D] blocks: one scan
    program per chunk plus a running z^(k*chunk) offset multiply."""
    if chunk is None:
        chunk = BIG_SCAN_N  # read at call time (tests shrink it)
    if n <= chunk:
        return [_powers_j(z, n)]
    base = _powers_j(z, chunk)
    zc = F.mul(base[chunk - 1], z)          # z^chunk
    parts = [base]
    off = None
    for c0 in range(chunk, n, chunk):
        off = zc if off is None else F.mul(off, zc)
        m = min(chunk, n - c0)
        parts.append(F.mul(base[:m], off[None, :]))
        _sync1(parts[-1])
    return parts


def powers(z: jnp.ndarray, n: int) -> jnp.ndarray:
    """[n, D]: 1, z, z^2, ..., z^(n-1); log-depth scan, chunked above
    BIG_SCAN_N (the 64-byte config's h4 table has 2^22 rows)."""
    if n <= BIG_SCAN_N:
        return _powers_j(z, n)
    return jnp.concatenate(powers_chunks(z, n))


def _eval_at_body(p: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    pw = _powers_body(z, p.shape[0])
    return _tree_sum_body(F.mul(p, pw))


_eval_at_j = jax.jit(_eval_at_body)


def eval_at(p: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """p(z) for device point z ([D] Montgomery digits); returns [D]."""
    return _eval_at_j(p, z)


def _div_vanishing_body(p: jnp.ndarray, m: int):
    from .scan_utils import hillis_scan

    n = p.shape[0]
    blocks = -(-n // m)
    p_pad = pad_to(p, blocks * m).reshape(blocks, m, D)
    suffix = hillis_scan(F.add, p_pad, reverse=True)
    h = suffix[1:].reshape((blocks - 1) * m, D)
    rem = F.add(p_pad[0], suffix[1])
    return h, rem


_div_vanishing_j = jax.jit(_div_vanishing_body, static_argnums=1)


def div_vanishing(p: jnp.ndarray, m: int):
    """Divide by X^m - 1: returns (quotient, remainder[m]).

    Block suffix-sum formulation (h_{km+i} = sum_{l>k} p_{lm+i}), log-depth,
    one dispatch."""
    if p.shape[0] <= m:
        return jnp.zeros((1, D), jnp.float32), pad_to(p, m)
    return _div_vanishing_j(p, m)


def segment_sum_mod(values: jnp.ndarray, seg_ids: jnp.ndarray,
                    num_segments: int) -> jnp.ndarray:
    """Modular segment sum of [N, D] digit elements by [N] ids; inputs
    beyond the int32-exactness window run in chunks combined by field
    adds (the 64-byte config concatenates 3 x 2^21 rows)."""
    n = values.shape[0]
    if n < (1 << 21):
        return _segment_sum_mod_j(values, seg_ids, num_segments)
    acc = None
    for c0 in range(0, n, BIG_SCAN_N):
        part = _segment_sum_mod_j(values[c0 : c0 + BIG_SCAN_N],
                                  seg_ids[c0 : c0 + BIG_SCAN_N],
                                  num_segments)
        acc = part if acc is None else F.add(acc, part)
        _sync1(acc)
    return acc


@functools.partial(jax.jit, static_argnums=2)
def _segment_sum_mod_j(values: jnp.ndarray, seg_ids: jnp.ndarray,
                       num_segments: int) -> jnp.ndarray:
    """Digits (< 2^10) cast to int32 and integer-segment-summed (exact for
    N < 2^20), then the widened column sums fold back into fold-range
    Montgomery digits:   V = V_lo + R * V_hi,  V_hi * R = mul(V_hi, R^2).
    """
    n = values.shape[0]
    assert n < (1 << 21)
    ints = values.astype(jnp.int32)
    # digits can be slightly negative (fold leaves a band ~(-2, 260));
    # byte-splitting needs non-negative sums, so sum the positive and
    # negative parts separately and subtract in the field
    pos = jax.ops.segment_sum(jnp.maximum(ints, 0), seg_ids,
                              num_segments=num_segments)
    neg = jax.ops.segment_sum(jnp.maximum(-ints, 0), seg_ids,
                              num_segments=num_segments)

    def fold_sums(sums):
        # columns < 2^10 * N < 2^31; byte-split in integer space (f32 would
        # round above 2^24), accumulate on a width-2D grid
        width = 2 * D
        grid = jnp.zeros((num_segments, width), jnp.float32)
        for shift in range(4):
            part = ((sums >> (8 * shift)) & 0xFF).astype(jnp.float32)
            grid = grid + jnp.pad(part, ((0, 0), (shift, width - D - shift)))
        grid = F._norm(grid)
        v_lo = grid[..., :D]
        v_hi = grid[..., D:]                          # exactly D columns
        hi_part = F.mul(v_hi, F.r2_digits[None, :])   # V_hi * R mod r
        return F.add(F._fold(v_lo), hi_part)

    return F.sub(fold_sums(pos), fold_sums(neg))