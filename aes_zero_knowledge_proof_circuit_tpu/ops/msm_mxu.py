"""Pippenger MSM on exact small-integer matrix products: plain-form field
math, signed windows.

The device MSM lane (the accelerator counterpart of ark-ec's
VariableBaseMSM at the KZG commit sites — SURVEY.md §2b ark-ec row, §7
step 5).  Per window: argsort the digits -> column-major landing of the
sorted points across `lanes` independent lanes -> a segmented running
sum down every lane (`lax.scan`, one mixed add per step) -> compact the
segment tails -> merge tails of the same bucket -> weighted bucket fold.

 1. **Field engine**: every Fq multiply runs through ops/mxu_field.py —
    ONE NTT-CRT convolution as matrix products of 7-bit planes (exact
    in full f32) plus one reduction product.  The layout is [digit, point], so the point axis
    is the wide one, and the adds cache forward transforms across the
    multiplies that share operands (12 transforms + 11 pointwise
    products per mixed add instead of 22 + 11).

 2. **Signed c-bit windows**: scalars decompose into ceil(253/c) digits
    in [-2^(c-1), 2^(c-1)] — half the buckets of unsigned windows for one
    extra select (conditional y-negation) per scan step.

Completeness contract (the reason the merge/fold phases are cheap):
EVERY addition in this MSM — scan, tail merge, suffix fold — uses an
INCOMPLETE add (no doubling / P==-Q branch; infinity handled by
flags/z==0).  Each intermediate operand is a small-integer combination
sum_i c_i * P_i  of the distinct input points with 0 < c_i <= 2^(c-1);
two such combinations colliding (equal or negated) is a nontrivial
polynomial identity in the SRS secret tau of degree < |SRS| with
coefficients << r, i.e. probability ~ deg/r < 2^-230 over the
(honestly sampled) SRS.  It holds for any point set with no known
nontrivial linear relations (SRS powers, random test points), which is
every call site in this prover.  It does NOT hold for adversarially
related points — this is the prover's own commit path, where a
(negligible-probability) miss yields an invalid proof, never an unsound
one.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .curve_host import AffinePoint, g1_infinity, g1_point
from .field_params import Q_MOD, inv_mod
from . import mxu_field as mf
from .mxu_field import PAD_IN

# window size: c=13 gives 20 windows of 4096 signed buckets on the
# accelerator; CPU tests use c=8 so the merge/fold graphs stay small
# enough for XLA:CPU to compile quickly.
WINDOW_BITS = 13
# points processed side by side in one scan step (capped by the MSM's
# padded size): wide enough that one step's products fill the card
LANES = 1 << 14
SCALAR_BITS = 253
# segment size for large MSMs: 2^20 keeps every 16-byte-proof MSM in one
# scan shape while bounding the 64-byte config's 2^21/2^22 MSMs to the
# same compiled shape.
MAX_SEGMENT_LOG = 20


def _n_windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def _buckets(c: int) -> int:
    return 1 << (c - 1)


# ---------------------------------------------------------------------------
# point containers ([PAD_IN, P] int32 digit columns, digit axis FIRST)
# ---------------------------------------------------------------------------


class PlainPoints:
    """Affine G1 points as plain digit columns on device: x, y [64, N]
    **uint8** (canonical digits; 4x less HBM than int32 — the 2^22 SRS
    is 0.54 GB instead of 2.1, which is what lets the 64-byte prover fit
    beside it).

    Built from the SRS checkpoint's packed [N, 2, 24] uint32 16-bit limb
    array with two cheap bit ops — no host bigint work and no Montgomery
    conversion (plain form IS the checkpoint form)."""

    def __init__(self, x_dig: jnp.ndarray, y_dig: jnp.ndarray):
        self.x = x_dig
        self.y = y_dig
        self.n = x_dig.shape[1]

    @classmethod
    def from_packed(cls, packed: np.ndarray) -> "PlainPoints":
        cols = []
        for c in range(2):
            limbs = jnp.asarray(packed[:, c, :].astype(np.int32))  # [N, 24]
            lo = limbs & 0xFF
            hi = limbs >> 8
            dig = jnp.stack([lo, hi], axis=-1).reshape(-1, 48)     # [N, 48]
            dig = jnp.pad(dig, ((0, 0), (0, PAD_IN - 48)))
            cols.append(dig.T.astype(jnp.uint8))                   # [64, N]
        return cls(cols[0], cols[1])

    @classmethod
    def from_affine(cls, points) -> "PlainPoints":
        xs = [0 if p.inf else int(p.x) for p in points]
        ys = [0 if p.inf else int(p.y) for p in points]
        return cls(jnp.asarray(mf.ints_to_cols(xs)).astype(jnp.uint8),
                   jnp.asarray(mf.ints_to_cols(ys)).astype(jnp.uint8))

    def slice(self, start: int, length: int) -> "PlainPoints":
        assert start + length <= self.n, (
            f"point slice [{start}:{start + length}] exceeds {self.n}")
        return PlainPoints(self.x[:, start:start + length],
                           self.y[:, start:start + length])


# ---------------------------------------------------------------------------
# incomplete point arithmetic (digit axis first, any batch shape after)
# ---------------------------------------------------------------------------


def _inf_mask(z):
    """[64, *B] -> [1, *B] bool: column is the point at infinity (z==0)."""
    return jnp.all(z == 0, axis=0, keepdims=True)


def _scale4(e):
    """x4 on a transform pair (linearity of the NTT)."""
    return tuple(mf.eval_scale(e[i], 4, p) for i, p in enumerate(mf.PRIMES))


def _esum(ea, eb):
    """Transform of a sum (linearity), re-reduced below p."""
    return tuple(mf._mod_p(ea[i] + eb[i], p)
                 for i, p in enumerate(mf.PRIMES))


def madd_in(cs, ax, ay, az, qx, qy, q_inf):
    """Incomplete mixed add acc(Jacobian) + q(affine, infinity-by-flag).

    madd-2007-bl: Z1Z1=Z1^2; U2=X2*Z1Z1; S2=Y2*Z1*Z1Z1; H=U2-X1; HH=H^2;
    I=4HH; J=H*I; r=2(S2-Y1); V=X1*I; X3=r^2-J-2V; Y3=r(V-X3)-2*Y1*J;
    Z3=(Z1+H)^2-Z1Z1-HH.  Forward transforms are cached across shared
    operands; the 4x scalings and the (Z1+H) sum ride NTT linearity.
    Assumes acc != +-q as group elements (module contract)."""
    T, I = mf.tr, mf.mul_ee
    e_az = T(az, cs)
    z1z1 = I(e_az, e_az, cs)
    e_z = T(z1z1, cs)
    u2 = I(T(qx, cs), e_z, cs)
    s1 = I(T(qy, cs), e_az, cs)
    s2 = I(T(s1, cs), e_z, cs)
    h = mf.sub_pp(u2, ax, cs, big=True)          # ax: prior x3, < ~2^396
    e_h = T(h, cs)
    hh = I(e_h, e_h, cs)
    e_hh = T(hh, cs)
    j = I(_scale4(e_h), e_hh, cs)                # J = H * 4HH
    v = I(_scale4(T(ax, cs)), e_hh, cs)          # V = X1 * 4HH
    rr = mf.sub_pp(s2, ay, cs, big=True)         # ay: prior y3, < ~2^395
    r = mf.add_pp(rr, rr)
    e_r = T(r, cs)
    r2 = I(e_r, e_r, cs)
    x3 = mf.sub_pp(mf.sub_pp(r2, j, cs), mf.add_pp(v, v), cs)
    vmx = mf.sub_pp(v, x3, cs, big=True)
    t1 = I(e_r, T(vmx, cs), cs)
    ayj = I(T(ay, cs), T(j, cs), cs)
    y3 = mf.sub_pp(t1, mf.add_pp(ayj, ayj), cs)
    sq = I(_esum(e_az, e_h), _esum(e_az, e_h), cs)
    z3 = mf.sub_pp(mf.sub_pp(sq, z1z1, cs), hh, cs)

    a_inf = _inf_mask(az)
    one = jnp.zeros_like(az) + cs[12].reshape((-1,) + (1,) * (az.ndim - 1))
    ox = jnp.where(a_inf, qx, jnp.where(q_inf, ax, x3))
    oy = jnp.where(a_inf, qy, jnp.where(q_inf, ay, y3))
    oz = jnp.where(a_inf, jnp.where(q_inf, az, one),
                   jnp.where(q_inf, az, z3))
    return ox, oy, oz


def jac_double_in(cs, p):
    """Jacobian doubling on the a=0 curve (dbl-2009-l):
    A=X^2; B=Y^2; C=B^2; D=2((X+B)^2-A-C); E=3A; F=E^2;
    X3=F-2D; Y3=E(D-X3)-8C; Z3=2YZ.  Infinity (z==0) passes through
    (all outputs scale by z-powers and stay 0)."""
    T, I = mf.tr, mf.mul_ee
    px, py, pz = p
    e_x = T(px, cs)
    a = I(e_x, e_x, cs)
    e_y = T(py, cs)
    b = I(e_y, e_y, cs)
    e_b = T(b, cs)
    c = I(e_b, e_b, cs)
    xb = mf.add_pp(px, b)
    e_xb = T(xb, cs)
    sq = I(e_xb, e_xb, cs)
    d0 = mf.sub_pp(mf.sub_pp(sq, a, cs, big=True), c, cs)
    # fold D's value (~2^397) back under 6N so the X3/Y3 subtraction
    # offsets keep headroom below the 2^400 representation cap
    d = mf.fold_val(mf.add_pp(d0, d0), cs)
    e3 = mf.add_pp(mf.add_pp(a, a), a)
    e_e = T(e3, cs)
    f = I(e_e, e_e, cs)
    x3 = mf.sub_pp(f, mf.add_pp(d, d), cs, big=True)
    dmx = mf.sub_pp(d, x3, cs, big=True)
    t1 = I(e_e, T(dmx, cs), cs)
    c8 = mf.add_pp(mf.add_pp(c, c), mf.add_pp(c, c))
    c8 = mf.add_pp(c8, c8)
    y3 = mf.sub_pp(t1, c8, cs, big=True)
    yz = I(e_y, T(pz, cs), cs)
    z3 = mf.add_pp(yz, yz)
    return x3, y3, z3


def jac_add_in(cs, p, q):
    """Incomplete Jacobian + Jacobian (add-2007-bl), infinity via z==0,
    with a DIGIT-EQUALITY doubling guard: in the suffix-fold phases,
    equal operands legitimately occur when a run of buckets is empty —
    and when they do, they are digit-identical tensors (the same values
    copied through the scan), so a cheap representation-equality test
    catches exactly those cases without any canonicalization.  Group-
    equal but digit-different operands remain excluded by the module's
    subset-sum contract.  p, q: triples of [64, *B]."""
    T, I = mf.tr, mf.mul_ee
    px, py, pz = p
    qx, qy, qz = q
    e_pz = T(pz, cs)
    e_qz = T(qz, cs)
    z1z1 = I(e_pz, e_pz, cs)
    z2z2 = I(e_qz, e_qz, cs)
    e_z1z1 = T(z1z1, cs)
    e_z2z2 = T(z2z2, cs)
    u1 = I(T(px, cs), e_z2z2, cs)
    u2 = I(T(qx, cs), e_z1z1, cs)
    s1a = I(T(py, cs), e_qz, cs)
    s1 = I(T(s1a, cs), e_z2z2, cs)
    s2a = I(T(qy, cs), e_pz, cs)
    s2 = I(T(s2a, cs), e_z1z1, cs)
    h = mf.sub_pp(u2, u1, cs)
    e_h = T(h, cs)
    hh = I(e_h, e_h, cs)
    e_hh = T(hh, cs)
    j = I(_scale4(e_h), e_hh, cs)                # J = H * (2H)^2
    v = I(_scale4(T(u1, cs)), e_hh, cs)          # V = U1 * (2H)^2
    rr = mf.sub_pp(s2, s1, cs)
    r = mf.add_pp(rr, rr)
    e_r = T(r, cs)
    r2 = I(e_r, e_r, cs)
    x3 = mf.sub_pp(mf.sub_pp(r2, j, cs), mf.add_pp(v, v), cs)
    vmx = mf.sub_pp(v, x3, cs, big=True)
    t1 = I(e_r, T(vmx, cs), cs)
    s1j = I(T(s1, cs), T(j, cs), cs)
    y3 = mf.sub_pp(t1, mf.add_pp(s1j, s1j), cs)
    sq = I(_esum(e_pz, e_qz), _esum(e_pz, e_qz), cs)
    w = mf.sub_pp(mf.sub_pp(sq, z1z1, cs), z2z2, cs)
    z3 = I(T(w, cs), e_h, cs)

    dblx, dbly, dblz = jac_double_in(cs, p)
    same = jnp.all(
        jnp.logical_and(px == qx, jnp.logical_and(py == qy, pz == qz)),
        axis=0, keepdims=True)
    x3 = jnp.where(same, dblx, x3)
    y3 = jnp.where(same, dbly, y3)
    z3 = jnp.where(same, dblz, z3)

    p_inf = _inf_mask(pz)
    q_inf = _inf_mask(qz)
    ox = jnp.where(p_inf, qx, jnp.where(q_inf, px, x3))
    oy = jnp.where(p_inf, qy, jnp.where(q_inf, py, y3))
    oz = jnp.where(p_inf, qz, jnp.where(q_inf, pz, z3))
    return ox, oy, oz


# ---------------------------------------------------------------------------
# signed digit decomposition
# ---------------------------------------------------------------------------


def signed_digits(limbs16: jnp.ndarray, c: int = WINDOW_BITS):
    """[n, 16] uint32 16-bit limbs of standard scalars (< r < 2^253) ->
    (buckets [W, n] int32 in [0, 2^(c-1)], neg [W, n] bool): signed
    base-2^c digits d_i in [-2^(c-1), 2^(c-1)], s = sum d_i 2^(c i)."""
    limbs = limbs16.astype(jnp.uint32)
    half, full = 1 << (c - 1), 1 << c
    raw = []
    for i in range(_n_windows(c)):
        bit = c * i
        j, off = bit // 16, bit % 16
        w = limbs[:, j] >> off
        if off + c > 16 and j + 1 < 16:
            w = w | (limbs[:, j + 1] << (16 - off))
        raw.append(w & (full - 1))
    buckets, negs = [], []
    carry = jnp.zeros_like(raw[0])
    for i in range(_n_windows(c)):
        t = raw[i] + carry
        neg = t >= half                    # shift to [-half, 0)
        d = jnp.where(neg, full - t, t)    # magnitude
        carry = neg.astype(jnp.uint32)
        buckets.append(d.astype(jnp.int32))
        negs.append(jnp.logical_and(neg, d != 0))
    # top digit never re-signs (scalars < 2^253 leave headroom): with
    # c | 16 the final window is partial; carry dies in the top digit
    return jnp.stack(buckets), jnp.stack(negs)


# ---------------------------------------------------------------------------
# segmented bucket scan (lax.scan over steps, points across lanes)
# ---------------------------------------------------------------------------


def _scan_body(cs, acc, step):
    """One scan step over every lane: acc := q at a segment start (or
    infinity when q is padding), acc := acc + (+-q) otherwise."""
    ax, ay, az = acc
    qx, qy, seg, neg, valid = step
    qx = qx.astype(jnp.int32)                   # points stream as uint8
    qy = qy.astype(jnp.int32)
    seg, neg, valid = seg[None], neg[None], valid[None]
    # conditional negation: -y = (2^18*N - y) carried back to band
    qy = jnp.where(neg, mf.carry2(cs[10] - qy, PAD_IN), qy)
    sx, sy, sz = madd_in(cs, ax, ay, az, qx, qy, jnp.logical_not(valid))
    one = jnp.zeros_like(az) + cs[12]
    zero = jnp.zeros_like(az)
    ax = jnp.where(seg, jnp.where(valid, qx, zero), sx)
    ay = jnp.where(seg, jnp.where(valid, qy, zero), sy)
    az = jnp.where(seg, jnp.where(valid, one, zero), sz)
    # streams narrow to int16: band digits stay in (-2, ~900)
    out = (ax.astype(jnp.int16), ay.astype(jnp.int16), az.astype(jnp.int16))
    return (ax, ay, az), out


def _scan(cs, sx, sy, seg, neg, valid):
    """Segmented running sums down each lane.

    sx, sy: [steps, PAD_IN, lanes] uint8 affine digits; seg/neg/valid:
    [steps, lanes] bool (new segment, negate q, q present).  Returns the
    accumulator after every step as three [steps, PAD_IN, lanes] int16
    streams.  Lanes are independent, so one step is a [PAD_IN, lanes]-wide
    mixed add; the steps run in order inside one program."""
    lanes = sx.shape[-1]
    acc0 = tuple(jnp.zeros((PAD_IN, lanes), jnp.int32) for _ in range(3))
    _, out = jax.lax.scan(functools.partial(_scan_body, cs), acc0,
                          (sx, sy, seg, neg, valid))
    return out


_scan_jit = jax.jit(_scan)


# ---------------------------------------------------------------------------
# per-window program: sort -> scan -> compact tails -> segmented merge
# ---------------------------------------------------------------------------


def _prep_window(px, py, dwin, neg, valid, lanes: int):
    """Sort/gather/flags for one window (data movement only).  The sorted
    order lands column-major: lane l holds sorted positions
    [l*steps, (l+1)*steps), so each lane walks a contiguous run of
    buckets."""
    n = dwin.shape[0]
    steps = n // lanes
    order = jnp.argsort(dwin)
    oc = order.reshape(lanes, steps).swapaxes(0, 1)        # [steps, lanes]
    ds = dwin[oc]
    sx = jnp.moveaxis(px[:, oc], 0, 1)                     # [steps, 64, L]
    sy = jnp.moveaxis(py[:, oc], 0, 1)                     # (uint8)
    first = jnp.ones((1, lanes), bool)
    newseg = jnp.concatenate([first, ds[1:] != ds[:-1]], axis=0)
    return sx, sy, newseg, neg[oc], valid[oc], ds


@functools.lru_cache(maxsize=None)
def _prep_window_jit(lanes: int):
    return jax.jit(functools.partial(_prep_window, lanes=lanes))


def _compact_tails(ox, oy, oz, ds, newseg, c: int):
    """Extract segment tails from the scan stream, compacted and sorted
    by bucket.  At most one tail per (lane, bucket) run, so a window has
    at most B + lanes of them."""
    lanes = ds.shape[1]
    buckets_c = _buckets(c)
    tail_cap = buckets_c + lanes
    last = jnp.ones((1, lanes), bool)
    is_tail = jnp.concatenate([newseg[1:], last], axis=0)
    real = jnp.logical_and(is_tail, ds > 0)                # drop dump runs
    big = jnp.int32(buckets_c + 2)
    # lane-major flatten (l*steps + s): each lane's digits ascend with s
    # and lane l's run precedes lane l+1's in the global sort, so real
    # tails are already bucket-sorted in this order; the stable argsort
    # just compacts them to the front.
    key_lm = jnp.where(real, ds, big).swapaxes(0, 1).reshape(-1)
    idx = jnp.argsort(key_lm, stable=True)[:tail_cap]
    cbucket = key_lm[idx]

    def flat_lm(a):                                        # [steps, 64, L]
        return jnp.transpose(a, (2, 0, 1)).reshape(-1, PAD_IN)

    cx = flat_lm(ox)[idx].T.astype(jnp.int32)              # [64, tail_cap]
    cy = flat_lm(oy)[idx].T.astype(jnp.int32)
    cz = flat_lm(oz)[idx].T.astype(jnp.int32)
    pad_inf = (cbucket >= big)[None, :]
    cz = jnp.where(pad_inf, 0, cz)
    return cx, cy, cz, cbucket


@functools.lru_cache(maxsize=None)
def _compact_tails_jit(c: int):
    return jax.jit(functools.partial(_compact_tails, c=c))


def _seg_pass(cs, x, y, z, f, d):
    """One segmented Hillis-Steele pass at (traced) distance d on
    [64, T] triples: every position not at its segment's start adds the
    partial sum d positions back."""
    t = x.shape[1]
    src = jnp.arange(t) - d
    has = src >= 0
    src = jnp.maximum(src, 0)
    px, py = x[:, src], y[:, src]
    pz = jnp.where(has[None], z[:, src], 0)                # infinity
    pf = jnp.logical_and(has, f[src])
    ax, ay, az = jac_add_in(cs, (x, y, z), (px, py, pz))
    keep = f[None, :]
    x = jnp.where(keep, x, ax)
    y = jnp.where(keep, y, ay)
    z = jnp.where(keep, z, az)
    return x, y, z, jnp.logical_or(f, pf)


def _merge_tails(cs, x, y, z, cbucket, c: int):
    """Per-bucket totals of the compacted tails, scattered into [64, B+1]
    tables (index = bucket, slot 0 unused).

    The tails of one bucket are adjacent; a segmented scan sums each
    run.  It needs ceil(log2(longest run)) passes, which the program
    counts from the data: a bucket spans about count/steps + 1 lanes, so
    the longest run is short unless one bucket holds most points."""
    buckets_c = _buckets(c)
    f = jnp.concatenate([jnp.ones((1,), bool), cbucket[1:] != cbucket[:-1]])
    real = (cbucket <= buckets_c).astype(jnp.int32)       # not padding
    run = jax.ops.segment_sum(real, jnp.cumsum(f) - 1,
                              num_segments=cbucket.shape[0])
    longest = jnp.max(run)

    def cond(st):
        return st[0] < longest

    def body(st):
        d, x, y, z, f = st
        x, y, z, f = _seg_pass(cs, x, y, z, f, d)
        return d * 2, x, y, z, f

    _, x, y, z, _ = jax.lax.while_loop(cond, body,
                                       (jnp.int32(1), x, y, z, f))
    tail = jnp.concatenate([cbucket[:-1] != cbucket[1:],
                            jnp.ones((1,), bool)])
    slot = jnp.where(jnp.logical_and(tail, cbucket <= buckets_c),
                     cbucket, buckets_c + 1)

    def scat(a):                                           # [64, tail_cap]
        tbl = jnp.zeros((buckets_c + 2, PAD_IN), jnp.int32)
        return tbl.at[slot].set(a.T)[: buckets_c + 1].T    # [64, B+1]

    return scat(x), scat(y), scat(z)


@functools.lru_cache(maxsize=None)
def _merge_tails_jit(c: int):
    return jax.jit(functools.partial(_merge_tails, c=c))


def _window_tables(cs, px, py, dwin, neg, valid, c: int, lanes: int):
    """One window's bucket totals [64, B+1] x3: prep -> scan -> compact
    tails -> merge.  Four programs, each compiled once per shape."""
    sx, sy, seg, sneg, svalid, ds = _prep_window_jit(lanes)(
        px, py, dwin, neg, valid)
    ox, oy, oz = _scan_jit(cs, sx, sy, seg, sneg, svalid)
    cx, cy, cz, cbucket = _compact_tails_jit(c)(ox, oy, oz, ds, seg)
    return _merge_tails_jit(c)(cs, cx, cy, cz, cbucket)


def _fold_tables(cs, bx, by, bz, sel):
    """[64, W, B+1] bucket tables + index sets sel [J, P] -> [64, W, J]:
    row j is the sum  sum_{b in sel[j]} T_b  (index 0 is the empty slot,
    so it pads a set; P is a power of two).

    Every addition here combines partial sums over DISJOINT bucket
    subsets, so two operands can only be equal by negligible-probability
    collision or by being exact-zero infinities — never by the nested-
    suffix structure that breaks incomplete adds (two nested suffix sums
    over an empty gap are group-equal with different Jacobian
    representations; the digit-equality doubling guard cannot see that).
    That is why the bucket-weighted sum sum_b b*T_b is decomposed by
    BITS of b (msm_mxu host combine) instead of by suffix scans.

    The sum runs in two chained passes over a p1 x p2 split of P (a
    running add down p1, then down p2): each pass compiles one add
    instance, and the work stays ~P adds per row, as in a tree."""
    x, y, z = bx[..., sel], by[..., sel], bz[..., sel]   # [64, W, J, P]
    p = sel.shape[-1]
    p1 = 1 << ((p.bit_length() - 1) // 2)
    split = x.shape[:-1] + (p1, p // p1)
    x, y, z = (jnp.moveaxis(a.reshape(split), -2, 0) for a in (x, y, z))
    x, y, z = _chain_sum(cs, x, y, z)                     # [64, W, J, p2]
    x, y, z = (jnp.moveaxis(a, -1, 0) for a in (x, y, z))
    return _chain_sum(cs, x, y, z)                        # [64, W, J]


def _chain_sum(cs, x, y, z):
    """Sum along the leading axis by a running add: every step adds a
    disjoint subset's sum to the accumulator."""
    def step(acc, q):
        return jac_add_in(cs, acc, q), None

    acc, _ = jax.lax.scan(step, (x[0], y[0], z[0]), (x[1:], y[1:], z[1:]))
    return acc


@functools.lru_cache(maxsize=None)
def _fold_tables_jit():
    return jax.jit(_fold_tables)


def _merge_tables(cs, a, b):
    """Merge two segments' bucket tables ([64, B+1] x3 each): per-slot
    jac add of disjoint subset sums."""
    return jac_add_in(cs, a, b)


@functools.lru_cache(maxsize=None)
def _merge_tables_jit():
    return jax.jit(_merge_tables)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def msm_mxu(points: PlainPoints, limbs16, c: int | None = None,
            lanes: int = LANES) -> AffinePoint:
    """Full MSM: points (plain digit columns) x scalars ([n, 16] 16-bit
    limbs of the standard value, as to_msm_digits produces).  Returns a
    host affine point."""
    if c is None:
        # CPU (tests): small windows keep the merge/fold graphs at sizes
        # XLA:CPU compiles in seconds rather than minutes
        c = WINDOW_BITS if jax.default_backend() != "cpu" else 8
    cs = mf.const_arrays()
    limbs16 = jnp.asarray(limbs16)
    n = limbs16.shape[0]
    assert points.n >= n, f"{points.n} points < {n} scalars"
    px, py = points.x[:, :n], points.y[:, :n]
    # shape quantization: MSMs larger than MAX_SEGMENT run as fixed-size
    # segments whose per-window bucket tables are merged (disjoint subset
    # sums — the incomplete add stays safe); smaller MSMs pad to the next
    # power of two, so a proof compiles a handful of scan shapes.
    seg_n = 1 << MAX_SEGMENT_LOG
    if n > seg_n:
        target = -(-n // seg_n) * seg_n
    else:
        target = 1 << max(1, (n - 1).bit_length())
    lanes = min(lanes, target, seg_n)
    pad = target - n
    buckets, negs = signed_digits(limbs16, c)
    valid = jnp.ones((n,), bool)
    if pad:
        px = jnp.pad(px, ((0, 0), (0, pad)))
        py = jnp.pad(py, ((0, 0), (0, pad)))
        buckets = jnp.pad(buckets, ((0, 0), (0, pad)))
        negs = jnp.pad(negs, ((0, 0), (0, pad)))
        valid = jnp.pad(valid, (0, pad))

    merge = _merge_tables_jit()
    multi_seg = target > seg_n
    tabs = []
    for w in range(_n_windows(c)):
        acc = None
        for s0 in range(0, target, seg_n):
            s1 = min(s0 + seg_n, target)
            t = _window_tables(cs, px[:, s0:s1], py[:, s0:s1],
                               buckets[w, s0:s1], negs[w, s0:s1],
                               valid[s0:s1], c, lanes)
            acc = t if acc is None else merge(cs, acc, t)
        tabs.append(acc)
        if multi_seg:
            # bound the dispatch window: a window's scan streams are
            # freed before the next window's are allocated
            jax.block_until_ready(acc)
    bx = jnp.stack([t[0] for t in tabs], axis=1)           # [64, W, B+1]
    by = jnp.stack([t[1] for t in tabs], axis=1)
    bz = jnp.stack([t[2] for t in tabs], axis=1)
    # weighted bucket fold, decomposed by bits of the bucket index:
    #   S_w = sum_b b * T_b = sum_j 2^j * (sum_{b: bit j of b} T_b)
    # (see _fold_tables for why suffix scans are not usable here)
    nbits = c  # bucket indices go up to 2^(c-1) inclusive
    sets = [[b for b in range(1, _buckets(c) + 1) if (b >> j) & 1]
            for j in range(nbits)]
    width = 1 << (max(len(t) for t in sets) - 1).bit_length()
    sel = np.zeros((nbits, width), np.int32)               # 0: empty slot
    for j, t in enumerate(sets):
        sel[j, : len(t)] = t
    wx, wy, wz = (np.asarray(a) for a in _fold_tables_jit()(
        cs, bx, by, bz, jnp.asarray(sel)))                 # [64, W, c]

    n_win = _n_windows(c)
    # host: exact per-window combine of the bit sums, then the window
    # Horner ladder
    win_pts = []
    bit_aff = []
    for j in range(nbits):
        xs = mf.cols_to_ints(wx[:, :, j])
        ys = mf.cols_to_ints(wy[:, :, j])
        zs = mf.cols_to_ints(wz[:, :, j])
        pts_j = []
        for w in range(n_win):
            z = zs[w] % Q_MOD
            if z == 0:
                pts_j.append(g1_infinity())
                continue
            zi = inv_mod(z, Q_MOD)
            zi2 = zi * zi % Q_MOD
            pts_j.append(g1_point(xs[w] * zi2 % Q_MOD,
                                  ys[w] * zi2 * zi % Q_MOD))
        bit_aff.append(pts_j)
    for w in range(n_win):
        acc = g1_infinity()
        for j in reversed(range(nbits)):
            acc = acc.double()
            acc = acc.add(bit_aff[j][w])
        win_pts.append(acc)

    acc = g1_infinity()
    for w in reversed(range(n_win)):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(win_pts[w])
    return acc
