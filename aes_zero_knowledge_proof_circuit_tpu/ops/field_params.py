"""BLS12-377 curve and field parameters.

The reference proves over BLS12-377: the circuit field ``ConstraintF`` is the
BLS12-377 scalar field Fr (reference: src/lib.rs:47 ``pub use ark_bls12_377::Fr``),
and KZG commitments live on BLS12-377 G1 (reference: Cargo.lock pins
ark-bls12-377 / ark-poly-commit 0.3, see SURVEY.md §2b).

Everything here is *derived* from the single BLS parameter ``u`` so the whole
parameter block is auditable:

    r = u^4 - u^2 + 1                    (scalar field, 253 bits, 2-adicity 47)
    q = ((u - 1)^2 * r) // 3 + u          (base field, 377 bits)
    t = u + 1                             (trace of Frobenius of E/Fq)
    #E(Fq) = q + 1 - t = h1 * r,  h1 = (u-1)^2 // 3

G1: y^2 = x^3 + 1 over Fq. G2 lives on a sextic twist over Fq2 = Fq[i]/(i^2+5)
(non-residue -5). Generators are derived deterministically in curve_host.py —
this stack is self-consistent (its own verifier checks its own prover), so it
does not need arkworks' particular generator points.
"""

from __future__ import annotations

import functools

# ---------------------------------------------------------------------------
# BLS parameter and prime fields
# ---------------------------------------------------------------------------

U = 0x8508C00000000001  # BLS12-377 parameter (64 bits, low Hamming weight)

R_MOD = U**4 - U**2 + 1  # Fr modulus (253 bits)
Q_MOD = ((U - 1) ** 2 * (U**4 - U**2 + 1)) // 3 + U  # Fq modulus (377 bits)

TRACE = U + 1
G1_ORDER = Q_MOD + 1 - TRACE  # = H1_COFACTOR * R_MOD
H1_COFACTOR = (U - 1) ** 2 // 3

# Fr is highly 2-adic: r - 1 = 2^47 * T_ODD
TWO_ADICITY = 47
T_ODD = (R_MOD - 1) >> TWO_ADICITY
assert T_ODD % 2 == 1
assert (R_MOD - 1) == T_ODD << TWO_ADICITY

# Quadratic non-residue in Fq used to build Fq2 (arkworks uses -5).
FQ2_NON_RESIDUE = Q_MOD - 5

# ---------------------------------------------------------------------------
# Modular helpers (host side, Python ints)
# ---------------------------------------------------------------------------


def pow_mod(a: int, e: int, m: int) -> int:
    return pow(a, e, m)


def inv_mod(a: int, m: int) -> int:
    """Modular inverse (m prime). CPython's extended-gcd pow(a, -1, m) is
    ~20x faster than the Fermat ladder — this is the host curve layer's
    hottest primitive (every affine point add inverts once)."""
    if a % m == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, m)


def legendre(a: int, p: int) -> int:
    """Legendre symbol: 1 (QR), p-1 (non-residue), 0 (zero)."""
    return pow(a % p, (p - 1) // 2, p)


def sqrt_mod(a: int, p: int, two_adicity: int | None = None) -> int | None:
    """Tonelli-Shanks square root mod odd prime p. Returns None if non-residue."""
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli-Shanks
    s = 0
    q = p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    z = 2
    while legendre(z, p) != p - 1:
        z += 1
    m = s
    c = pow(z, q, p)
    t = pow(a, q, p)
    r = pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i with t^(2^i) == 1
        i = 0
        t2i = t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m = i
        c = b * b % p
        t = t * c % p
        r = r * b % p
    return r


# ---------------------------------------------------------------------------
# Fr multiplicative generator and 2-adic roots of unity
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def fr_multiplicative_generator() -> int:
    """Smallest multiplicative generator of Fr^*.

    Checked against the factorization of r-1 only through the 2-part and odd
    part co-primality tests needed for NTT roots: we require g^((r-1)/2) != 1
    and derive the 2^47 root tower from g^T_ODD.
    """
    for g in range(2, 1000):
        if pow(g, (R_MOD - 1) // 2, R_MOD) != 1:
            # g is a non-square => g^T_ODD has exact order 2^47
            return g
    raise RuntimeError("no generator found")


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in Fr (from the canonical tower)."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"domain 2^{log_n} exceeds Fr 2-adicity {TWO_ADICITY}")
    g = fr_multiplicative_generator()
    w = pow(g, T_ODD, R_MOD)  # exact order 2^47
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % R_MOD
    return w


# ---------------------------------------------------------------------------
# Limb configurations for device kernels
# ---------------------------------------------------------------------------
# Device kernels use no int64: field elements become [L] arrays of 16-bit limbs held in
# 32-bit lanes. Products of two 16-bit limbs fit in uint32; partial products
# are split into lo/hi halves before accumulation so all sums stay < 2^27.
# (SURVEY.md §7 step 1.)

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FR_LIMBS = 16  # 256 bits >= 253
FQ_LIMBS = 24  # 384 bits >= 377


class MontgomeryCtx:
    """Montgomery arithmetic context for a prime modulus in LIMB_BITS limbs."""

    def __init__(self, modulus: int, n_limbs: int):
        self.modulus = modulus
        self.n_limbs = n_limbs
        self.r_bits = n_limbs * LIMB_BITS
        self.R = 1 << self.r_bits
        assert self.R > modulus
        self.R_mod = self.R % modulus
        self.R2_mod = self.R * self.R % modulus
        self.R_inv = inv_mod(self.R_mod, modulus)
        # n0' = -modulus^{-1} mod 2^LIMB_BITS  (per-limb Montgomery factor)
        self.n0_prime = (-inv_mod(modulus, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    def to_mont(self, a: int) -> int:
        return a * self.R_mod % self.modulus

    def from_mont(self, a: int) -> int:
        return a * self.R_inv % self.modulus


@functools.lru_cache(maxsize=None)
def fr_ctx() -> MontgomeryCtx:
    return MontgomeryCtx(R_MOD, FR_LIMBS)


@functools.lru_cache(maxsize=None)
def fq_ctx() -> MontgomeryCtx:
    return MontgomeryCtx(Q_MOD, FQ_LIMBS)


def _self_check() -> None:
    # Known published values for BLS12-377 (sanity anchors).
    assert R_MOD == int(
        "8444461749428370424248824938781546531375899335154063827935233455917409239041"
    )
    assert Q_MOD == int(
        "258664426012969094010652733694893533536393512754914660539884262666720468348340"
        "822774968888139573360124440321458177"
    )
    assert R_MOD.bit_length() == 253
    assert Q_MOD.bit_length() == 377
    # q = 1 mod r-torsion embedding checks
    assert G1_ORDER % R_MOD == 0
    assert G1_ORDER // R_MOD == H1_COFACTOR
    # -5 must be a non-residue so Fq2 = Fq[i]/(i^2+5) is a field
    assert legendre(FQ2_NON_RESIDUE, Q_MOD) == Q_MOD - 1
    w = root_of_unity(TWO_ADICITY)
    assert pow(w, 1 << TWO_ADICITY, R_MOD) == 1
    assert pow(w, 1 << (TWO_ADICITY - 1), R_MOD) != 1


_self_check()
