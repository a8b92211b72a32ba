"""Additively homomorphic encryption (paper Sec 3.2) + HE2SS (Sec 3.3).

The JAX package's `repro/core/he.py`, copied unchanged below this
paragraph: it is pure Python and numpy, and the port keeps its own copy so
that it imports nothing of that package.

Two interchangeable backends behind one interface:

* `Paillier` — a real cryptosystem (pure-python bigints, Miller-Rabin
  keygen). Used by tests at 512/768-bit keys to validate the *actual*
  protocol end to end. (The paper uses Okamoto-Uchiyama at 2048 bits purely
  because OU beats Paillier on speed; the homomorphic interface — and hence
  the protocol — is identical.)
* `SimulatedPHE` — same interface, plaintext-backed (exact big-int
  homomorphism), with byte-accurate OU-2048 ciphertext accounting and slot
  packing. Benchmarks use it so Table/Figure reproductions aren't dominated
  by python bigint exponentiation that the paper ran in C++.

Hardware-adaptation note (DESIGN.md §3): 2048-bit modular exponentiation has
no TPU analogue; HE runs host-side in production. What the framework needs is
the protocol structure + traffic, which both backends provide exactly.
"""
from __future__ import annotations

import dataclasses
import secrets

import numpy as np

KAPPA_STAT = 40  # statistical masking parameter for HE2SS (standard sigma)


# ---------------------------------------------------------------------------
# Miller-Rabin prime generation (keygen support)
# ---------------------------------------------------------------------------

def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _rand_prime(bits: int) -> int:
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


# ---------------------------------------------------------------------------
# Real Paillier
# ---------------------------------------------------------------------------

class PaillierPublicKey:
    def __init__(self, n: int):
        self.n = n
        self.n2 = n * n
        self.ct_bytes = (n.bit_length() * 2 + 7) // 8  # ciphertext in Z_{n^2}
        self.plain_bits = n.bit_length() - 2           # usable plaintext space

    def encrypt(self, m: int):
        m %= self.n
        r = secrets.randbelow(self.n - 2) + 1
        # g = n+1 optimization: g^m = (1 + m*n) mod n^2
        c = (1 + m * self.n) % self.n2 * pow(r, self.n, self.n2) % self.n2
        return Ciphertext(self, c)


class PaillierPrivateKey:
    def __init__(self, pk: PaillierPublicKey, p: int, q: int):
        self.pk = pk
        self.lam = _lcm(p - 1, q - 1)
        self.mu = pow(_L(pow(pk.n + 1, self.lam, pk.n2), pk.n), -1, pk.n)

    def decrypt(self, ct: "Ciphertext") -> int:
        return _L(pow(ct.c, self.lam, self.pk.n2), self.pk.n) * self.mu % self.pk.n


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


def _L(u: int, n: int) -> int:
    return (u - 1) // n


class Ciphertext:
    """[[m]] — supports + (ct or plain int) and * (plain int), paper Sec 3.2."""

    __slots__ = ("pk", "c")

    def __init__(self, pk: PaillierPublicKey, c: int):
        self.pk, self.c = pk, c

    def __add__(self, other):
        if isinstance(other, Ciphertext):
            return Ciphertext(self.pk, self.c * other.c % self.pk.n2)
        return self + self.pk.encrypt(int(other))

    def add_plain(self, m: int) -> "Ciphertext":
        """[[x + m]] without fresh randomness: g^m = (1 + m*n) mod n^2.

        Deterministic (unlike `ct + int`, which re-randomizes via a full
        encrypt) — the cost of one modular mul instead of one encryption.
        Callers that transmit the result must re-randomize it themselves
        (e.g. add a fresh [[0]]) or the recipient who produced `self` could
        recover m from the known randomness."""
        m = int(m) % self.pk.n
        return Ciphertext(self.pk, self.c * (1 + m * self.pk.n) % self.pk.n2)

    def __rmul__(self, k: int):
        k = int(k) % self.pk.n
        return Ciphertext(self.pk, pow(self.c, k, self.pk.n2))

    __mul__ = __rmul__


@dataclasses.dataclass
class Paillier:
    """Backend object: keygen + (de/en)cryption + accounting hooks."""

    key_bits: int = 512
    name: str = "paillier"

    def __post_init__(self):
        p = _rand_prime(self.key_bits // 2)
        q = _rand_prime(self.key_bits // 2)
        while q == p:
            q = _rand_prime(self.key_bits // 2)
        self.pk = PaillierPublicKey(p * q)
        self.sk = PaillierPrivateKey(self.pk, p, q)

    @property
    def ct_bytes(self) -> int:
        return self.pk.ct_bytes

    @property
    def plain_bits(self) -> int:
        return self.pk.plain_bits

    def encrypt(self, m: int) -> Ciphertext:
        return self.pk.encrypt(m)

    def decrypt(self, ct: Ciphertext) -> int:
        return self.sk.decrypt(ct)


# ---------------------------------------------------------------------------
# Simulated PHE: exact integer homomorphism, OU-2048 byte accounting
# ---------------------------------------------------------------------------

class SimCiphertext:
    __slots__ = ("he", "m")

    def __init__(self, he: "SimulatedPHE", m: int):
        self.he, self.m = he, m % he.modulus

    def __add__(self, other):
        o = other.m if isinstance(other, SimCiphertext) else int(other)
        return SimCiphertext(self.he, self.m + o)

    def add_plain(self, m: int) -> "SimCiphertext":
        """Deterministic plaintext add — same interface as Paillier's."""
        return SimCiphertext(self.he, self.m + int(m))

    def __rmul__(self, k: int):
        return SimCiphertext(self.he, int(k) * self.m)

    __mul__ = __rmul__


@dataclasses.dataclass
class SimulatedPHE:
    """Okamoto-Uchiyama cost profile (paper Sec 5.1): 2048-bit key, plaintext
    space >= 1365 bits (2/3 key len), ciphertext = one Z_n element = 256 B."""

    key_bits: int = 2048
    name: str = "ou-sim"

    def __post_init__(self):
        self.plain_bits = self.key_bits * 2 // 3  # psi, paper Sec 5.1
        self.modulus = 1 << self.plain_bits
        self.ct_bytes = self.key_bits // 8        # OU ct lives in Z_n

    def encrypt(self, m: int) -> SimCiphertext:
        return SimCiphertext(self, m)

    def decrypt(self, ct: SimCiphertext) -> int:
        return ct.m % self.modulus


# Measured single-core costs (2.5 GHz Xeon, paper's class of machine) used to
# model HE wall-time in benchmarks when running the simulated backend:
#   OU-2048 encrypt ~ 250us, decrypt ~ 150us, ct+ct ~ 1.5us, int*ct ~ 15us.
OU_COST_S = {"enc": 250e-6, "dec": 150e-6, "add": 1.5e-6, "pmul": 15e-6}
