"""The yardstick: the work one secure Lloyd iteration needs, counted from
the cell's shapes, and the H100 peaks it is held to.

Frozen here so that a change to the program cannot move it: the counts
follow the protocol as published (paper Sec 4.2; vertical partition,
dense), not the kernels of today's implementation.

Peaks: NVIDIA H100 SXM5 80GB data sheet (HBM3 3.35 TB/s) and the CUDA C++
Programming Guide's throughput table for compute capability 9.0: 132 SMs
x 64 32-bit IMADs a clock at the 1.98 GHz boost clock; a 64-bit
multiply-add mod 2^64 takes 3 IMADs. Derived from data-sheet figures, not
measured.
"""
from __future__ import annotations

import math

HBM_BW = 3.35e12                          # bytes/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9       # 32-bit IMADs/s
INT64_MAC_PER_S = INT32_OPS_PER_S / 3     # multiply-adds mod 2^64 /s
RING_OPS = 2 * INT64_MAC_PER_S            # ring operations/s (2 a MAC)
WORD = 8                                  # bytes of a ring word
KS_LEVELS = 6                             # Kogge-Stone levels of 64 bits


def ring_macs(n: int, d: int, k: int) -> int:
    """Multiply-adds of one iteration's ring products. S1 and S3 each
    have a local product per party (n*d*k together) and two Beaver joint
    products (x_A against P1's share, x_B against P0's), each two
    products a party: 5*n*d*k a stage."""
    return 10 * n * d * k


def _cmp_words(shape: tuple) -> int:
    """Offline words of one CMP over `shape`: the MSB's first and
    KS_LEVELS stacked binary triples, then B2A's two masks and product."""
    m = math.prod(shape)
    return 6 * m + KS_LEVELS * 6 * 2 * m + 2 * m + 6 * m


def offline_words(n: int, d_a: int, d_b: int, k: int) -> int:
    """Words of one iteration's offline list: Beaver triples (six words an
    element: u, v, z, each in two shares; a matrix triple's u, v and z at
    their own shapes) and B2A masks (one word)."""
    d = d_a + d_b

    def matmul(rows, inner, cols):
        return 2 * (rows * inner + inner * cols + rows * cols)

    words = 6 * k * d                                    # |mu|^2
    words += matmul(n, d_a, k) + matmul(n, d_b, k)       # x mu^T, joint
    m, first = k, True                                   # tournament
    while m > 1:
        half, odd = m // 2, m % 2
        words += _cmp_words((n, half))
        # the MUX: values alone at the first level (the one-hots are
        # public there), values and one-hots stacked after it
        words += 6 * n * half * (1 if first else 1 + k)
        m, first = half + odd, False
    words += matmul(k, n, d_a) + matmul(k, n, d_b)       # C^T x, joint
    words += _cmp_words((k,)) + 6 * k                    # empty guard, MUX
    m_r = max(0, math.ceil(math.log2(max(2, n))))
    words += 2 * (m_r + 6) * 6 * k                       # Newton-Raphson
    words += 2 * 6 * k * d                               # num * r, MUX
    return words


def step_bytes(n: int, d_a: int, d_b: int, k: int) -> int:
    """Each input word read once and each output word written once: the
    data, the centroid shares in and out, the offline list and the
    assignment shares."""
    d = d_a + d_b
    return WORD * (n * d + 4 * k * d + offline_words(n, d_a, d_b, k)
                   + 2 * n * k)


def step_bound_s(n: int, d_a: int, d_b: int, k: int) -> dict:
    """The least time one iteration could take on one H100: the larger of
    its ring products over the ring rate and its bytes over HBM."""
    compute = ring_macs(n, d_a + d_b, k) / INT64_MAC_PER_S
    memory = step_bytes(n, d_a, d_b, k) / HBM_BW
    return {"compute_s": compute, "memory_s": memory,
            "bound_s": max(compute, memory),
            "bound": "compute" if compute >= memory else "memory"}


def ring_matmul_bound_s(m: int, kdim: int, n: int) -> float:
    """One (m, kdim) @ (kdim, n) product mod 2^64: each operand read once,
    the result written once; m*kdim*n multiply-adds."""
    return max(WORD * (m * kdim + kdim * n + m * n) / HBM_BW,
               m * kdim * n / INT64_MAC_PER_S)


def ks_carry_share_bound_s(numel: int) -> float:
    """One party's Kogge-Stone carry over `numel` words: 35 words read and
    one written a word; 7 recombinations of 6 64-bit logic ops and 6 level
    xors, each two 32-bit ops."""
    return max(WORD * 36 * numel / HBM_BW,
               numel * (7 * 6 + 6) * 2 / INT32_OPS_PER_S)
