"""Secure joint normalization (paper Sec 4.2: "before performing clustering,
a joint normalization operation is required").

Vertical partitioning: each party owns whole columns, so min-max
normalization is LOCAL (no protocol needed) — `normalize_local`.

Horizontal partitioning: the column-wise min/max spans both parties' rows.
`secure_minmax` computes secret-shared global min/max with ONE CMP + MUX
per extremum: each party first reduces its own rows locally (plaintext),
shares the d-vector of local extrema, and the two candidates are combined
with the comparison protocol. `normalize_horizontal` reconstructs the
constants (agreed preprocessing output, like the paper's public
initialization) and each party rescales its own rows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.sharing import rec_real, share_real


def normalize_local(x: np.ndarray) -> np.ndarray:
    """Per-column min-max to [0, 1] (vertical partitioning: local & exact)."""
    lo, hi = x.min(0, keepdims=True), x.max(0, keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-9)


def secure_minmax(ctx: P.Ctx, x_a: np.ndarray, x_b: np.ndarray,
                  rng: np.random.Generator):
    """Horizontal partitioning: -> (min AShare (d,), max AShare (d,)) on
    the ctx's device. One CMP+MUX pair per extremum over the parties' local
    extrema (the local reductions are plaintext — each party's rows are its
    own data)."""
    lo_a, hi_a = x_a.min(0), x_a.max(0)
    lo_b, hi_b = x_b.min(0), x_b.max(0)
    sh = {k: share_real(v, rng, device=ctx.device) for k, v in
          {"la": lo_a, "ha": hi_a, "lb": lo_b, "hb": hi_b}.items()}
    b_lo = P.cmp_lt(ctx, sh["la"], sh["lb"])       # [lo_a < lo_b]
    g_min = P.mux(ctx, b_lo, sh["la"], sh["lb"])
    b_hi = P.cmp_lt(ctx, sh["hb"], sh["ha"])       # [hi_b < hi_a]
    g_max = P.mux(ctx, b_hi, sh["ha"], sh["hb"])
    return g_min, g_max


def normalize_horizontal(ctx: P.Ctx, x_a: np.ndarray, x_b: np.ndarray,
                         rng: np.random.Generator):
    """Jointly min-max normalize horizontally-partitioned data. The global
    (min, range) pair is reconstructed as agreed preprocessing output; each
    party then rescales its own rows locally."""
    g_min, g_max = secure_minmax(ctx, x_a, x_b, rng)
    lo = rec_real(g_min).cpu().numpy()
    hi = rec_real(g_max).cpu().numpy()
    ctx.log.send(2 * ring.nbytes(lo.shape), tag="norm", phase="online")
    rng_span = np.maximum(hi - lo, 1e-9)
    return (x_a - lo) / rng_span, (x_b - lo) / rng_span
