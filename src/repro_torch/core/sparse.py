"""Protocol 2: Secure Sparse Matrix Multiplication + HE2SS (paper Sec 4.3).

Setting: party A holds a *plaintext sparse* matrix X (its own raw data —
sparsity is only destroyed once a matrix is secret-shared, which is exactly
what this protocol avoids); party B holds a dense matrix Y (here: its share
of the centroids). Output: fresh A-shares of Z = X @ Y mod 2^64.

  1. B encrypts Y with its key and sends [[Y]] — slot-packed g columns per
     ciphertext, d*ceil(k/g) ciphertexts.
  2. A computes [[Z]] = X [[Y]] using ONLY nnz(X)*ceil(k/g) ciphertext ops:
     one plaintext-scalar pmul against a packed column-group ciphertext
     multiplies X_ij into g columns at once (the homomorphism is linear
     over Z mod N, so intermediate per-slot values may go negative — only
     the FINAL masked slots must be non-negative and slot-bounded).
  3. A masks: picks r uniform in [0, 2^{value_bits+kappa_stat}) per entry
     from a dealer-seeded numpy stream, adds (r + 2^{value_bits}) per slot
     with one deterministic `add_plain` per row-group, stacks `rpc`
     row-groups per wire ciphertext (shift-and-add), re-randomizes each
     wire ciphertext with one fresh [[0]], and sends. A's share is
     (-(r + offset) mod 2^l) = (-r mod 2^l) since value_bits >= l.
  4. B decrypts and reduces each slot mod 2^l -> its share. (HE2SS, Sec 3.3)

Both legs pack (paper sizes psi=1365 bits for this): the B->A leg carries
g = min(k, slots) columns per ciphertext and the A->B leg carries
rpc = max(1, slots // g) masked row-groups (g slots each) per ciphertext.
The original per-(row, col, nnz) ciphertext loops survive behind
`batched=False` as the parity reference.

Communication = d*ceil(k/g) ct (B->A) + ceil(n*ceil(k/g) / rpc) ct (A->B):
independent of nnz and of the *large* dimension product n*d that the
dense-SS path must ship — the paper's headline sparsity win.

Port of the JAX package's `repro/core/sparse.py`, word for word. X stays a
host numpy CSR matrix (Protocol 2's data is host-resident by design); its
blocked-ELL packing is uploaded once per device and memoized on it. On the
"ou-sim" fast path the step-2 product stays on the ring backend's device,
and only the mask is drawn on the host. Each exchange records an
`he.exchange` span, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.he import KAPPA_STAT
from repro_torch.core.protocol import Ctx
from repro_torch.core.sharing import AShare
from repro_torch.kernels.spmm import csr_to_ell
from repro_torch.obs import trace as _trace

# host seconds spent packing CSR matrices into blocked-ELL and starting
# their upload (`CSRMatrix.ell`: the copy into pinned memory and the
# enqueue of the non-blocking transfer; the transfer itself overlaps and
# is not counted), summed over all matrices
ELL_PACK_SECONDS = 0.0


class CSRMatrix:
    """Minimal CSR for party-local plaintext sparse data (uint64 ring
    values, host numpy)."""

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.data = np.asarray(data, np.uint64)
        self.shape = tuple(shape)

    @property
    def nnz(self) -> int:
        return len(self.data)

    @classmethod
    def from_dense(cls, x: np.ndarray) -> "CSRMatrix":
        x = np.asarray(x, np.uint64)
        mask = x != 0
        indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
        indices = np.nonzero(mask)[1]
        data = x[mask]
        return cls(indptr, indices, data, x.shape)

    @classmethod
    def from_dense_real(cls, x: np.ndarray, f: int = ring.F) -> "CSRMatrix":
        enc = np.round(np.asarray(x, np.float64) * (1 << f)).astype(np.int64)
        return cls.from_dense(enc.astype(np.uint64))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.uint64)
        for i in range(self.shape[0]):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[lo:hi]] = self.data[lo:hi]
        return out

    def transpose(self) -> "CSRMatrix":
        """X^T in CSR, nnz-proportional (counting sort by column) — no
        densify round-trip. Identical layout to `from_dense(X.T)`: rows of
        the transpose in order, each row's entries ordered by original row
        index (stable sort). Used by the C^T X joint products, which apply
        Protocol 2 through the transpose identity <C>^T X = (X^T <C>)^T.
        Memoized: Lloyd consumes the same transpose every iteration."""
        t = getattr(self, "_transpose", None)
        if t is None:
            n, d = self.shape
            counts = np.bincount(self.indices, minlength=d)
            indptr = np.concatenate([[0], np.cumsum(counts)])
            order = np.argsort(self.indices, kind="stable")
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(self.indptr))
            t = CSRMatrix(indptr, rows[order], self.data[order], (d, n))
            self._transpose = t
        return t

    def ell(self, *, bm: int = 8, bk: int = 128, device="cpu") -> tuple:
        """(blocks, idx, counts): the blocked-ELL packing of this matrix
        (`kernels.spmm.csr_to_ell`) as tensors on `device` — int64 words,
        int32 indices. Memoized per (bm, bk, device): X is fixed for a
        whole fit, so it is packed and uploaded once, not per product. The
        upload does not wait for the device (`ring.upload`)."""
        global ELL_PACK_SECONDS
        cache = self.__dict__.setdefault("_ell", {})
        key = (bm, bk, str(torch.device(device)))
        if key not in cache:
            t0 = time.perf_counter()
            blocks, idx, counts = csr_to_ell(self.indptr, self.indices,
                                             self.data, self.shape,
                                             bm=bm, bk=bk)
            cache[key] = tuple(ring.upload(t, device) for t in (
                ring.from_u64_numpy(blocks), torch.from_numpy(idx),
                torch.from_numpy(counts)))
            ELL_PACK_SECONDS += time.perf_counter() - t0
        return cache[key]


@dataclasses.dataclass(frozen=True)
class HE2SSLayout:
    """Slot geometry for the both-leg packed Protocol-2 exchange."""

    value_bits: int  # |Z entry as integer| < 2^value_bits
    slot_bits: int   # value_bits + KAPPA_STAT + 2
    slots: int       # values per ciphertext at this slot width
    g: int           # columns packed per B->A ciphertext / per row-group
    ngrp: int        # ceil(k / g) column groups
    rpc: int         # row-groups stacked per A->B wire ciphertext

    def n_wire(self, n: int) -> int:
        """A->B wire ciphertexts for an n-row product."""
        return -(-(n * self.ngrp) // self.rpc)


def he2ss_layout(k: int, plain_bits: int, value_bits: int) -> HE2SSLayout:
    slot_bits = value_bits + KAPPA_STAT + 2
    slots = max(1, plain_bits // slot_bits)
    g = min(k, slots)
    return HE2SSLayout(value_bits=value_bits, slot_bits=slot_bits,
                       slots=slots, g=g, ngrp=-(-k // g),
                       rpc=max(1, slots // g))


def default_value_bits(d: int) -> int:
    """|Z| bound: full-range 2^l share x fixed-point data, summed over d."""
    return ring.L + (ring.F + 14) + max(1, int(np.ceil(np.log2(d))))


def he2ss_op_counts(n: int, d: int, nnz: int, nrows_ne: int,
                    lay: HE2SSLayout) -> dict:
    """HE operation counts of the batched exchange (mirrors the real path's
    measured counters exactly; test-enforced). `nrows_ne` = rows with any
    non-zero (their first product needs no accumulate-add)."""
    mct = n * lay.ngrp                 # masked row-group ciphertexts
    n_out = lay.n_wire(n)
    return {
        "enc": d * lay.ngrp + n_out,   # forward packing + wire re-randomize
        "pmul": nnz * lay.ngrp + (mct - n_out),   # step 2 + stacking shifts
        "add": (nnz - nrows_ne) * lay.ngrp + 2 * mct,
        "dec": n_out,
        "ct_fwd": d * lay.ngrp,
        "ct_ret": n_out,
    }


def _mask_words(seed: int, n: int, k: int, mask_bits: int) -> np.ndarray:
    """(n, k, w) uint64 little-endian words of r ~ U[0, 2^mask_bits), drawn
    from the dealer-seeded stream so a provisioned dealer replays bit-exact
    and the batched / legacy paths consume identical masks."""
    w = -(-mask_bits // 64)
    words = np.random.default_rng(seed) \
        .integers(0, 1 << 64, size=(n, k, w), dtype=np.uint64)
    top = mask_bits - 64 * (w - 1)
    if top < 64:
        words[..., -1] &= np.uint64((1 << top) - 1)
    return words


def _mask_int(words: np.ndarray, i: int, c: int) -> int:
    return sum(int(words[i, c, t]) << (64 * t)
               for t in range(words.shape[2]))


def secure_sparse_matmul(ctx: Ctx, x: CSRMatrix, y_share_b: torch.Tensor,
                         he, *, value_bits: int | None = None,
                         trunc_f: int | None = None,
                         time_model: dict | None = None,
                         batched: bool = True) -> AShare:
    """Traced entry point for Protocol 2: the HE joint-product exchange is
    the dominant host-side seam of a sparse fit, so it gets its own span
    (`he.exchange`, tagged with the problem shape)."""
    with _trace.span("he.exchange", n=x.shape[0], d=x.shape[1],
                     k=int(y_share_b.shape[1]), nnz=int(x.nnz)):
        return _secure_sparse_matmul(ctx, x, y_share_b, he,
                                     value_bits=value_bits, trunc_f=trunc_f,
                                     time_model=time_model, batched=batched)


def _secure_sparse_matmul(ctx: Ctx, x: CSRMatrix, y_share_b: torch.Tensor,
                          he, *, value_bits: int | None = None,
                          trunc_f: int | None = None,
                          time_model: dict | None = None,
                          batched: bool = True) -> AShare:
    """Protocol 2. `y_share_b` is party B's plaintext-held (d, k) ring matrix
    (e.g. its additive share of the centroids), an int64 tensor; A's share
    of Y is handled by the caller with a plain local matmul (X is public to
    A). Returns A-shares of X @ Y on ctx.device.

    value_bits bounds |Z entries as integers| (NOT mod-reduced): B's share is
    full-range 2^64 and X is fixed point, so the default is
    l + (F + 14) + ceil(log2 d). The statistical mask r is uniform in
    [0, 2^{value_bits+KAPPA_STAT}) and an additive OFFSET = 2^{value_bits}
    keeps the revealed integer Z + r + OFFSET positive; both cancel mod 2^l.
    Also logs a modelled HE wall-time if `time_model` (dict like
    he.OU_COST_S) is given.

    `batched=False` selects the original per-(row, col, nnz) ciphertext
    loops — kept as the parity reference for the column-batched rewrite;
    both paths draw masks from the same dealer-seeded stream and produce
    bit-identical shares.
    """
    n, d = x.shape
    d2, k = y_share_b.shape
    assert d == d2
    if value_bits is None:
        value_bits = default_value_bits(d)
    assert value_bits >= ring.L, \
        "offset 2^value_bits must vanish mod 2^l for the share algebra"
    dev = ctx.device
    lay = he2ss_layout(k, he.plain_bits, value_bits)
    nrows_ne = int(np.count_nonzero(np.diff(x.indptr)))

    # Fast path for the simulated backend: the real protocol's shares reduced
    # mod 2^l are distributed exactly as (Z + r64, -r64) with r64 uniform in
    # Z_{2^64}; compute them directly with the nnz/block-proportional ring
    # spmm on the backend's device. Traffic/HE-time accounting mirrors the
    # batched path.
    if getattr(he, "name", "") == "ou-sim":
        ops = he2ss_op_counts(n, d, x.nnz, nrows_ne, lay)
        ctx.send(ops["ct_fwd"] * he.ct_bytes, rounds=1)         # B->A [[Y]]
        ctx.send(ops["ct_ret"] * he.ct_bytes, rounds=1)
        z = ctx.backend.ring_spmm_csr(x, y_share_b.to(dev))
        # mask stream seeded through the dealer API (drawn on the host with
        # the reference's numpy stream, then uploaded without waiting for
        # the device's queued work: `ring.upload`)
        r = ring.upload(ring.from_u64_numpy(
            np.random.default_rng(ctx.dealer.mask_seed())
            .integers(0, 1 << 64, size=(n, k), dtype=np.uint64)), dev)
        if time_model is not None:
            ctx.add_he_seconds(sum(ops[op] * time_model[op]
                                   for op in ("enc", "pmul", "add", "dec")))
        secure_sparse_matmul.last_op_counts = ops
        out = AShare(ring.neg(r), z + r)
        return P.trunc(out, trunc_f) if trunc_f else out

    y = ring.to_u64_numpy(y_share_b)
    sb, g, ngrp, rpc = lay.slot_bits, lay.g, lay.ngrp, lay.rpc
    offset = 1 << value_bits
    n_enc = n_pmul = n_add = n_dec = 0
    # one cached [[0]] per call (for all-empty row-groups; only ever summed
    # or masked before transmission, and every wire ciphertext is freshly
    # re-randomized, so reuse is semantically safe). Its single encryption
    # is O(1) and excluded from the modelled op counts.
    _zero = None

    def zero_ct():
        nonlocal _zero
        if _zero is None:
            _zero = he.encrypt(0)
        return _zero

    # masks for ALL n*k cells, dealer-seeded (shared by both real paths)
    words = _mask_words(ctx.dealer.mask_seed(), n, k,
                        value_bits + KAPPA_STAT)
    # -(r + offset) mod 2^l = -r mod 2^l: offset == 0 mod 2^l (value_bits>=l)
    share_a = np.uint64(0) - words[..., 0]

    if batched:
        # -- 1. B -> A: [[Y]] packed g columns per ciphertext ----------------
        cts_y = []
        for j in range(d):
            row = []
            for grp in range(ngrp):
                p = 0
                for pos, c in enumerate(range(grp * g, min(k, (grp + 1) * g))):
                    p |= int(y[j, c]) << (sb * pos)   # y < 2^64: slots disjoint
                row.append(he.encrypt(p))
                n_enc += 1
            cts_y.append(row)
        ctx.send(d * ngrp * he.ct_bytes, rounds=1)

        # -- 2. A: [[Z]] = X [[Y]] — one pmul covers g columns ---------------
        z_rows = []
        for i in range(n):
            lo, hi = int(x.indptr[i]), int(x.indptr[i + 1])
            row = []
            for grp in range(ngrp):
                acc = None
                for t in range(lo, hi):
                    j, v = int(x.indices[t]), int(np.int64(x.data[t]))
                    term = v * cts_y[j][grp]
                    n_pmul += 1
                    acc = term if acc is None else acc + term
                    n_add += acc is not term
                row.append(acc if acc is not None else zero_ct())
            z_rows.append(row)

        # -- 3. A: mask per slot, stack rpc row-groups, re-randomize ---------
        packed, cur, cur_n = [], None, 0
        for i in range(n):
            for grp in range(ngrp):
                m = 0
                for pos, c in enumerate(range(grp * g, min(k, (grp + 1) * g))):
                    # r + offset < 2^{slot_bits-1}: slots stay disjoint
                    m |= (_mask_int(words, i, c) + offset) << (sb * pos)
                mct = z_rows[i][grp].add_plain(m)
                n_add += 1
                if cur_n == 0:
                    cur = mct
                else:
                    cur = cur + (1 << (sb * g * cur_n)) * mct
                    n_pmul += 1
                    n_add += 1
                cur_n += 1
                if cur_n == rpc:
                    packed.append(cur)
                    cur, cur_n = None, 0
        if cur is not None:
            packed.append(cur)
        # every derived wire ciphertext gets FRESH randomness: B knows the
        # randomness of its own [[Y]], so an un-randomized derived ct would
        # leak A's coefficients through the deterministic add_plain chain
        out_cts = [ct + he.encrypt(0) for ct in packed]
        n_enc += len(packed)
        n_add += len(packed)
        ctx.send(len(out_cts) * he.ct_bytes, rounds=1)

        # -- 4. B: decrypt, unpack rpc x g slots, reduce mod 2^l -------------
        share_b = np.zeros((n, k), np.uint64)
        slot_mask = (1 << sb) - 1
        idx = 0                                   # flattened (i, grp) counter
        for ct in out_cts:
            w = he.decrypt(ct)
            n_dec += 1
            for b in range(rpc):
                if idx >= n * ngrp:
                    break
                i, grp = divmod(idx, ngrp)
                base = sb * g * b
                for pos, c in enumerate(range(grp * g, min(k, (grp + 1) * g))):
                    v = (w >> (base + sb * pos)) & slot_mask
                    share_b[i, c] = np.uint64(v & 0xFFFFFFFFFFFFFFFF)
                idx += 1
    else:
        # ---- legacy per-(row, col, nnz) loops: parity reference ------------
        # -- 1. B -> A: [[Y]] one ciphertext per matrix entry ----------------
        cts_y = [[he.encrypt(int(y[j, c])) for c in range(k)]
                 for j in range(d)]
        n_enc += d * k
        ctx.send(d * k * he.ct_bytes, rounds=1)

        # -- 2. A: [[Z]] = X [[Y]]  (nnz-proportional) -----------------------
        z_rows = []
        for i in range(n):
            lo, hi = int(x.indptr[i]), int(x.indptr[i + 1])
            row = []
            for c in range(k):
                acc = None
                for t in range(lo, hi):
                    j, v = int(x.indices[t]), int(np.int64(x.data[t]))
                    term = v * cts_y[j][c]
                    n_pmul += 1
                    acc = term if acc is None else acc + term
                    n_add += acc is not term
                row.append(acc if acc is not None else zero_ct())
            z_rows.append(row)

        # -- 3. A: mask + pack + send  (HE2SS, statistically sound) ----------
        slots = lay.slots
        packed, cur, cur_n = [], None, 0
        for i in range(n):
            for c in range(k):
                r = _mask_int(words, i, c)
                # `ct + int` performs a FULL fresh encryption of the mask —
                # the legacy path's hidden n*k encryptions (counted honestly)
                ct = z_rows[i][c] + (r + offset)  # [[Z + r + offset]]
                n_enc += 1
                n_add += 1
                # shift-and-add packing: ct * 2^{slot*pos} accumulated
                ct_shifted = (1 << (sb * cur_n)) * ct
                cur = ct_shifted if cur is None else cur + ct_shifted
                n_pmul += 1
                n_add += cur is not ct_shifted
                cur_n += 1
                if cur_n == slots:
                    packed.append(cur)
                    cur, cur_n = None, 0
        if cur is not None:
            packed.append(cur)
        out_cts = packed                      # already fresh via the mask encs
        ctx.send(len(packed) * he.ct_bytes, rounds=1)

        # -- 4. B: decrypt, unpack, reduce mod 2^l ---------------------------
        share_b = np.zeros((n, k), np.uint64)
        flat = []
        for ct in packed:
            w = he.decrypt(ct)
            n_dec += 1
            for s in range(slots):
                flat.append((w >> (sb * s)) & ((1 << sb) - 1))
                if len(flat) == n * k:
                    break
        for idx, w in enumerate(flat[: n * k]):
            share_b[idx // k, idx % k] = np.uint64(w & 0xFFFFFFFFFFFFFFFF)

    if time_model is not None:
        t = (n_enc * time_model["enc"] + n_pmul * time_model["pmul"]
             + n_add * time_model["add"] + n_dec * time_model["dec"])
        ctx.log.send(0, tag=ctx.tag + "/he_time", phase="online", rounds=0)
        ctx.add_he_seconds(t)
    # measured op counters, exposed for the accounting parity tests
    secure_sparse_matmul.last_op_counts = {
        "enc": n_enc, "pmul": n_pmul, "add": n_add, "dec": n_dec,
        "ct_fwd": len(cts_y) * len(cts_y[0]) if cts_y else 0,
        "ct_ret": len(out_cts),
    }

    out = AShare(ring.from_u64_numpy(share_a, dev),
                 ring.from_u64_numpy(share_b, dev))
    return P.trunc(out, trunc_f) if trunc_f else out


def sparse_matmul_comm_bytes(n: int, d: int, k: int, he_ct_bytes: int = 256,
                             plain_bits: int = 1365,
                             value_bits: int | None = None) -> int:
    """Closed-form Protocol-2 traffic (for the analytic sparsity benchmarks):
    both-leg packed layout — d*ceil(k/g) forward + ceil(n*ceil(k/g)/rpc)
    return ciphertexts."""
    if value_bits is None:
        value_bits = default_value_bits(d)
    lay = he2ss_layout(k, plain_bits, value_bits)
    return (d * lay.ngrp + lay.n_wire(n)) * he_ct_bytes


def dense_ss_matmul_comm_bytes(n: int, d: int, k: int, l: int = ring.L) -> int:
    """Dense Beaver-matmul online traffic for the same product (both dirs)."""
    return 2 * (n * d + d * k) * (l // 8)
