"""Faults planted under the timed path: the port's S1/S3 programs with one
fault each, in the programs' signatures, for the cell test (CPU, tiny)
and for `bench/calibrate.py` (the GPU, at a cell's own size).

    unchanged_state     S3 hands back the centroid shares it was given;
    half_batch          S3 over the first half of the rows: the second
                        half's assignment shares are zeroed, so the sums
                        and counts, and the mean, are the first half's;
    altered_assignment  S1's one-hot rotated by a column on 2 % of rows;
    altered_centroid    one centroid word raised by 2^16 (2^-4 at f = 20).
"""
from __future__ import annotations

FAULTS = ("unchanged_state", "half_batch", "altered_assignment",
          "altered_centroid")


class Faulty:
    """`programs` (a FitPrograms) with `fault` planted in S1 or S3."""

    def __init__(self, fault: str, programs):
        if fault not in FAULTS:
            raise ValueError(f"no fault named {fault!r}")
        self.p, self.fault = programs, fault
        self.s1_requests = programs.s1_requests
        self.s3_requests = programs.s3_requests

    def s1(self, xa, xb, mu0, mu1, *flat):
        import torch
        c0, c1 = self.p.s1(xa, xb, mu0, mu1, *flat)
        if self.fault == "altered_assignment":
            rows = c0.shape[0] // 50
            c0, c1 = c0.clone(), c1.clone()
            c0[:rows] = torch.roll(c0[:rows], 1, dims=1)
            c1[:rows] = torch.roll(c1[:rows], 1, dims=1)
        return c0, c1

    def s3(self, xa, xb, mu0, mu1, c0, c1, *flat):
        if self.fault == "unchanged_state":
            return mu0, mu1
        if self.fault == "half_batch":
            h = c0.shape[0] // 2
            c0, c1 = c0.clone(), c1.clone()
            c0[h:] = 0
            c1[h:] = 0
        m0, m1 = self.p.s3(xa, xb, mu0, mu1, c0, c1, *flat)
        if self.fault == "altered_centroid":
            m0 = m0.clone()
            m0[0, 0] += 1 << 16
        return m0, m1
