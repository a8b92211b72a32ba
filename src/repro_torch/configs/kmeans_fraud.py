"""The paper's own workload: sparsity-aware secure K-means for fraud
detection, sized like the production deployment (Sec 5.5-5.6 scaled up).

Used by launch/dryrun.py to count the *online Lloyd iteration* (distance +
argmin + update on secret shares, trusted-dealer triples as inputs) on the
production mesh: samples sharded over ('pod','data'), centroid shares
replicated — the MPC protocol as one program over the sample-sharded
arguments. `chip_smoke.py` runs the same single-launch iteration on one
GPU.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class KMeansArch:
    name: str = "kmeans-fraud"
    n: int = 1_048_576          # samples (paper Fig 4 scale)
    d: int = 1024               # one-hot heavy feature dim
    k: int = 16                 # clusters (fraud patterns; keeps the secret
                                # one-hot tournament state n*m*k tractable)
    d_a: int = 512              # party A's feature slice (vertical)
    sparsity: float = 0.9


FULL = KMeansArch()
REDUCED = KMeansArch(name="kmeans-fraud-reduced", n=512, d=16, k=4, d_a=8)
