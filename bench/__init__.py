"""The benchmark of repro_torch, the PyTorch and CUDA port: run one cell
with `python3 bench/run.py` (see run.py)."""
