"""Train a ~100M-param granite-family model for a few hundred steps on the
synthetic bigram stream, with atomic checkpointing and auto-resume, on the
PyTorch port (the JAX package's examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
        [--device cpu]

`--device` defaults to cuda and refuses to run without a GPU.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import _REGISTRY, ArchSpec, ModelConfig, ScanGroup
from repro_torch.launch.train import run

# ~100M-param granite-family config (d=768, 12L, GQA kv=1, tied head)
CFG_100M = ModelConfig(
    name="granite-100m", d_model=768, n_heads=12, n_kv_heads=1,
    d_ff=3072, vocab_size=8192,
    groups=(ScanGroup(("attn",), 12),),
)


def register() -> str:
    """Registers CFG_100M as the arch "granite-100m" (full and reduced)."""
    from repro_torch.configs.base import all_archs
    all_archs()                      # load the ten archs first
    _REGISTRY["granite-100m"] = ArchSpec(config=CFG_100M, reduced=CFG_100M)
    return "granite-100m"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    out = run(register(), reduced=True, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=100, lr=6e-4, log_every=20, device=args.device)
    print(f"\nfinal loss {out['final_loss']:.3f} after {out['steps_run']} "
          f"steps (resumed from {out['resumed_from']}); "
          f"p50 {out['p50_ms']:.0f} ms, p95 {out['p95_ms']:.0f} ms/step")
    first = out["losses"][0] if out["losses"] else float("nan")
    print(f"loss improved {first:.3f} -> {out['final_loss']:.3f}")


if __name__ == "__main__":
    main()
