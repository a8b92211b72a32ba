"""End-to-end fault-tolerant training launcher on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b \
        --reduced --steps 300 --batch 16 --seq 128 --ckpt-dir DIR

`--device` defaults to cuda and refuses to run without a GPU; pass
`--device cpu` to run on the CPU. Exercised: auto-resume from the latest
atomic checkpoint, keep-N GC, deterministic restartable data, p50/p95
step times (the straggler metric of synchronous training), optional int8
error-feedback gradient compression, and --simulate-preemption for the
fault-tolerance tests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore, config_fingerprint
from repro_torch.configs.base import all_archs
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.lm import init_params
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train_step import init_state, make_train_step


def resolve_device(device) -> torch.device:
    """The entry points' device; a CUDA device with no GPU present raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA GPU and "
                           "none is available; pass device='cpu' (--device "
                           "cpu) to run on the CPU")
    return device


def run(arch: str, *, reduced: bool = True, steps: int = 100,
        batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
        ckpt_every: int = 50, keep: int = 3, lr: float = 3e-4,
        compress: bool = False, simulate_preemption_at: int | None = None,
        log_every: int = 10, seed: int = 0, verbose: bool = True,
        device="cuda") -> dict:
    device = resolve_device(device)
    spec = all_archs()[arch]
    cfg = spec.reduced if reduced else spec.config
    opt_cfg = AdamWConfig(lr=lr)
    params = init_params(cfg, seed, device=device)
    state = init_state(params, opt_cfg, compress_pod_grads=compress)
    step0 = 0

    store = None
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir, keep=keep,
                                fingerprint=config_fingerprint(cfg))
        latest = store.latest_step()
        if latest is not None:
            restored = store.restore(latest, {"params": params,
                                              "state": state})
            params, state = restored["params"], restored["state"]
            step0 = latest
            if verbose:
                print(f"[resume] restored step {latest} from {ckpt_dir}")

    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, seq, batch,
                                          seed=seed))
    step_fn = make_train_step(cfg, opt_cfg, compress_pod_grads=compress)

    losses, step_times = [], []
    for s in range(step0, steps):
        if simulate_preemption_at is not None and s == simulate_preemption_at:
            if verbose:
                print(f"[preempt] simulated kill at step {s}")
            return {"preempted_at": s, "losses": losses}
        t0 = time.perf_counter()
        host = stream.batch(s)
        b = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        params, state, metrics = step_fn(params, state, b)
        loss = float(metrics["loss"])        # waits for the step's work
        losses.append(loss)
        step_times.append(time.perf_counter() - t0)
        if store and (s + 1) % ckpt_every == 0:
            store.save(s + 1, {"params": params, "state": state})
        if verbose and (s % log_every == 0 or s == steps - 1):
            print(f"step {s:5d} loss {loss:.4f} "
                  f"({step_times[-1]*1e3:.0f} ms)")
    result = {"losses": losses, "final_loss": losses[-1] if losses else None,
              "p50_ms": float(np.percentile(step_times, 50) * 1e3)
              if step_times else None,
              "p95_ms": float(np.percentile(step_times, 95) * 1e3)
              if step_times else None,
              "steps_run": len(losses), "resumed_from": step0}
    if store:
        store.save(steps, {"params": params, "state": state})
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run(args.arch, reduced=args.reduced, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, lr=args.lr,
              compress=args.compress, seed=args.seed, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}  "
          f"p50 {out['p50_ms']:.0f} ms  p95 {out['p95_ms']:.0f} ms")


if __name__ == "__main__":
    main()
