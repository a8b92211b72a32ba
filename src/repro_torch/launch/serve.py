"""Batched serving launcher: prefill + decode loop over serve_step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-34b \
        --reduced --batch 4 --prompt-len 32 --gen 64

Serves a (reduced by default) model with a static batch of requests:
prefill fills the KV cache token by token through the same serve_step,
then greedy-decodes `gen` tokens. Reports per-phase latency and tokens/s.
`--device` defaults to cuda and refuses to run without a GPU; pass
`--device cpu` to run on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import all_archs
from repro_torch.launch.train import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.serving.decode import init_cache, serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 64, seed: int = 0,
          verbose: bool = True, device="cuda") -> dict:
    device = resolve_device(device)
    spec = all_archs()[arch]
    cfg = spec.reduced if reduced else spec.config
    rng = np.random.default_rng(seed)
    params = init_params(cfg, seed, device=device)
    max_seq = prompt_len + gen
    cache = init_cache(cfg, batch, max_seq,
                       enc_len=prompt_len if cfg.enc_dec else 0,
                       device=device)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (batch, prompt_len))
                               .astype(np.int32)).to(device)

    t0 = time.perf_counter()
    logits = None
    for pos in range(prompt_len):                  # prefill via decode path
        logits, cache = serve_step(params, cfg, cache,
                                   prompts[:, pos:pos + 1], pos)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, : cfg.vocab_size], -1).to(torch.int32)
    t0 = time.perf_counter()
    for pos in range(prompt_len, prompt_len + gen):
        out_tokens.append(tok)
        logits, cache = serve_step(params, cfg, cache, tok[:, None], pos)
        tok = torch.argmax(logits[:, : cfg.vocab_size], -1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(out_tokens, 1).cpu().numpy()  # (batch, gen)
    result = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * gen / t_decode,
        "tokens": toks,
        "finite": bool(torch.isfinite(logits).all()),
    }
    if verbose:
        print(f"{arch}: batch={batch} prompt={prompt_len} gen={gen} "
              f"on {device}")
        print(f"  prefill {t_prefill:.2f}s  decode {t_decode:.2f}s "
              f"({result['decode_tok_per_s']:.1f} tok/s)")
        print(f"  sample continuation: {toks[0, :16].tolist()}")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, reduced=args.reduced, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
