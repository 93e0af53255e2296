"""Serving driver: batched requests through the ServingEngine with the
paper's approx-top-k vocabulary sampler (and optional kNN attention).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --batch 8 --max-seq 2048 --new-tokens 32 --knn-attention

Port of ``src/repro/launch/serve.py``, with its flags and ``--device``
(default "cuda"; "cpu" runs the plain path).  ``--arch`` takes every
decoder-only architecture; an encoder-decoder (whisper) needs the cross
KV of its prefill step, which the engine does not carry, and is refused.
The model's weights are random, drawn on the device from ``--seed`` in
the config's compute dtype (what the reference's per-step cast makes of
its f32 weights).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--knn-attention", action="store_true")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"{args.arch} is an encoder-decoder: the engine serves "
                 "decoder-only architectures")
    device = tfm.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = tfm.init_model(cfg, gen, device=device,
                           dtype=tfm._compute_dtype(cfg))
    engine = ServingEngine(
        cfg, model, batch=args.batch, max_seq=args.max_seq,
        use_knn=args.knn_attention,
        sample="greedy" if args.greedy else "approx_topk", seed=args.seed,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.batch)
    ]
    engine.admit(reqs)
    t0 = time.time()
    engine.run(args.new_tokens)
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"[serve] {total} tokens in {dt:.2f}s "
          f"({1e3 * dt / max(args.new_tokens, 1):.1f} ms/step, batch={args.batch})")
    for r in reqs:
        print(f"  req {r.rid}: {r.generated}")


if __name__ == "__main__":
    main()
