"""Long-context serving with the paper's kNN top-k attention, on PyTorch.

The port's counterpart of ``examples/long_context_serve.py``: builds a
decoder-only model (random weights from ``--seed``), replays a prompt
through the decode step (exact attention), then runs one decode step
with (a) exact attention and (b) PartialReduce top-k attention over the
KV cache, each on copies of the caches, and compares the greedy tokens
and logits, then prints the modeled attention cost at S=524,288.
``--arch`` takes any decoder-only architecture; families without
global attention (SSM, RG-LRU) give the same step both ways.

  PYTHONPATH=src python examples/torch_long_context_serve.py \\
      [--arch internlm2-1.8b-smoke] [--device cuda]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.binning import plan_bins
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"{args.arch} is an encoder-decoder: drive it through "
                 "make_prefill_step / make_decode_step with its cross_kv")
    device = tfm.resolve_device(args.device)
    b, prompt_len, max_seq = 2, 48, 4096
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = tfm.init_model(cfg, gen, device=device, dtype=tfm._compute_dtype(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen,
                           device=device, dtype=torch.int32)

    caches = tfm.init_caches(cfg, b, max_seq, device=device)
    dec_exact = M.make_decode_step(cfg, use_knn=False, sample="greedy")
    dec_knn = M.make_decode_step(cfg, use_knn=True, sample="greedy")

    # replay the prompt (exact path), then compare one decode step both
    # ways, each on its own copy of the caches (a step writes them in place)
    for t in range(prompt_len):
        _, _, caches = dec_exact(model, tokens[:, t : t + 1], caches, t, None)
    nxt = tokens[:, -1:]
    copy = [type(c)(*(f.clone() for f in c)) for c in caches]
    t_exact = dec_exact(model, nxt, caches, prompt_len, None)
    t_knn = dec_knn(model, nxt, copy, prompt_len, None)
    agree = bool(torch.equal(t_exact[0], t_knn[0]))
    diff = float((t_exact[1].float() - t_knn[1].float()).abs().max())
    print(f"[{args.arch} on {device.type}] greedy tokens agree: {agree}; "
          f"logits maxdiff {diff:.4f}")

    # cost accounting at production scale (the long_500k cell):
    s = 524_288
    plan = plan_bins(s, cfg.knn_attention_k, cfg.knn_recall_target)
    exact_reads = s
    knn_softmax = cfg.knn_attention_k
    print(
        f"at S={s}: exact softmax over {exact_reads} keys vs "
        f"PartialReduce -> {plan.num_bins} bins -> top-{cfg.knn_attention_k} "
        f"exact softmax (E[recall]={plan.expected_recall:.3f}); "
        f"post-selection attention work /{exact_reads // knn_softmax}x"
    )


if __name__ == "__main__":
    main()
