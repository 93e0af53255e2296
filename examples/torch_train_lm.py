"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
with the full production path (prefetched pipeline, cosine schedule,
async checkpointing, auto-resume), the counterpart of
``examples/train_lm.py`` on the port.

  python examples/torch_train_lm.py --steps 200                  # on the card
  python examples/torch_train_lm.py --device cpu --steps 20 \\
      --arch internlm2-1.8b-smoke --seq 32 --lr 3e-3             # on the CPU
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ModelConfig, list_configs, register  # noqa: E402

# ~100M params: 8L x 512d x 16H, vocab 32k.
LM_100M = ModelConfig(
    name="examples-lm-100m",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=16,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=32768,
    q_chunk=128,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=LM_100M.name)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if LM_100M.name not in list_configs():
        register(LM_100M)

    from repro_torch.launch import train

    return train.main([
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--seq", str(args.seq), "--global-batch", str(args.global_batch),
        "--lr", str(args.lr), "--warmup", "20",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", str(args.log_every), "--device", args.device,
    ])


if __name__ == "__main__":
    main()
