"""Train a language model on the PyTorch port with the full substrate:
deterministic data, AdamW and a cosine schedule, checkpoints and resume,
straggler monitoring, at the arch's ``reduced()`` size.  Runs on the card
unless told otherwise.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
"""

import argparse

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
            "--batch", "8", "--seq", str(args.seq), "--ckpt-dir",
            args.ckpt_dir, "--ckpt-every", "50", "--device", args.device]
    if args.resume:
        argv.append("--resume")
    losses = train_main(argv)
    if losses[-1] >= losses[0]:
        raise SystemExit(f"the loss did not fall: {losses[0]:.3f} -> "
                         f"{losses[-1]:.3f}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")


if __name__ == "__main__":
    main()
