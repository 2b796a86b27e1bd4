"""Serve a language model on the PyTorch port with batched requests:
prefill and greedy decode with KV/SSM caches, at the arch's ``reduced()``
size unless ``--full``.  Runs on the card unless told otherwise.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch mamba2-1.3b \\
        [--device cpu]
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--full", action="store_true",
                    help="the arch's published size (the card only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve_main(["--arch", args.arch, "--batch", str(args.batch), "--gen",
                str(args.gen), "--device", args.device]
               + ([] if args.full else ["--reduced"]))


if __name__ == "__main__":
    main()
