"""Batched serving on the PyTorch/CUDA port: prefill + autoregressive
decode with KV caches (ring buffers for local-attention layers, recurrent
state for SSM/hybrid), through ``repro_torch.launch.serve``; the
arguments of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-2b \\
        [--device cpu]

``--device`` defaults to the card.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (big; default is smoke)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--batch", "8", "--prompt-len", "64",
            "--gen", "32", "--temperature", "0.8"]
    if not args.full:
        argv.append("--smoke")
    if args.device:
        argv += ["--device", args.device]
    return serve.main(argv)


if __name__ == "__main__":
    main()
