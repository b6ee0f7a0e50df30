"""End-to-end training on the PyTorch/CUDA port: the ~130M-param
mamba2-130m on the deterministic synthetic pipeline, with checkpoints,
through ``repro_torch.launch.train``; the arguments of
``examples/train_lm.py``, and its check that the loss decreases.

    PYTHONPATH=src python examples/train_lm_torch.py     # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --seq 512
    PYTHONPATH=src python examples/train_lm_torch.py --smoke --steps 8 \\
        --seq 32 --device cpu

``--smoke`` takes the reduced smoke config. Checkpoints go to
``--ckpt-dir`` (by default ``build/ckpt_mamba2``, or
``build/ckpt_mamba2_smoke`` under ``--smoke``, in the repository), and a
run resumes from the newest one there; a run whose checkpoint already holds
``--steps`` steps trains nothing and says so.
"""
import argparse
import os

from repro_torch.launch import train
from repro_torch.train import checkpoint

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def default_ckpt_dir(smoke: bool) -> str:
    """The config's own checkpoint directory: the two configs' params
    differ in shape, so neither may resume from the other's."""
    return os.path.join(ROOT, "build",
                        "ckpt_mamba2_smoke" if smoke else "ckpt_mamba2")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: build/ckpt_mamba2[_smoke]")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or default_ckpt_dir(args.smoke)
    done = checkpoint.latest_step(ckpt_dir)
    if done is not None and done >= args.steps:
        print(f"nothing to train: {ckpt_dir} is at step {done} of "
              f"{args.steps}")
        return []
    argv = ["--arch", "mamba2-130m", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "25",
            "--lr", "6e-4"]
    if args.smoke:
        argv.append("--smoke")
    if args.device:
        argv += ["--device", args.device]
    losses = train.main(argv)
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
