"""Training launcher:  python -m repro_torch.launch.train --arch <id>
[--device cuda|cpu] [options].

The twin of ``python -m repro.launch.train`` (the same flags, plus
``--device``): trains a reduced config (the default) or, with ``--full``,
the published one from seeded random weights on the deterministic
synthetic stream, with checkpoints, and prints the loss curve.  Runs on
``--device`` (default ``cuda``).  ``--mesh single|multi`` trains on the
JAX package's production mesh shape, 16 x 16 ("data", "model") or 2 x 16
x 16 ("pod", "data", "model"), opened as a ``DeviceMesh`` over the cards
present (``--device cuda``), repeated, or over the CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import param_count_analytic
from repro_torch.train import Trainer, TrainerConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="smoke-scale config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--micro-batch", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_mesh(args: argparse.Namespace):
    """The ``DeviceMesh`` of ``--mesh`` (None for ``none``): the production
    shape over ``--device``'s devices (the visible cards for ``cuda``),
    repeated round-robin."""
    if args.mesh == "none":
        return None
    multi = args.mesh == "multi"
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return make_mesh(shape, axes, devices=None if args.device.startswith("cuda") and ":" not in args.device
                     else [args.device])


def build(args: argparse.Namespace):
    """(model config, trainer config) of the parsed flags."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainerConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, micro_batch=args.micro_batch,
        grad_accum=args.grad_accum, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 1),
        compress_grads=args.compress_grads,
    )
    return cfg, tcfg


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, tcfg = build(args)
    mesh = build_mesh(args)
    where = args.device if mesh is None else f"mesh {'x'.join(map(str, mesh.shape))} of {args.device}"
    print(f"{args.arch}: {param_count_analytic(cfg)/1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'FULL'}) on {where}")
    trainer = Trainer(cfg, tcfg, mesh=mesh, device=args.device)
    _, hist = trainer.run(args.steps)
    for h in hist[:: max(len(hist) // 10, 1)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  lr {h['lr']:.2e}")
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
