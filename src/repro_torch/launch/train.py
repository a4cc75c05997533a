"""Training launcher: ``python -m repro_torch.launch.train --arch
granite-3-2b`` trains the full config on the card (random weights from
seed 0, synthetic ``TokenPipeline`` batches); ``--smoke --device cpu``
trains the reduced config on the CPU. The port of ``repro.launch.train``,
with its printout; it sets no compiler flags."""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.train.loop import train
from repro_torch.train.stragglers import PreemptionGuard


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    guard = PreemptionGuard()

    def hook(step, m):
        if step % 10 == 0:
            print(f"step {step:5d} loss {m['loss']:.4f} {m['dt']*1e3:.0f} ms",
                  flush=True)

    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                microbatches=args.microbatches, lr=args.lr, guard=guard, hook=hook,
                device=args.device)
    print(f"done: step={res.step} first_loss={res.losses[0]:.4f} "
          f"last_loss={res.losses[-1]:.4f} resumed_from={res.resumed_from}")


if __name__ == "__main__":
    main()
