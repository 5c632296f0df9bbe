"""Training launcher: any assigned arch, reduced or full config.

Counterpart of src/repro/launch/train.py, with the same flags and
printout, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --reduced --steps 100 --batch 8 --seq 128

It trains on the card; ``--device cpu`` runs it on the host instead (keep
``--reduced`` there). ``--ckpt FILE`` saves the parameters through the
port's ``checkpoint.save_pytree`` every ``--ckpt-every`` steps and after
the last one (the JAX package's format).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="run on this device instead of the card (cpu)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config, get_reduced
    from ..data.pipeline import TokenPipeline
    from ..models import build_model
    from ..models.transformer import TORCH_DTYPES
    from ..training.optimizer import AdamWConfig, adamw_init, tree_leaves
    from ..training.train_step import make_train_step

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init_params(0)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n/1e6:.1f}M family={cfg.family}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, accum=args.accum)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)

    rng = np.random.default_rng(0)
    dt = TORCH_DTYPES[cfg.dtype]
    t0 = time.time()
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(pipe.next_batch()["tokens"]).to(
            dev)}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.normal(size=(
                args.batch, cfg.encoder_frames, cfg.d_model)).astype(
                    np.float32)).to(dev, dt)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.from_numpy(rng.normal(size=(
                args.batch, cfg.n_image_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev, dt)
        params, opt, metrics = step_fn(params, opt, batch)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            from ..checkpoint import save_pytree
            save_pytree(params, args.ckpt, step=i + 1)
    if args.ckpt:
        from ..checkpoint import save_pytree
        print("saved:", save_pytree(params, args.ckpt, step=args.steps))


if __name__ == "__main__":
    main()
