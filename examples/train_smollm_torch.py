"""Train a SmolLM-family model on the PyTorch/CUDA port with the full
training substrate: synthetic pipeline, AdamW, remat, grad accumulation,
checkpointing. Twin of examples/train_smollm.py over ``repro_torch``.

Default is a reduced ~6M-param config whose loss drops visibly in a couple
of minutes; --full uses the real 135M config. It trains on the card;
``--device cpu`` runs it on the host.

    PYTHONPATH=src python examples/train_smollm_torch.py --steps 200
    PYTHONPATH=src python examples/train_smollm_torch.py --device cpu \
        --steps 20
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.checkpoint import save_pytree  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig, adamw_init, tree_leaves)
from repro_torch.training.train_step import make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="artifacts/ckpt/smollm_torch")
    ap.add_argument("--device", default=None,
                    help="run on this device instead of the card (cpu)")
    args = ap.parse_args()

    cfg = get_config("smollm-135m") if args.full else \
        get_reduced("smollm-135m").replace(n_layers=6, d_model=128,
                                           d_ff=384, vocab_size=4096)
    model = build_model(cfg, device=args.device)
    params = model.init_params(0)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} ({n/1e6:.1f}M params)")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, accum=args.accum)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)

    t0 = time.time()
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(pipe.next_batch()["tokens"]).to(
            model.device)}
        params, opt, metrics = step_fn(params, opt, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    path = save_pytree(params, args.ckpt, step=args.steps)
    print(f"saved checkpoint -> {path}")


if __name__ == "__main__":
    main()
