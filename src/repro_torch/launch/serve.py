"""Serving launcher: DARIS over partitions of one card, on PyTorch/CUDA.

Counterpart of src/repro/launch/serve.py, with the same flags and the same
staged CNNs at width 8 (real execution on wall clock):

    PYTHONPATH=src python -m repro_torch.launch.serve --contexts 2 --os 2.0 \
        --seconds 4 --dnns resnet18,unet

It serves on the card, in f32 (building a CNN there turns cuDNN's TF32
off: ``models/cnn.py``); ``--device cpu`` runs it on the host instead.
``--ckpt FILE`` resumes the scheduler's state from ``FILE`` when it exists
and saves it there after the run (the JAX package's format: either
package's file resumes the other's server).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--contexts", type=int, default=2)
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--os", type=float, default=2.0, dest="oversub")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--dnns", default="resnet18,inceptionv3")
    ap.add_argument("--jps", type=float, default=10.0)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="run on this device instead of the card (cpu)")
    args = ap.parse_args(argv)

    from ..api import HP, LP, DeviceModel, ServerConfig
    from ..models.cnn import BUILDERS
    from ..serving.engine import staged_cnn_taskspec

    specs = []
    for name in args.dnns.split(","):
        model = BUILDERS[name](width=8, device=args.device)
        specs.append(staged_cnn_taskspec(model, priority=HP, jps=args.jps,
                                         input_hw=args.hw, tag="-hp",
                                         device=args.device))
        specs.append(staged_cnn_taskspec(model, priority=LP, jps=args.jps,
                                         input_hw=args.hw, tag="-lp",
                                         device=args.device))
    server = (ServerConfig.realtime(device=args.device)
              .tasks(specs)
              .contexts(args.contexts).streams(args.streams)
              .oversubscribe(args.oversub)
              .device(DeviceModel(n_units=float(args.contexts)))
              .horizon_ms(args.seconds * 1000.0)
              .phase_offsets(False)
              .realtime_io(input_hw=args.hw)
              .build())
    sched = server.scheduler
    if args.ckpt:
        import os
        from ..checkpoint import load_scheduler_state
        if os.path.exists(args.ckpt):
            load_scheduler_state(sched, args.ckpt)
            print(f"resumed scheduler state from {args.ckpt} "
                  f"(AFET cold-start skipped)")
    m = server.run()
    s = m.summary()
    print(f"JPS {s['jps']:.1f} | DMR HP {s['dmr_hp']:.1%} LP {s['dmr_lp']:.1%}"
          f" | resp HP {s['resp_hp']['mean']:.1f}ms LP "
          f"{s['resp_lp']['mean']:.1f}ms | rejected LP {s['rejected_lp']}")
    if args.ckpt:
        from ..checkpoint import save_scheduler_state
        save_scheduler_state(sched, args.ckpt)
        print(f"scheduler state saved -> {args.ckpt}")


if __name__ == "__main__":
    main()
