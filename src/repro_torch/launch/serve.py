"""Serving launcher: DARIS over partitions of one card, on PyTorch/CUDA.

Counterpart of src/repro/launch/serve.py, with the same flags and the same
staged CNNs at width 8 (real execution on wall clock):

    PYTHONPATH=src python -m repro_torch.launch.serve --contexts 2 --os 2.0 \
        --seconds 4 --dnns resnet18,unet

It serves on the card, in f32 (building a CNN there turns cuDNN's TF32
off: ``models/cnn.py``); ``--device cpu`` runs it on the host instead. The
reference's ``--ckpt`` resumes the scheduler's state from a file and saves
it after the run; the port has no scheduler-state checkpoint yet (ROADMAP.md
port queue item Q5), so with ``--ckpt`` the facade's ``load_state`` raises
``NotImplementedError`` before anything is served.
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
    if args.ckpt:
        server.load_state(args.ckpt)      # raises NotImplementedError (Q5)
    m = server.run()
    s = m.summary()
    print(f"JPS {s['jps']:.1f} | DMR HP {s['dmr_hp']:.1%} LP {s['dmr_lp']:.1%}"
          f" | resp HP {s['resp_hp']['mean']:.1f}ms LP "
          f"{s['resp_lp']['mean']:.1f}ms | rejected LP {s['rejected_lp']}")


if __name__ == "__main__":
    main()
