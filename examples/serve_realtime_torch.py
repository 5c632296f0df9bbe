"""End-to-end example: REAL PyTorch/CUDA execution of staged CNNs under
DARIS, served through the ``repro_torch.api`` facade.

Counterpart of examples/serve_realtime.py on the port: the same three DNN
families (the paper's benchmarks, at width 8), staged into 4 sub-tasks
each, the same four tasks, scheduled by the full DARIS stack (MRET
estimation from *measured* wall times, admission, priorities, migration) on
wall-clock time with one worker thread and one CUDA stream per lane.

    PYTHONPATH=src python examples/serve_realtime_torch.py [--seconds 4]

It serves on the card, in f32 (building a CNN there turns cuDNN's TF32
off: ``models/cnn.py``); ``--device cpu`` runs it on the host instead.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.api import HP, LP, DeviceModel, ServerConfig  # noqa: E402
from repro_torch.models.cnn import (build_inception, build_resnet,  # noqa: E402
                                    build_unet)
from repro_torch.serving.engine import staged_cnn_taskspec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="run on this device instead of the card (cpu)")
    args = ap.parse_args(argv)
    dev = args.device

    print("building + calibrating staged CNNs (AFET measurement)...")
    rn = build_resnet(18, width=8, device=dev)
    un = build_unet(width=8, device=dev)
    iv = build_inception(width=8, device=dev)
    specs = [
        staged_cnn_taskspec(rn, priority=HP, jps=12.0, input_hw=args.hw,
                            tag="-hp0", device=dev),
        staged_cnn_taskspec(rn, priority=LP, jps=12.0, input_hw=args.hw,
                            tag="-lp0", device=dev),
        staged_cnn_taskspec(un, priority=LP, jps=8.0, input_hw=args.hw,
                            tag="-lp0", device=dev),
        staged_cnn_taskspec(iv, priority=HP, jps=8.0, input_hw=args.hw,
                            tag="-hp0", device=dev),
    ]
    for s in specs:
        mret = sum(st.t_alone_ms for st in s.stages)
        print(f"  {s.name:18s} prio={'HP' if s.priority == HP else 'LP'} "
              f"measured t_alone={mret:6.1f}ms period={s.period_ms:.0f}ms")

    server = (ServerConfig.realtime(device=dev)
              .tasks(specs)
              .contexts(2).streams(1).oversubscribe(2.0)
              .device(DeviceModel(n_units=2.0))
              .horizon_ms(args.seconds * 1000.0)
              .phase_offsets(False)
              .realtime_io(input_hw=args.hw)
              .build())
    print(f"\nserving for {args.seconds:.0f}s of wall clock...")
    m = server.run()
    s = m.summary()
    print(f"\ncompleted: HP {m.completed[HP]}  LP {m.completed[LP]} "
          f"({s['jps']:.1f} JPS)")
    print(f"deadline miss rate: HP {s['dmr_hp']:.1%}  LP {s['dmr_lp']:.1%}")
    print(f"response ms: HP mean {s['resp_hp']['mean']:.1f} "
          f"p95 {s['resp_hp']['p95']:.1f} | LP mean "
          f"{s['resp_lp']['mean']:.1f} p95 {s['resp_lp']['p95']:.1f}")
    print(f"rejected (admission): LP {s['rejected_lp']}  HP {s['rejected_hp']}")
    print(f"skipped releases (stall protection): {s['skipped_releases']}")
    print("\nMRET adapted from measured stage times (ws=5); HP responses "
          "should sit well below LP.")


if __name__ == "__main__":
    main()
