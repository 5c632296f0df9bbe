"""Quickstart: DARIS scheduling the paper's ResNet18 task set (Table II)
through the PyTorch port's facade (``repro_torch.api``) on the calibrated
simulator, the twin of examples/quickstart.py. The simulator runs on the
host, so no card is needed; runs in a few seconds.

    PYTHONPATH=src python examples/quickstart_torch.py
"""
import sys

sys.path.insert(0, "src")

from repro_torch.api import ServerConfig  # noqa: E402
from repro_torch.serving.profiles import TABLE1, device  # noqa: E402
from repro_torch.serving.requests import table2_taskset  # noqa: E402


def main():
    print("DARIS quickstart: ResNet18 task set (17 HP + 34 LP @ 30 JPS)")
    print(f"pure-batching upper baseline: {TABLE1['resnet18'][1]:.0f} JPS\n")
    for nc, ns, os_ in [(1, 6, 1.0), (6, 1, 1.0), (6, 1, 6.0), (4, 1, 4.0)]:
        server = (ServerConfig.sim()
                  .tasks(table2_taskset("resnet18"))
                  .contexts(nc).streams(ns).oversubscribe(os_)
                  .device(device())
                  .horizon_ms(6000.0).seed(0)
                  .build())
        s = server.run().summary()
        policy = "STR" if nc == 1 else "MPS"
        print(f"{policy} {nc}x{ns}_OS{os_:g}: {s['jps']:7.1f} JPS | "
              f"HP DMR {s['dmr_hp']:.1%} LP DMR {s['dmr_lp']:.1%} | "
              f"resp HP {s['resp_hp']['mean']:.1f}ms / LP "
              f"{s['resp_lp']['mean']:.1f}ms | migrations {s['migrations']}")
    print("\nOversubscription (OS=Nc) recovers capacity isolation strands;")
    print("HP deadline misses stay at zero (paper §VI-A).")


if __name__ == "__main__":
    main()
