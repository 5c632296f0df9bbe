"""Zero-delay migration demo on the PyTorch port, both layers of the stack
(the twin of examples/migrate_zero_delay.py):

Act 1 -- the *mechanism*: a staged LM job (reduced smollm-135m, 8 layers,
4 stages, f32) moves between partitions at stage boundaries by moving its
inter-stage hidden state (``serving.staging.migrate``): stages 0-1 run on
the host, stage 2 on the card on one CUDA stream (the lane of one
context), stage 3 on another stream (another context's lane) after a
stream hand-off, which orders the second lane after the first without a
copy. The result is held to the whole job run on the card alone. With
``--device cpu`` every partition is the host (the moves are no-ops).

Act 2 -- the *policy*: a context dies mid-run, DARIS re-runs Algorithm 1,
in-flight stages replay on surviving partitions, and a scale-out restores
capacity, through the ``repro_torch.api`` facade (simulator).

Act 3 -- *live elastic repartitioning*: the Eq. 9 geometry is reshaped
mid-run (``reconfigure_at``); HP deadlines survive untouched.

    PYTHONPATH=src python examples/migrate_zero_delay_torch.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.staging import make_lm_stage_fns, migrate  # noqa: E402,E501

# the card and the host multiply in different orders: of the logits' scale
TOL = 1e-4


def main(device=None):
    card = resolve_device(device)
    host = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("smollm-135m").replace(n_layers=8)
    model = build_model(cfg, device=host)
    params = model.init_params(0)
    stages = make_lm_stage_fns(model, n_stages=4)
    pos = torch.arange(32, dtype=torch.int32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)))
    # candidate partitions hold the weights up front, so a migration
    # moves only the activation
    params_card = migrate(params, card)
    pos_card = migrate(pos, card)
    print(f"partition A: {host}; partitions B and C: {card}"
          + (" (two streams)" if card.type == "cuda" else ""))

    with torch.no_grad():
        x = tokens
        for i in (0, 1):                       # partition A: the host
            x, _ = stages[i](params, x, None, pos)
        t0 = time.perf_counter()
        x = migrate(x, card)                   # A -> B at a stage boundary
        if card.type == "cuda":
            torch.cuda.synchronize(card)
        mig_ms = (time.perf_counter() - t0) * 1e3
        lane_b = torch.cuda.Stream(card) if card.type == "cuda" else None
        lane_c = torch.cuda.Stream(card) if card.type == "cuda" else None
        if lane_b is not None:
            lane_b.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(lane_b):
                x, _ = stages[2](params_card, x, None, pos_card)
            # B -> C: the hand-off orders lane C after lane B's stage, and
            # the tensor's memory stays in use until lane C is done with it
            lane_c.wait_stream(lane_b)
            x.record_stream(lane_c)
            with torch.cuda.stream(lane_c):
                x, _ = stages[3](params_card, x, None, pos_card)
            torch.cuda.current_stream(card).wait_stream(lane_c)
        else:
            for i in (2, 3):
                x, _ = stages[i](params_card, x, None, pos_card)
        ref = tokens.to(card)
        for i in range(4):                     # the whole job on B alone
            ref, _ = stages[i](params_card, ref, None, pos_card)
        err = float((x - ref).abs().max() / ref.abs().max())
    print(f"\nmigration (hidden state, host -> {card}): {mig_ms:.2f} ms")
    print(f"logits max |A, B, C minus all-B| / max |all-B| = {err:.2e} "
          f"(limit {TOL:g})")
    print("no running program was interrupted: migration happened between "
          "stage programs -- the paper's 'zero-delay' property (§I).")
    assert err <= TOL, err


def scheduled_migration_demo():
    """Act 2: the same property at the scheduler level, through the
    facade -- fault at 2 s, elastic scale-out at 3.5 s."""
    from repro_torch.api import ServerConfig
    from repro_torch.serving.profiles import device
    from repro_torch.serving.requests import table2_taskset

    server = (ServerConfig.sim()
              .tasks(table2_taskset("resnet18"))
              .contexts(4).streams(1).oversubscribe(4.0)
              .device(device())
              .horizon_ms(5000.0).seed(0)
              .fail_context_at(0, 2000.0)
              .scale_out_at(3500.0)
              .build())
    s = server.run().summary()
    snap = server.snapshot()
    alive = [c["index"] for c in snap["contexts"] if c["alive"]]
    print("\nfault drill via repro_torch.api: ctx0 died @2s, scale-out @3.5s")
    print(f"surviving contexts: {alive} | faults {s['faults']} "
          f"| migrations {s['migrations']}")
    print(f"HP DMR {s['dmr_hp']:.1%} (orphaned stages replayed at stage "
          f"granularity; HP stayed protected)")
    print(f"throughput {s['jps']:.0f} JPS across the fault window")


def elastic_reconfigure_demo():
    """Act 3: online repartitioning -- 4x1 OS=4 reshaped to 6x1 OS=6 at
    2 s and back down to 3 contexts at 3.5 s, without draining."""
    from repro_torch.api import ServerConfig
    from repro_torch.serving.profiles import device
    from repro_torch.serving.requests import table2_taskset

    server = (ServerConfig.sim()
              .tasks(table2_taskset("resnet18"))
              .contexts(4).streams(1).oversubscribe(4.0)
              .device(device())
              .horizon_ms(5000.0).seed(0)
              .reconfigure_at(2000.0, n_contexts=6, oversubscription=6.0)
              .reconfigure_at(3500.0, n_contexts=3)
              .build())
    s = server.run().summary()
    live = [c.index for c in server.scheduler.contexts if c.alive]
    print(f"\nelastic repartition via repro_torch.api: 4 ctx -> 6 ctx @2s "
          f"-> 3 ctx @3.5s ({s['reconfigures']} reconfigures)")
    print(f"live contexts: {live} | migrations {s['migrations']} "
          f"| HP DMR {s['dmr_hp']:.1%} (zero-delay: in-flight stages "
          f"finished on retired lanes, moved at stage boundaries)")
    assert s["dmr_hp"] == 0.0, "HP deadlines must survive a reshape"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu: every partition on the host (default: the "
                         "card)")
    args = ap.parse_args()
    main(args.device)
    scheduled_migration_demo()
    elastic_reconfigure_demo()
