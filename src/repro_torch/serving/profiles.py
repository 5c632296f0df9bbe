# Copy of src/repro/serving/profiles.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Per-DNN execution profiles, calibrated against the paper's Table I ONLY.

Table I (RTX 2080 Ti, 224x224x3 input, JPS = jobs/sec):
    DNN          min JPS   max JPS (batched)   gain
    ResNet18       627        1025             1.63x
    ResNet50       250         433             1.73x
    UNet           241         260             1.08x
    InceptionV3    142         446             3.13x

Calibration mapping (DESIGN.md §2, contention model):
  * t_alone = 1000 / min_JPS ms                    (single stream, alone)
  * n_sat   = N_units / gain                       (batching gain comes from
               filling the SMs a single instance can't occupy: UNet is wide
               -> saturates nearly all, InceptionV3 narrow -> ~22)
  * mem_frac encodes the architecture narrative: UNet memory-heavy (skip
    connections), ResNets moderate, InceptionV3 compute-narrow.

Stages follow the paper: ResNet -> 4 logical stages; UNet -> 4 (enc x2,
bottleneck, dec); InceptionV3 -> 4 block groups. Stage time split uses the
blocks' relative FLOPs (approximate, stated per stage below).
"""
from __future__ import annotations

from typing import List

from ..core.task import StageProfile, TaskSpec
from ..runtime.contention import DeviceModel, speedup_curve

N_UNITS = 68.0          # RTX 2080 Ti SMs

TABLE1 = {
    # name: (min_jps, max_jps)
    "resnet18": (627.0, 1025.0),
    "resnet50": (250.0, 433.0),
    "unet": (241.0, 260.0),
    "inceptionv3": (142.0, 446.0),
}

MEM_FRAC = {"resnet18": 0.42, "resnet50": 0.40, "unet": 0.72,
            "inceptionv3": 0.22}

# relative per-stage work (4 stages each, sums to 1)
STAGE_SPLIT = {
    "resnet18": (0.30, 0.26, 0.24, 0.20),
    "resnet50": (0.28, 0.27, 0.25, 0.20),
    "unet": (0.22, 0.26, 0.28, 0.24),
    "inceptionv3": (0.30, 0.28, 0.24, 0.18),
}

OVERHEAD_MS = 0.015      # per-stage dispatch/sync cost (staging price)


def batching_gain(name: str) -> float:
    mn, mx = TABLE1[name]
    return mx / mn


def n_sat(name: str) -> float:
    return max(6.0, N_UNITS / batching_gain(name))


def t_alone_ms(name: str) -> float:
    return 1000.0 / TABLE1[name][0]


def effective_batch_profile(name: str, batch: int) -> tuple:
    """(t_alone_b, n_sat_b) for a batched instance: kernels widen with batch
    (n_sat grows, saturating at the device) and per-job gain follows the
    shared ``speedup_curve`` toward the Table I asymptote."""
    g_b = speedup_curve(batching_gain(name), batch)
    t_b = batch * t_alone_ms(name) / g_b
    ns_b = min(N_UNITS, n_sat(name) * (batch ** 0.7))
    return t_b, ns_b


def make_stages(name: str, batch: int = 1, n_stages: int = 4) -> List[StageProfile]:
    if batch > 1:
        # statically pre-batched spec: the gain is already folded into
        # t_alone, so dynamic batching on top would double-count it
        t_total, ns, gain = (*effective_batch_profile(name, batch), 1.0)
    else:
        t_total, ns = t_alone_ms(name), n_sat(name)
        gain = batching_gain(name)     # drives contention.batch_speedup
    split = STAGE_SPLIT[name][:n_stages]
    norm = sum(split)
    return [StageProfile(name=f"{name}/s{j}",
                         t_alone_ms=t_total * w / norm,
                         n_sat=ns, mem_frac=MEM_FRAC[name],
                         overhead_ms=OVERHEAD_MS, batch_gain=gain)
            for j, w in enumerate(split)]


def make_task(name: str, *, priority: int, jps: float, batch: int = 1,
              tag: str = "") -> TaskSpec:
    period = 1000.0 / jps
    return TaskSpec(name=f"{name}{tag}", period_ms=period, priority=priority,
                    stages=make_stages(name, batch), batch=batch)


def device() -> DeviceModel:
    return DeviceModel(n_units=N_UNITS, bubble=0.12)
