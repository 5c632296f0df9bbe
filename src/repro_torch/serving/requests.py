# Copy of src/repro/serving/requests.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Task-set builders (paper Table II + mixed set + ratio variants).

Table II (150% overload vs the pure-batching upper baseline, 2:1 LP:HP):
    ResNet18     17 HP + 34 LP @ 30 JPS each   (51*30 = 1530 ~ 1.5*1025)
    UNet          5 HP + 10 LP @ 24 JPS each   (15*24 =  360 ~ 1.4*260)
    InceptionV3   9 HP + 18 LP @ 24 JPS each   (27*24 =  648 ~ 1.5*446)
"""
from __future__ import annotations

from typing import List

from ..core.task import HP, LP, TaskSpec
from .profiles import make_task

TABLE2 = {
    "resnet18": (17, 34, 30.0),
    "unet": (5, 10, 24.0),
    "inceptionv3": (9, 18, 24.0),
}


def table2_taskset(dnn: str, *, batch: int = 1,
                   load_scale: float = 1.0) -> List[TaskSpec]:
    n_hp, n_lp, jps = TABLE2[dnn]
    jps *= load_scale
    out = []
    for i in range(n_hp):
        out.append(make_task(dnn, priority=HP, jps=jps, batch=batch,
                             tag=f"-hp{i}"))
    for i in range(n_lp):
        out.append(make_task(dnn, priority=LP, jps=jps, batch=batch,
                             tag=f"-lp{i}"))
    return out


def mixed_taskset(*, load_scale: float = 1.0) -> List[TaskSpec]:
    """Paper §VI-D: all DNN types together (scaled to a comparable load)."""
    out = []
    for dnn, (n_hp, n_lp, jps) in TABLE2.items():
        jps *= load_scale
        for i in range(max(n_hp // 3, 1)):
            out.append(make_task(dnn, priority=HP, jps=jps, tag=f"-hp{i}"))
        for i in range(max(n_lp // 3, 1)):
            out.append(make_task(dnn, priority=LP, jps=jps, tag=f"-lp{i}"))
    return out


def ratio_taskset(dnn: str, hp_fraction: float, total: int, jps: float
                  ) -> List[TaskSpec]:
    """Paper §VI-I: vary the HP:LP ratio at a fixed offered load."""
    n_hp = round(total * hp_fraction)
    out = []
    for i in range(n_hp):
        out.append(make_task(dnn, priority=HP, jps=jps, tag=f"-hp{i}"))
    for i in range(total - n_hp):
        out.append(make_task(dnn, priority=LP, jps=jps, tag=f"-lp{i}"))
    return out
