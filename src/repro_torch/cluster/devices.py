# Copy of src/repro/cluster/devices.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Device-model presets for heterogeneous clusters.

``speed`` is the scalar factor versus the reference device every
``StageProfile`` was calibrated on (the paper's RTX 2080 Ti, Table I):
an ``a100``-class device at 2.1 executes a profiled stage in 1/2.1 of
its reference time. ``n_units`` follows each part's SM count, so Eq. 9
partition geometry reflects the real device width. The numbers are
deliberately coarse (public spec-sheet ratios, not microbenchmarks) —
they exist so heterogeneous scheduling decisions have something honest
to chew on, not to re-profile every DNN per device.
"""
from __future__ import annotations

from typing import List, Union

from ..runtime.contention import DeviceModel

DEVICE_PRESETS = {
    # the calibration device itself — same issue-gap waste as
    # serving.profiles.device(), so the speed=1.0 slot of a mixed fleet
    # behaves exactly like the reference device in every other figure
    "rtx2080ti": DeviceModel(n_units=68.0, bubble=0.12, name="rtx2080ti"),
    # V100: 80 SMs, roughly 1.3x the 2080 Ti on fp16 DNN inference
    "v100": DeviceModel(n_units=80.0, bubble=0.16, l2_pressure=0.08,
                        name="v100", speed=1.3),
    # A100: 108 SMs, ~2.1x; bigger L2 eases co-tenant thrash
    "a100": DeviceModel(n_units=108.0, bubble=0.14, l2_pressure=0.06,
                        name="a100", speed=2.1),
    # L4-class edge part: narrow and slower than the reference
    "l4": DeviceModel(n_units=58.0, bubble=0.20, l2_pressure=0.10,
                      name="l4", speed=0.8),
}


def resolve_device(spec: Union[str, DeviceModel]) -> DeviceModel:
    """Accept a preset name or a ready ``DeviceModel``."""
    if isinstance(spec, DeviceModel):
        return spec
    try:
        return DEVICE_PRESETS[spec]
    except KeyError:
        raise ValueError(f"unknown device preset {spec!r}; known: "
                         f"{sorted(DEVICE_PRESETS)}") from None


def resolve_devices(specs) -> List[DeviceModel]:
    return [resolve_device(s) for s in specs]
