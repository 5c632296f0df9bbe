# Copy of src/repro/cluster/__init__.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Multi-GPU DARIS: global admission, cross-GPU zero-delay migration,
heterogeneous device models. See ``cluster.scheduler`` for the design.

    from repro.api import ServerConfig
    server = (ServerConfig.cluster(4, device_models=["a100", "v100"])
              .tasks(specs).contexts(4).oversubscribe(4.0)
              .horizon_ms(6000).build())
"""
from .devices import DEVICE_PRESETS, resolve_device, resolve_devices
from .scheduler import ClusterScheduler

__all__ = ["ClusterScheduler", "DEVICE_PRESETS", "resolve_device",
           "resolve_devices"]
