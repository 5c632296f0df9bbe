# Copy of src/repro/chaos/__init__.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Chaos layer: seeded fault injection + recovery policies (PR 8)."""
from .plan import (BROWNOUT, EMERGENCY, NORMAL, Brownout, ChaosPlan,
                   ChaosState, DegradationPolicy, RetryPolicy,
                   plan_from_dict)

__all__ = [
    "Brownout", "ChaosPlan", "ChaosState", "DegradationPolicy",
    "RetryPolicy", "plan_from_dict", "NORMAL", "BROWNOUT", "EMERGENCY",
]
