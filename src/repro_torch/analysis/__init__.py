"""Runtime invariant auditor (DSAN), copied from the JAX package for
``DARIS_SANITIZE`` and ``ServerConfig.sanitize``."""
from .sanitizer import Sanitizer, SanitizerViolation

__all__ = ["Sanitizer", "SanitizerViolation"]
