"""Shared types: status codes and the method registry.

A copy of the parts of ``ivp_tpu.types`` the port uses (importing any
``ivp_tpu`` module pulls in jax).  tests/test_torch_tableaus.py holds the two
equal.
"""
from __future__ import annotations


class Status:
    """Integration status codes carried as int32 in the solver state.

    ``RUNNING`` is internal; the public codes match ``ivp_tpu.types.Status``.
    """

    RUNNING = -1
    SUCCESS = 0
    USER_INTERRUPT = 1  # terminal event fired
    NEED_LARGER_NMAX = 2
    STEP_SIZE_TOO_SMALL = 3
    PROBABLY_STIFF = 4
    SINGULAR_MATRIX = 5
    POOR_CONVERGENCE = 6

    MESSAGES = {
        SUCCESS: "The solver successfully reached the end of the integration interval.",
        USER_INTERRUPT: "A termination event occurred.",
        NEED_LARGER_NMAX: "Maximum number of steps exceeded.",
        STEP_SIZE_TOO_SMALL: "Step size became too small.",
        PROBABLY_STIFF: "The problem appears to be stiff.",
        SINGULAR_MATRIX: "Repeatedly singular iteration matrix.",
        POOR_CONVERGENCE: "Newton iteration failed to converge.",
    }

    @staticmethod
    def to_scipy(code: int) -> int:
        if code == Status.SUCCESS:
            return 0
        if code == Status.USER_INTERRUPT:
            return 1
        return -1


METHOD_ALIASES = {
    "RK23": "RK23",
    "RK45": "DOPRI5",
    "DOPRI5": "DOPRI5",
    "DOP853": "DOP853",
    "RK4": "RK4",
    "RADAU": "RADAU",
    "RADAU5": "RADAU",
    "BDF": "BDF",
    "BDF15": "BDF",
}


# When True, unknown method names raise instead of falling back to DOPRI5.
_STRICT_METHODS = False


def strict_methods(enabled: bool = True) -> None:
    """Make unknown method names raise a ValueError instead of silently
    falling back to DOPRI5."""
    global _STRICT_METHODS
    _STRICT_METHODS = bool(enabled)


def canonical_method(method) -> str:
    """Resolve a method name/alias to its canonical key.

    Unknown strings fall back to DOPRI5 with a UserWarning, or raise when
    ``strict_methods(True)`` is set — as ``ivp_tpu.types.canonical_method``.
    """
    if method is None:
        return "DOPRI5"
    key = str(method).upper()
    if key not in METHOD_ALIASES:
        known = ", ".join(sorted(METHOD_ALIASES))
        if _STRICT_METHODS:
            raise ValueError(
                f"unknown method {method!r}; known methods: {known}")
        import warnings
        warnings.warn(
            f"unknown method {method!r}: falling back to DOPRI5; known "
            f"methods: {known}.  Call ivp_tpu_torch.strict_methods(True) to "
            f"raise instead.", UserWarning, stacklevel=3)
    return METHOD_ALIASES.get(key, "DOPRI5")
