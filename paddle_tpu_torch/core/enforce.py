"""Typed error machinery (paddle_tpu/core/enforce.py, copied: it imports
nothing of JAX).

Analog of reference platform/enforce.h + platform/errors.h +
error_codes.proto: PADDLE_ENFORCE_* macros build typed errors with
actionable hints. Python tracebacks replace the demangled C++ stacks; the
typed taxonomy and the enforce_* checks carry over so framework errors are
catchable by kind (the reference's external_error_map equivalent for user
code)."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
           "UnimplementedError", "UnavailableError", "FatalError",
           "ExecutionTimeoutError", "enforce", "enforce_eq", "enforce_gt",
           "enforce_ge", "check_type", "check_shape"]


class EnforceNotMet(RuntimeError):
    """Base framework error (reference EnforceNotMet, enforce.h)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


def enforce(cond, message, error=InvalidArgumentError):
    """PADDLE_ENFORCE analog."""
    if not cond:
        raise error(message)


def enforce_eq(a, b, what="values", error=InvalidArgumentError):
    if a != b:
        raise error(f"expected {what} to be equal, got {a!r} vs {b!r}")


def enforce_gt(a, b, what="value", error=InvalidArgumentError):
    if not a > b:
        raise error(f"expected {what} > {b!r}, got {a!r}")


def enforce_ge(a, b, what="value", error=InvalidArgumentError):
    if not a >= b:
        raise error(f"expected {what} >= {b!r}, got {a!r}")


def check_type(value, name, expected, op_name=""):
    """reference fluid/data_feeder.py check_type."""
    if not isinstance(value, expected):
        exp = expected if isinstance(expected, tuple) else (expected,)
        names = "/".join(t.__name__ for t in exp)
        where = f" of op {op_name}" if op_name else ""
        raise InvalidArgumentError(
            f"argument {name!r}{where} must be {names}, got "
            f"{type(value).__name__}")


def check_shape(shape, name="shape"):
    if not all(isinstance(s, int) and (s > 0 or s in (-1,)) for s in shape):
        raise InvalidArgumentError(
            f"{name} must be positive ints (or -1 for deferred), got "
            f"{list(shape)}")
