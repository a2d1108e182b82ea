"""Framework exception types (reference: src/errors.h, src/bucket.h:53-64)."""

from __future__ import annotations


class MlsError(Exception):
    """Base class for all framework errors."""


class StateError(MlsError):
    """An object was used in an invalid state (reference state_error)."""


class InvalidOption(MlsError):
    """An invalid configuration value (reference invalid_option)."""


class FormatError(MlsError):
    """Malformed input file (reference FastPly::FormatError)."""


class DensityError(MlsError):
    """A single microblock exceeded the splat budget; the region cannot be
    subdivided further (reference Bucket::DensityError, src/bucket.h:53-64)."""

    def __init__(self, msg: str, num_splats: int = 0):
        super().__init__(msg)
        self.num_splats = num_splats


class CapacityError(MlsError):
    """A static device-side cap (occupied cells / vertices / indices /
    per-tile candidates) overflowed. Callers catch this and retry with a
    larger cap (the XLA analogue of the reference's ship-out-when-full,
    src/marching.h:77-80)."""

    def __init__(self, msg: str, kind: str = "", needed: int = 0, cap: int = 0):
        super().__init__(msg)
        self.kind = kind
        self.needed = needed
        self.cap = cap


def mls_assert(cond: bool, exc_type: type = AssertionError, msg: str = "") -> None:
    """Throwing assert (reference MLSGPU_ASSERT, src/errors.h:36-80)."""
    if not cond:
        raise exc_type(msg or "assertion failed")
