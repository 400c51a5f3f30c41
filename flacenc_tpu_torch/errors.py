"""Error taxonomy and the ``Verify``/``Verified`` gate.

Mirrors ``flacenc-rs/src/error.rs``: components and configs implement
``verify()``; encoder entry points require a ``Verified[...]`` wrapper
obtained via ``into_verified()`` so that invalid configs cannot reach the
hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, TypeVar

T = TypeVar("T")


class FlacencError(Exception):
    """Base class for all flacenc_tpu_torch errors."""


class VerifyError(FlacencError):
    """A component/config failed validation (error.rs:178-260).

    Carries a dotted path of component names from the root to the offending
    field, extended via :meth:`within` as it propagates upward.
    """

    def __init__(self, component: str, reason: str) -> None:
        self.components = [component]
        self.reason = reason
        super().__init__(reason)

    def within(self, component: str) -> "VerifyError":
        self.components.append(component)
        return self

    @property
    def path(self) -> str:
        return ".".join(reversed(self.components))

    def __str__(self) -> str:  # matches reference's Display format intent
        return f"verification error at `{self.path}`: {self.reason}"


class RangeError(FlacencError):
    """A scalar argument was out of its valid range (error.rs:123-158)."""

    def __init__(self, var: str, reason: str, actual: Any) -> None:
        self.var = var
        self.reason = reason
        self.actual = actual
        super().__init__(f"`{var}` (= {actual}) {reason}")


class OutputError(FlacencError):
    """Bitstream serialization failed (error.rs:35-118)."""


class SourceError(FlacencError):
    """Reading from a `Source` failed (error.rs:500-652)."""

    # reasons mirror error.rs SourceErrorReason
    OPEN = "cannot open file"
    INVALID_BUFFER = "buffer is invalid"
    INVALID_FORMAT = "source format is invalid"
    UNSUPPORTED_FORMAT = "source format is not supported"
    IO = "I/O error"

    def __init__(self, reason: str, source_name: str | None = None) -> None:
        self.source_name = source_name
        self.reason = reason
        prefix = f"{source_name}: " if source_name else ""
        super().__init__(prefix + reason)

    @classmethod
    def from_unknown(cls) -> "SourceError":
        return cls(cls.IO)


class EncodeError(FlacencError):
    """Encoder entry-point failure wrapping Source/Verify errors
    (error.rs:458-493)."""


def verify_range(name: str, value: Any, lo: Any = None, hi: Any = None) -> None:
    """Range check helper (error.rs ``verify_range!``); bounds inclusive."""
    if lo is not None and value < lo:
        raise VerifyError(name, f"must be >= {lo} (got {value})")
    if hi is not None and value > hi:
        raise VerifyError(name, f"must be <= {hi} (got {value})")


def verify_true(name: str, cond: bool, reason: str) -> None:
    if not cond:
        raise VerifyError(name, reason)


@dataclasses.dataclass(frozen=True)
class Verified(Generic[T]):
    """Type-state wrapper proving `inner.verify()` passed (error.rs:266-388).

    Obtained via :func:`into_verified`; encoder entry points accept either a
    ``Verified[Encoder]`` or a raw ``Encoder`` (verified on entry).
    """

    inner: T

    def __getattr__(self, item: str) -> Any:
        return getattr(self.inner, item)


def into_verified(obj: T) -> Verified[T]:
    obj.verify()  # type: ignore[attr-defined]
    return Verified(obj)


def assume_verified(obj: T) -> Verified[T]:
    """Skip verification (the reference's `unsafe assume_verified`)."""
    return Verified(obj)
