"""Structured integrity errors for the container stack.

Every corrupt-input failure mode raises one of these instead of a raw
``struct.error`` / ``AssertionError``, so callers can tell *what* broke and
*where* without parsing message strings:

* :class:`CorruptContainerError` — the envelope itself is damaged
  (truncated file, bad magic, out-of-range footer offsets, index/lane
  extent mismatch, metadata checksum failure).  Carries the byte offset of
  the failed check and what was expected there.
* :class:`CorruptLaneError` — one entropy lane's checksum does not match
  its footer-index CRC (bit rot inside an otherwise well-formed
  container).  Carries the tile id, the lane's byte offset, and the
  expected/actual CRC, so a damaged region can be reported — or
  quarantined — tile by tile (docs/ROBUSTNESS.md).

Both subclass :class:`ValueError`: pre-existing callers that caught
``ValueError`` for corrupt input keep working unchanged.
"""
from __future__ import annotations


class IntegrityError(ValueError):
    """Base for all detected-corruption failures."""


class CorruptContainerError(IntegrityError):
    """A container envelope failed a structural or checksum validation.

    ``offset`` is the container-relative byte offset of the failed check
    (None when unknown); ``expected``/``actual`` describe it when a
    concrete comparison failed."""

    def __init__(self, message: str, *, offset: int | None = None,
                 expected=None, actual=None):
        self.offset = offset
        self.expected = expected
        self.actual = actual
        detail = []
        if offset is not None:
            detail.append(f"at byte {offset}")
        if expected is not None:
            detail.append(f"expected {expected!r}")
        if actual is not None:
            detail.append(f"got {actual!r}")
        super().__init__(message + (f" ({', '.join(detail)})" if detail else ""))


class CorruptLaneError(IntegrityError):
    """An entropy lane's bytes do not match the container's CRC for it."""

    def __init__(self, tile_id: int, *, lane_offset: int | None = None,
                 expected_crc: int | None = None, actual_crc: int | None = None):
        self.tile_id = int(tile_id)
        self.lane_offset = lane_offset
        self.expected_crc = expected_crc
        self.actual_crc = actual_crc
        loc = f" at byte {lane_offset}" if lane_offset is not None else ""
        crc = ""
        if expected_crc is not None or actual_crc is not None:
            crc = (f" (crc expected 0x{(expected_crc or 0):08x}, "
                   f"got 0x{(actual_crc or 0):08x})")
        super().__init__(
            f"corrupt entropy lane for tile {tile_id}{loc}{crc}; "
            "open with on_corrupt='quarantine' to degrade instead of failing")
