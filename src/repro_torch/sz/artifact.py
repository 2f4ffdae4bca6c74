"""Container magic registry (port of ``repro/sz/artifact.py``).

The first four bytes of every compressed container name it; container
modules claim their magic with :func:`register_container` at import time
and :func:`from_bytes` dispatches on it.  The wire constants are the
reference's, byte for byte, so containers cross between the two packages.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.errors import CorruptContainerError

MAGIC_LEN = 4


@dataclass(frozen=True)
class ContainerTag:
    """One container family's wire identity: 4-byte magic, current format
    version (None when unversioned) and footer sentinel (None when absent)."""

    name: str
    magic: bytes
    version: int | None = None
    sentinel: bytes | None = None


GWTC_MAGIC, GWTC_VERSION = b"GWTC", 3  # tiled container (docs/TILED_FORMAT.md)
SZJX_MAGIC = b"SZJX"                   # monolithic artifact
GWDS_MAGIC, GWDS_VERSION = b"GWDS", 2  # multi-field dataset
GWDS_SENTINEL = b"GWDX"
JOURNAL_MAGIC, JOURNAL_VERSION = b"GWJL", 1
ENTROPY_MAGIC = b"RPRE"                # entropy lane blob (docs/ENTROPY_FORMAT.md)

CONTAINER_TAGS: dict[str, ContainerTag] = {
    "GWTC": ContainerTag("GWTC", GWTC_MAGIC, GWTC_VERSION),
    "SZJX": ContainerTag("SZJX", SZJX_MAGIC),
    "GWDS": ContainerTag("GWDS", GWDS_MAGIC, GWDS_VERSION, GWDS_SENTINEL),
    "GWJL": ContainerTag("GWJL", JOURNAL_MAGIC, JOURNAL_VERSION),
    "RPRE": ContainerTag("RPRE", ENTROPY_MAGIC),
}

_CONTAINERS: dict[bytes, type] = {}


def register_container(magic: bytes, cls: type) -> None:
    """Claim a 4-byte magic for a container class (idempotent per class)."""
    if len(magic) != MAGIC_LEN:
        raise ValueError(f"container magic must be {MAGIC_LEN} bytes, got {magic!r}")
    existing = _CONTAINERS.get(magic)
    if existing is not None and existing is not cls:
        raise ValueError(f"magic {magic!r} already registered to {existing.__name__}")
    _CONTAINERS[magic] = cls


def sniff_magic(blob) -> bytes:
    if len(blob) < MAGIC_LEN:
        raise CorruptContainerError(
            "blob too short to hold a container magic", offset=0,
            expected=f">= {MAGIC_LEN} bytes", actual=len(blob))
    return bytes(blob[:MAGIC_LEN])


def from_bytes(blob):
    """Rebuild whichever registered container the blob's magic names."""
    magic = sniff_magic(blob)
    cls = _CONTAINERS.get(magic)
    if cls is None:
        known = ", ".join(sorted(m.decode("ascii", "replace") for m in _CONTAINERS))
        raise CorruptContainerError(
            f"unknown container magic (registered: {known})",
            offset=0, actual=bytes(magic))
    return cls.from_bytes(blob)
