"""Baselines: compression algorithms + model stores the paper compares.

The port's own copy of the reference's ``repro/baselines``: numpy, ``zlib``
and ``struct`` on the host (``zstandard`` where it is installed), with the
reference's bytes. Nothing here touches the card."""

from .compressors import ALL_COMPRESSORS
from .stores import BlobStore, FileStore

__all__ = ["ALL_COMPRESSORS", "BlobStore", "FileStore"]
