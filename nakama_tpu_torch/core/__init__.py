"""Core domain services (L1).

Plain async functions/classes `(db, ...) -> result` mirroring the
reference's `server/core_*.go` services (SURVEY.md §2.2). The port's
copy of the JAX package's `core/`: authenticate and link (device, email,
custom and the six social providers), storage, account, wallet, friend,
group, channel, notification and purchase.
"""

from .storage import (
    StorageError,
    StorageObject,
    StorageOpDelete,
    StorageOpRead,
    StorageOpWrite,
    StoragePermissionError,
    StorageVersionError,
    storage_delete_objects,
    storage_list_objects,
    storage_read_objects,
    storage_write_objects,
)

__all__ = [
    "StorageError",
    "StorageObject",
    "StorageOpDelete",
    "StorageOpRead",
    "StorageOpWrite",
    "StoragePermissionError",
    "StorageVersionError",
    "storage_delete_objects",
    "storage_list_objects",
    "storage_read_objects",
    "storage_write_objects",
]
