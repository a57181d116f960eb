"""Object store: native shared-memory data plane + ownership semantics, the
port's own copy of ``raydp_tpu/store`` (``object_store``, ``block_service``
and the native segment library in ``native/store.cpp``)."""

from raydp_tpu_torch.store.object_store import (
    ObjectHolder,
    ObjectRef,
    WritableBlock,
    create_block,
    delete,
    get_arrow_buffer,
    get_buffer,
    get_bytes,
    new_object_id,
    owner_of,
    put,
    read_arrow_batches,
    transfer,
)

__all__ = [
    "ObjectHolder",
    "ObjectRef",
    "WritableBlock",
    "create_block",
    "delete",
    "get_arrow_buffer",
    "get_buffer",
    "get_bytes",
    "new_object_id",
    "owner_of",
    "put",
    "read_arrow_batches",
    "transfer",
]
