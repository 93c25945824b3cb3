"""Client I/O stack (the port's copy of ``ceph_tpu.client``; reference:
src/osdc/ Objecter + src/librados/).  ``object_cacher`` (the write-back
cache) and ``rados_striper`` (files striped over objects) are imported
by name, as in the reference."""

from ceph_tpu_torch.client.objecter import ObjectOperationError, Objecter
from ceph_tpu_torch.client.rados import IoCtx, Rados

__all__ = ["IoCtx", "ObjectOperationError", "Objecter", "Rados"]
