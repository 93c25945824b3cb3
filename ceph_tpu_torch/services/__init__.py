"""Services on RADOS (SURVEY §2.9): striping, so far.

The port's copy of ``ceph_tpu.services``.  It exports the striper alone:
the reference's package also exports the block-image service (``rbd``),
which the port does not carry yet.
"""

from ceph_tpu_torch.services.striper import (Extent, Layout,
                                             extents_by_object,
                                             file_to_extents)

__all__ = ["Extent", "Layout", "extents_by_object", "file_to_extents"]
