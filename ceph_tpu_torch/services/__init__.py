"""Services on RADOS (SURVEY §2.9): block images (rbd), striping.

Each service builds purely on the librados-style client API
(ceph_tpu_torch/client/rados.py) the way the reference's
librbd/libradosstriper build on librados.

The port's copy of ``ceph_tpu.services``.
"""

from ceph_tpu_torch.services.rbd import RBD, Image, ImageExists, ImageNotFound
from ceph_tpu_torch.services.striper import (Extent, Layout,
                                             extents_by_object,
                                             file_to_extents)

__all__ = ["RBD", "Image", "ImageExists", "ImageNotFound", "Extent",
           "Layout", "extents_by_object", "file_to_extents"]
