"""Erasure-code engine: GF(2^8) codecs over a CUDA matrix-apply kernel.

The port's copy of ``ceph_tpu.ec``.  Parity map:
  interface.py  <- erasure-code/ErasureCodeInterface.h, ErasureCode.cc
  registry.py   <- erasure-code/ErasureCodePlugin.cc (dlopen registry)
  rs.py         <- jerasure + isa plugins (matrix techniques)
  lrc.py        <- lrc plugin (layered sub-codecs, local repair)
  shec.py       <- shec plugin (shingled sparse parities)
  bitmatrix.py  <- jerasure liberation / blaum_roth techniques
  gf256.py      <- gf-complete/jerasure matrix prep, isa gf_gen_* matrices
  kernel.py     <- isa-l x86 GF(2^8) kernels -> byte-permute (prmt) CUDA
                   kernel (csrc/gf_apply.cu)
"""

from ceph_tpu_torch.ec.interface import (CHUNK_ALIGN, ErasureCode,
                                         ErasureCodeError)
from ceph_tpu_torch.ec.registry import factory, plugin_names, register

__all__ = ["CHUNK_ALIGN", "ErasureCode", "ErasureCodeError", "factory",
           "plugin_names", "register"]
