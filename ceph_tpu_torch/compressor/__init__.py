"""Compressor plugins (the port's copy of ``ceph_tpu.compressor``)."""

from ceph_tpu_torch.compressor.registry import (Compressor, CompressorError,
                                          cached, create, plugin_names)

__all__ = ["Compressor", "CompressorError", "cached", "create",
           "plugin_names"]
