"""Erasure-code plugin registry.

Reference parity: ErasureCodePluginRegistry
(src/erasure-code/ErasureCodePlugin.cc:26-33,90-182) — the
dlopen("libec_<name>.so") + __erasure_code_init machinery becomes a
name->class registry with import-time registration and the same error
surface (unknown plugin, failed init).  A `preload` helper mirrors the
osd_erasure_code_plugins preload option.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Type

from ceph_tpu_torch.common.device import DEFAULT_DEVICE, DeviceLike
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError

_lock = threading.Lock()
_plugins: Dict[str, Type[ErasureCode]] = {}


def register(name: str) -> Callable[[Type[ErasureCode]], Type[ErasureCode]]:
    def deco(cls: Type[ErasureCode]) -> Type[ErasureCode]:
        with _lock:
            if name in _plugins and _plugins[name] is not cls:
                raise ErasureCodeError(
                    f"erasure code plugin {name!r} already registered")
            _plugins[name] = cls
        return cls
    return deco


def _ensure_builtin() -> None:
    # importing the module registers its plugins (the "dlopen")
    import ceph_tpu_torch.ec.rs          # noqa: F401
    import ceph_tpu_torch.ec.lrc         # noqa: F401
    import ceph_tpu_torch.ec.shec        # noqa: F401


def factory(name: str, profile: Dict[str, str],
            device: DeviceLike = DEFAULT_DEVICE) -> ErasureCode:
    """Instantiate + init a codec (reference registry::factory :90-118).
    ``device`` is where its matrix applies run; a profile with
    ``backend=host`` never touches it."""
    _ensure_builtin()
    with _lock:
        cls = _plugins.get(name)
    if cls is None:
        raise ErasureCodeError(
            f"failed to load plugin {name!r}: known plugins are "
            f"{sorted(_plugins)}")
    ec = cls(device=device)
    ec.init(profile)
    return ec


def plugin_names():
    _ensure_builtin()
    with _lock:
        return sorted(_plugins)


def preload(names, device: DeviceLike = DEFAULT_DEVICE) -> None:
    """Instantiate each plugin once with its default profile so load errors
    surface at daemon start (the osd_erasure_code_plugins option)."""
    for n in names:
        factory(n, {}, device=device)
