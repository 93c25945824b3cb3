"""Typed configuration system with defaults and observers.

Reference parity: md_config_t (common/config.h:78,96) over the generated
OPTION() table (common/config_opts.h).  Re-designed as a declarative Option
registry: each subsystem registers options at import time; values set over
the defaults notify observers with the set of changed keys, like
md_config_t::apply_changes.  The reference's layered parse (config file,
environment, argv, injectargs) comes with the first ported daemon.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

OPT_TYPES = ("int", "float", "bool", "str", "addr", "uuid", "size")


def _parse_size(v: str) -> int:
    suffixes = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    s = str(v).strip().lower()
    if s and s[-1] in suffixes:
        return int(float(s[:-1]) * suffixes[s[-1]])
    return int(s, 0) if isinstance(v, str) else int(v)


def _coerce(type_: str, v: Any) -> Any:
    if type_ == "int":
        return int(v, 0) if isinstance(v, str) else int(v)
    if type_ == "float":
        return float(v)
    if type_ == "bool":
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)
    if type_ == "size":
        return _parse_size(v)
    return str(v)


@dataclass
class Option:
    name: str
    type: str
    default: Any
    desc: str = ""
    # observer-safe options may change at runtime; others need restart
    runtime: bool = True

    def __post_init__(self):
        assert self.type in OPT_TYPES, self.type
        if self.default is not None:
            self.default = _coerce(self.type, self.default)


class Config:
    """Typed config with change observers.

    Meta-variable expansion supports $name/$cluster/$type/$id/$pid like the
    reference's md_config_t::expand_meta.
    """

    def __init__(self, options: Optional[Iterable[Option]] = None):
        self._lock = threading.RLock()
        self._schema: Dict[str, Option] = {}
        self._values: Dict[str, Any] = {}
        self._observers: List[Tuple[Tuple[str, ...], Callable[[set], None]]] = []
        self._meta = {"cluster": "ceph-tpu", "name": "client.admin",
                      "type": "client", "id": "admin", "pid": str(os.getpid())}
        for opt in DEFAULT_OPTIONS:
            self.register(opt)
        for opt in options or ():
            self.register(opt)

    # -- schema ------------------------------------------------------------
    def register(self, opt: Option) -> None:
        with self._lock:
            self._schema[opt.name] = opt

    def register_many(self, opts: Iterable[Option]) -> None:
        for o in opts:
            self.register(o)

    def schema(self) -> Dict[str, Option]:
        return dict(self._schema)

    # -- meta --------------------------------------------------------------
    def set_daemon_name(self, type_: str, id_: str) -> None:
        with self._lock:
            self._meta.update(
                {"type": type_, "id": id_, "name": f"{type_}.{id_}"})

    def expand_meta(self, s: str) -> str:
        if not isinstance(s, str) or "$" not in s:
            return s
        out = s
        for k, v in self._meta.items():
            out = out.replace("$" + k, v)
        return out

    # -- get/set -----------------------------------------------------------
    def get(self, name: str) -> Any:
        with self._lock:
            opt = self._schema[name]
            v = self._values.get(name, opt.default)
            return self.expand_meta(v) if opt.type == "str" else v

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, notify: bool = True) -> None:
        self.set_many({name: value}, notify=notify)

    def set_many(self, kv: Dict[str, Any], notify: bool = True) -> None:
        changed = set()
        with self._lock:
            for name, value in kv.items():
                if name not in self._schema:
                    raise KeyError(f"unknown config option {name!r}")
                opt = self._schema[name]
                cv = _coerce(opt.type, value)
                if self._values.get(name, opt.default) != cv:
                    self._values[name] = cv
                    changed.add(name)
        if notify and changed:
            self._notify(changed)

    # -- observers ---------------------------------------------------------
    def add_observer(self, keys: Iterable[str], fn: Callable[[set], None]) -> None:
        with self._lock:
            self._observers.append((tuple(keys), fn))

    def remove_observer(self, fn: Callable[[set], None]) -> None:
        with self._lock:
            self._observers = [(k, f) for k, f in self._observers if f is not fn]

    def _notify(self, changed: set) -> None:
        with self._lock:
            obs = list(self._observers)
        for keys, fn in obs:
            hit = changed.intersection(keys)
            if hit:
                fn(hit)

    # -- introspection -----------------------------------------------------
    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {n: self._values.get(n, o.default)
                    for n, o in sorted(self._schema.items())}

    def diff(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)

    def dump_json(self) -> str:
        return json.dumps(self.dump(), default=str, indent=1, sort_keys=True)


# Central defaults table (reference: common/config_opts.h).  The port
# carries only the options its modules read; each slice adds the ones of
# the modules it ports.
DEFAULT_OPTIONS: List[Option] = [
    Option("log_level", "int", 1, "global log verbosity"),
    Option("log_file", "str", "", "log sink path; empty = stderr"),
    Option("log_max_recent", "int", 10000, "ring buffer size (log/Log.cc)"),
]
