"""mgr-lite: the manager daemon — cluster-state module host.

Reference parity: src/mgr/Mgr.cc:1 + PyModules — the mgr subscribes to
cluster state and hosts modules that consume it (dashboard, prometheus,
balancer...).  Here the module host polls the mon's status/pg-dump
commands (the MgrStatMonitor feed role) and ships two built-in modules:

  * dashboard: an HTTP endpoint serving /health /status /pgmap /osds
    as JSON (the reference dashboard's data layer, sans UI)
  * balancer: computes per-osd PG spread and proposes (or applies)
    reweights via `osd reweight-by-utilization` — the reference
    balancer module's upmap/crush-compat role reduced to reweights

The port's copy of ``ceph_tpu.services.mgr``.
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, List, Optional


class MgrModule:
    name = "?"

    def __init__(self, mgr: "Mgr"):
        self.mgr = mgr

    async def serve(self) -> None:
        """Long-running module body; cancelled on shutdown."""

    async def stop(self) -> None:
        pass


class DashboardModule(MgrModule):
    name = "dashboard"

    def __init__(self, mgr, port: int = 0):
        super().__init__(mgr)
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self) -> None:
        self._server = await asyncio.start_server(
            self._client, "127.0.0.1", self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        await asyncio.Event().wait()    # run until cancelled

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()

    async def _client(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            path = line.split()[1].decode() if line.split() else "/"
            body = await self._route(path)
            payload = json.dumps(body, default=str).encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                + payload)
            await writer.drain()
        except Exception:
            pass
        finally:
            writer.close()

    async def _route(self, path: str) -> dict:
        if path.startswith("/health"):
            ack = await self.mgr.admin.mon_command({"prefix": "health"})
            return json.loads(ack.outs)
        if path.startswith("/pgmap"):
            ack = await self.mgr.admin.mon_command({"prefix": "pg dump"})
            return json.loads(ack.outs)
        if path.startswith("/osds"):
            ack = await self.mgr.admin.mon_command({"prefix": "osd dump"})
            return json.loads(ack.outs)
        ack = await self.mgr.admin.mon_command({"prefix": "status"})
        return json.loads(ack.outs)


class BalancerModule(MgrModule):
    name = "balancer"

    def __init__(self, mgr, interval: float = 30.0, auto: bool = False):
        super().__init__(mgr)
        self.interval = interval
        self.auto = auto
        self.last_eval: Dict = {}

    async def serve(self) -> None:
        while True:
            try:
                self.last_eval = await self.evaluate()
                if self.auto and self.last_eval.get("overloaded"):
                    await self.mgr.admin.mon_command(
                        {"prefix": "osd reweight-by-utilization"})
            except Exception:
                pass
            await asyncio.sleep(self.interval)

    async def evaluate(self) -> dict:
        """Per-osd PG counts + spread (balancer 'eval' command role)."""
        ack = await self.mgr.admin.mon_command({"prefix": "pg dump"})
        dump = json.loads(ack.outs)
        per_osd: Dict[int, int] = {}
        for row in dump.get("pg_stats", {}).values():
            for o in row.get("acting", []):
                if o >= 0:
                    per_osd[o] = per_osd.get(o, 0) + 1
        if not per_osd:
            return {"per_osd": {}, "spread": 0, "overloaded": []}
        avg = sum(per_osd.values()) / len(per_osd)
        over = [o for o, n in per_osd.items() if n > 1.5 * avg]
        return {"per_osd": per_osd,
                "spread": max(per_osd.values()) - min(per_osd.values()),
                "avg": avg, "overloaded": over}


class Mgr:
    """The module host (MgrStandby/Mgr roles collapsed: no HA pair)."""

    def __init__(self, admin, modules: Optional[List[MgrModule]] = None):
        self.admin = admin          # a connected Rados handle
        self.modules: List[MgrModule] = modules if modules is not None \
            else [DashboardModule(self), BalancerModule(self)]
        self._tasks: List[asyncio.Task] = []

    def get_module(self, name: str) -> Optional[MgrModule]:
        return next((m for m in self.modules if m.name == name), None)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        for m in self.modules:
            self._tasks.append(loop.create_task(m.serve()))
        # give servers a beat to bind
        await asyncio.sleep(0)

    async def stop(self) -> None:
        for m in self.modules:
            await m.stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
