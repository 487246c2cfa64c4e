"""Unix-domain-socket transport: full cluster protocol over AF_UNIX.

A deployment option for single-host clusters (``gen_cluster --uds``,
``VirtualCluster(uds_dir=...)``, ``MOCHI_UDS=1``): same framed protocol,
no TCP/IP stack.  Measured on the 1-core CI host (config1 A/B, r4): no
throughput win over loopback TCP in either posture — the binding cost
there is scheduling/protocol work, not the network stack — so TCP stays
the default; the feature exists for multi-core single-host deployments
where the loopback send path is the demonstrated hot spot (BASELINE.md).
"""

from __future__ import annotations

import asyncio
import tempfile

import pytest

from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.cluster.config import ServerInfo
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def test_server_info_unix_url_roundtrip():
    info = ServerInfo.from_url("server-0", "unix:/tmp/mochi-x/server-0.sock:0")
    assert info.is_unix and info.unix_path == "/tmp/mochi-x/server-0.sock"
    assert info.port == 0
    tcp = ServerInfo.from_url("server-1", "10.0.0.7:8101")
    assert not tcp.is_unix and tcp.host == "10.0.0.7" and tcp.port == 8101


def test_uds_double_bind_refused_stale_socket_reclaimed():
    """A second server must NOT steal a live server's socket (the TCP
    analog fails with EADDRINUSE); a stale socket from a dead process IS
    reclaimed at bind."""
    from mochi_tpu_torch.net.transport import RpcServer

    async def body():
        with tempfile.TemporaryDirectory(prefix="mochi-uds-") as d:
            path = f"{d}/s.sock"

            async def handler(env):
                return None

            live = RpcServer(f"unix:{path}", 0, handler)
            await live.start()
            try:
                thief = RpcServer(f"unix:{path}", 0, handler)
                try:
                    await thief.start()
                    raise AssertionError("second bind on a live socket succeeded")
                except OSError:
                    pass
            finally:
                await live.close()
            import os

            assert not os.path.exists(path)  # close unlinked our socket
            # stale socket (no listener): simulate a dead process's leftover
            import socket as s

            sock = s.socket(s.AF_UNIX)
            sock.bind(path)
            sock.close()  # bound but never listening -> connect refused
            fresh = RpcServer(f"unix:{path}", 0, handler)
            await fresh.start()  # reclaims the stale path
            await fresh.close()

    asyncio.run(asyncio.wait_for(body(), timeout=30))


def test_cluster_over_uds():
    async def body():
        with tempfile.TemporaryDirectory(prefix="mochi-uds-") as d:
            async with VirtualCluster(5, rf=4, uds_dir=d) as vc:
                assert all(s.is_unix for s in vc.config.servers.values())
                c = vc.client()
                await c.execute_write_transaction(
                    TransactionBuilder().write("uk", "uv").build()
                )
                r = await c.execute_read_transaction(
                    TransactionBuilder().read("uk").build()
                )
                assert r.operations[0].value == b"uv"
                cert = r.operations[0].current_certificate
                assert cert is not None and len(cert.grants) >= vc.config.quorum

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_server_info_urls_equal_the_reference():
    """Host:port and unix: addresses parse and print the same in both
    packages."""
    from mochi_tpu.cluster.config import ServerInfo as RefInfo

    for url in ("127.0.0.1:8101", "localhost:1", "unix:/tmp/mochi/a.sock:0", "unix:relative.sock:0"):
        mine, theirs = ServerInfo.from_url("s", url), RefInfo.from_url("s", url)
        assert (mine.host, mine.port, mine.is_unix, mine.url) == (theirs.host, theirs.port, theirs.is_unix, theirs.url)
        if mine.is_unix:
            assert mine.unix_path == theirs.unix_path, url
    for bad in ("no-port", "host:notaport", ":8101"):
        for cls in (ServerInfo, RefInfo):
            with pytest.raises(ValueError):
                cls.from_url("s", bad)
