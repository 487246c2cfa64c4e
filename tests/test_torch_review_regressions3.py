"""Regressions for a review's findings.

1. ``fan_out`` runs its slow path (unconnected targets) concurrently with
   the fast-path wait — one down replica must not stretch a fan-out to
   ~2x the timeout budget.
2. An explicit ``timeout_s=0`` means "no waiting", not "use the default".
3. ``decode_envelope`` rejects a non-canonical multi-byte varint header
   (would silently shift the signed-prefix slice and surface as a
   confusing BAD_SIGNATURE instead of a decode error).
"""

from __future__ import annotations

import asyncio
import time

import pytest

from mochi_tpu_torch.cluster.config import ServerInfo
from mochi_tpu_torch.net.transport import RpcClientPool, fan_out
from mochi_tpu_torch.protocol import Envelope, HelloToServer, decode_envelope, encode_envelope


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


async def _black_hole_server():
    """Accepts connections and reads frames but never responds."""

    async def handle(reader, writer):
        try:
            while await reader.read(65536):
                pass
        except Exception:
            pass

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    return server, port


def _env(msg_id: str) -> Envelope:
    return Envelope(HelloToServer("probe"), msg_id, "test-client")


def test_fan_out_slow_path_shares_the_timeout_budget():
    """One never-connected target + one connected-but-silent target: the
    fan-out must finish in ~1x the timeout, not slow-then-fast serial 2x."""

    async def main():
        server, port = await _black_hole_server()
        fast_info = ServerInfo("fast", "127.0.0.1", port)
        # Dead port: connect fails fast, but ensure_connected retries
        # 3x100ms inside the slow path — still well under one timeout.
        server2, port2 = await _black_hole_server()
        slow_info = ServerInfo("slow", "127.0.0.1", port2)

        pool = RpcClientPool(default_timeout_s=1.0)
        # Pre-connect the fast target so it takes the fast path.
        await pool._conn(fast_info).ensure_connected()
        assert pool._conn(fast_info).connected
        assert not pool._conn(slow_info).connected

        t0 = time.perf_counter()
        out = await fan_out(
            pool,
            [("fast", fast_info), ("slow", slow_info)],
            lambda msg_id, sid: _env(msg_id),
            timeout_s=1.0,
        )
        elapsed = time.perf_counter() - t0
        assert isinstance(out["fast"], Exception)
        assert isinstance(out["slow"], Exception)
        # Serial slow-then-fast would be ~2.0s; concurrent is ~1.0s.
        assert elapsed < 1.7, f"fan_out took {elapsed:.2f}s — slow path serialized"
        await pool.close()
        server.close()
        server2.close()

    run(main())


def test_fan_out_explicit_zero_timeout_is_not_the_default():
    async def main():
        server, port = await _black_hole_server()
        info = ServerInfo("s", "127.0.0.1", port)
        pool = RpcClientPool(default_timeout_s=30.0)
        await pool._conn(info).ensure_connected()
        t0 = time.perf_counter()
        out = await fan_out(
            pool, [("s", info)], lambda msg_id, sid: _env(msg_id), timeout_s=0
        )
        elapsed = time.perf_counter() - t0
        assert isinstance(out["s"], Exception)
        assert elapsed < 5.0, "timeout_s=0 fell back to the 30s default"
        await pool.close()
        server.close()

    run(main())


def test_decode_envelope_rejects_noncanonical_header():
    env = Envelope(HelloToServer("hi"), "m1", "s1")
    wire = encode_envelope(env)
    assert wire[:2] == b"\x07\x08"
    assert decode_envelope(wire).msg_id == "m1"
    # Same frame with varint(8) spelled as the two-byte form 88 00: must be
    # a loud decode error, not a shifted signed-prefix slice.
    bad = wire[:1] + b"\x88\x00" + wire[2:]
    with pytest.raises(ValueError):
        decode_envelope(bad)


def test_coalescing_verifier_merges_concurrent_calls():
    """Concurrent verify_batch calls must share inner round trips (one RPC
    per round trip, not per certificate) with per-caller correct bitmaps."""
    from mochi_tpu_torch.verifier.spi import CoalescingVerifier, SignatureVerifier, VerifyItem

    class SlowInner(SignatureVerifier):
        def __init__(self):
            self.calls = 0

        async def verify_batch(self, items):
            self.calls += 1
            await asyncio.sleep(0.02)  # the "round trip"
            return [it.message.startswith(b"ok") for it in items]

    async def main():
        inner = SlowInner()
        cv = CoalescingVerifier(inner)

        async def one(i):
            items = [
                VerifyItem(b"k" * 32, b"ok %d" % i, b"s" * 64),
                VerifyItem(b"k" * 32, b"bad %d" % i, b"s" * 64),
            ]
            return await cv.verify_batch(items)

        results = await asyncio.gather(*(one(i) for i in range(10)))
        assert all(r == [True, False] for r in results)
        # call 0 flushes alone; calls 1..9 arrive during its round trip and
        # must ride ONE combined flush => 2 inner calls, not 10.
        assert inner.calls <= 3, f"no coalescing: {inner.calls} inner calls"
        await cv.close()

    run(main())


def test_coalescing_verifier_propagates_inner_failure():
    from mochi_tpu_torch.verifier.spi import CoalescingVerifier, SignatureVerifier, VerifyItem

    class BoomInner(SignatureVerifier):
        async def verify_batch(self, items):
            raise RuntimeError("boom")

    async def main():
        cv = CoalescingVerifier(BoomInner())
        items = [VerifyItem(b"k" * 32, b"m", b"s" * 64)]
        try:
            await cv.verify_batch(items)
        except RuntimeError as exc:
            assert "boom" in str(exc)
        else:
            raise AssertionError("inner failure swallowed")

    run(main())


def test_fan_out_cancellation_cancels_slow_path():
    """Cancelling a fan-out mid-wait must cancel the detached slow-path
    task too — no background dials/sends after the caller gave up."""

    async def main():
        server, port = await _black_hole_server()
        fast_info = ServerInfo("fast", "127.0.0.1", port)
        server2, port2 = await _black_hole_server()
        slow_info = ServerInfo("slow", "127.0.0.1", port2)

        pool = RpcClientPool(default_timeout_s=5.0)
        await pool._conn(fast_info).ensure_connected()

        task = asyncio.ensure_future(
            fan_out(
                pool,
                [("fast", fast_info), ("slow", slow_info)],
                lambda msg_id, sid: _env(msg_id),
                timeout_s=5.0,
            )
        )
        await asyncio.sleep(0.1)  # fan-out is parked in the fast-path wait
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        await asyncio.sleep(0.1)
        # the slow-path connection must not be left pending a request
        slow_conn = pool._conn(slow_info)
        assert not slow_conn.pending, "slow-path request survived cancellation"
        await pool.close()
        server.close()
        server2.close()

    run(main())


def test_header_mutations_decode_as_the_reference():
    """Every one-byte change to the header of a valid envelope (the
    two-byte varint spelling among them) is accepted or refused by the
    port's decoder exactly as by the reference's, and an accepted one
    decodes to the same envelope."""
    from mochi_tpu.protocol import decode_envelope as ref_decode
    from mochi_tpu.protocol import encode_envelope as ref_encode

    data = encode_envelope(Envelope(HelloToServer("hi"), "m1", "s1"))
    frames = [data[:1] + b"\x88\x00" + data[2:]]
    for pos in range(min(len(data), 12)):
        for val in (0x00, 0x01, 0x7F, 0x80, 0xFF, data[pos] ^ 0x01):
            frames.append(data[:pos] + bytes([val]) + data[pos + 1:])
    for frame in frames:
        try:
            mine = encode_envelope(decode_envelope(frame))
        except Exception:
            mine = None
        try:
            theirs = ref_encode(ref_decode(frame))
        except Exception:
            theirs = None
        assert mine == theirs, frame
