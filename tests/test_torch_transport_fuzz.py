"""Hostile-bytes fuzzing of a LIVE replica's listening socket.

The reference never tests its wire surface against garbage (SURVEY.md §4
gap list); here a real replica (virtual cluster, real loopback TCP) is
fed adversarial frames — oversized length prefixes, truncated frames,
random bytes, valid frames wrapping undecodable payloads, and a valid
envelope with a corrupted MAC — and must (a) never crash, (b) keep
serving well-formed traffic afterwards.
"""

from __future__ import annotations

import asyncio
import os
import struct

import numpy as np

from mochi_tpu_torch.protocol import (
    HelloFromServer,
    HelloToServer,
    RequestFailedFromServer,
    encode_envelope,
)
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def run(coro):
    asyncio.run(coro)


async def _open(info):
    return await asyncio.open_connection("127.0.0.1", info.port)


async def _hostile(info, payload: bytes) -> None:
    """Send raw bytes on a fresh connection; server may close on us."""
    try:
        reader, writer = await _open(info)
        writer.write(payload)
        try:
            await asyncio.wait_for(writer.drain(), timeout=2)
        except Exception:
            pass
        writer.close()
    except (ConnectionResetError, BrokenPipeError, OSError):
        pass  # server dropping a hostile peer is correct behavior


async def _alive(vc, info) -> None:
    """The replica must still answer a clean hello round trip."""
    client = vc.client()
    env = client._envelope(HelloToServer("still-there?"), os.urandom(8).hex())
    resp = await asyncio.wait_for(client.pool.send_and_receive(info, env), 10)
    assert isinstance(resp.payload, (HelloFromServer, RequestFailedFromServer))
    await client.close()


def test_replica_survives_hostile_frames():
    rng = np.random.default_rng(0xBAD)

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            info = vc.config.servers["server-0"]

            # 1. oversized length prefix (attempted allocation attack)
            await _hostile(info, struct.pack(">I", 0xFFFFFFFF) + b"x" * 64)
            # 2. truncated frame: promises 1000 bytes, sends 3, hangs up
            await _hostile(info, struct.pack(">I", 1000) + b"abc")
            # 3. pure garbage, various sizes
            for size in (1, 3, 4, 17, 256, 4096):
                await _hostile(info, rng.bytes(size))
            # 4. well-framed undecodable payloads
            for size in (0, 1, 64, 1024):
                blob = rng.bytes(size)
                await _hostile(info, struct.pack(">I", len(blob)) + blob)
            # 5. valid envelope bytes with flipped tail (corrupt signature/MAC
            #    region) inside a correct frame
            client = vc.client()
            env = client._envelope(HelloToServer("x"), os.urandom(8).hex())
            data = bytearray(encode_envelope(env))
            data[-1] ^= 0xFF
            await _hostile(info, struct.pack(">I", len(data)) + bytes(data))
            await client.close()

            await _alive(vc, info)

            # 6. sustained random-frame storm, then service check again
            for _ in range(50):
                blob = rng.bytes(int(rng.integers(0, 128)))
                await _hostile(info, struct.pack(">I", len(blob)) + blob)
            await _alive(vc, info)

    run(main())


def test_hostile_frames_decode_as_the_reference_decodes_them():
    """Seeded garbage, truncations and bit flips of valid envelopes: the
    port's envelope decoder accepts exactly what the reference's accepts,
    and decodes it to an envelope that re-encodes to the same bytes."""
    from mochi_tpu.protocol import decode_envelope as ref_decode
    from mochi_tpu.protocol import encode_envelope as ref_encode
    from mochi_tpu_torch.protocol import Envelope, decode_envelope

    rng = np.random.default_rng(94)
    valid = encode_envelope(Envelope(HelloToServer("fuzz"), "m-1", "client-1"))
    frames = [rng.bytes(int(rng.integers(0, 64))) for _ in range(150)]
    frames += [valid[: int(rng.integers(0, len(valid)))] for _ in range(50)]
    for _ in range(150):
        b = bytearray(valid)
        b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        frames.append(bytes(b))
    frames.append(valid)
    accepted = 0
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
        accepted += mine is not None
    assert accepted >= 1
