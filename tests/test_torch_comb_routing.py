"""Comb-first routing on the port: the known-signer engine as the DEFAULT
verify path (the backend's "device" here is the kernels' plain versions on
the CPU).

The comb kernel itself is covered differentially by ``tests/test_torch_comb.py``;
these tests pin the promotion of that kernel to the default engine:

* ``register_signers`` plumbing — the one call a replica makes at boot and
  on reconfig must reach the device registry / host fallback through any
  SPI composition (Caching/Coalescing/Batching wrappers);
* the replica actually makes that call, at boot and on reconfiguration;
* mixed batches through the ROUTED SPI path (registry hits on the comb
  program, misses on the ladder, one merged bitmap) stay bit-for-bit equal
  to the host verifier — including forged signatures and unknown signers,
  which must fail alone without dragging batchmates down;
* the router's occupancy counters actually count.
"""

from __future__ import annotations

import asyncio

import pytest

from mochi_tpu_torch.crypto import batch_verify, keys
from mochi_tpu_torch.crypto.batch_verify import TorchBatchBackend
from mochi_tpu_torch.verifier.spi import (
    BatchingVerifier,
    CachingVerifier,
    CoalescingVerifier,
    CpuVerifier,
    SignatureVerifier,
    VerifyItem,
    verifier_stats,
)


@pytest.fixture(scope="module")
def signers():
    return [keys.keypair_from_seed(bytes([i + 11] * 32)) for i in range(4)]


# ------------------------------------------------------------- registration


def test_register_signers_walks_spi_composition(signers):
    backend = TorchBatchBackend(device="cpu")
    v = CachingVerifier(CoalescingVerifier(BatchingVerifier(backend)))
    assert v.register_signers([kp.public_key for kp in signers]) is True
    assert backend.registry is not None
    assert len(backend.registry) == len(signers)
    # idempotent: a reconfig re-registering the full set must not grow it
    assert v.register_signers([kp.public_key for kp in signers]) is True
    assert len(backend.registry) == len(signers)
    st = verifier_stats(CachingVerifier(BatchingVerifier(backend)))
    assert st["inner"]["comb"]["registered_signers"] == len(signers)


def test_cpu_verifier_registration_primes_host_fallback(signers):
    from mochi_tpu_torch.crypto import keys as keys_mod

    routed = CpuVerifier().register_signers([kp.public_key for kp in signers])
    if keys_mod.host_crypto_engine() != "pure-python":
        # OpenSSL AND the native-C engine keep no per-signer
        # state — registration reports unrouted so callers don't credit a
        # warmup that doesn't exist.
        assert routed is False
    else:
        from mochi_tpu_torch.crypto import hostfallback

        assert routed is True
        for kp in signers:
            assert (
                hostfallback._seen_signers.get(kp.public_key, 0)
                >= hostfallback._TABLE_PROMOTE_AFTER
            )


class _RecordingVerifier(SignatureVerifier):
    def __init__(self):
        self.registered: list = []

    def register_signers(self, pubs):
        self.registered.append(list(pubs))
        return True

    async def verify_batch(self, items):
        return [
            keys.verify(it.public_key, it.message, it.signature) for it in items
        ]


def test_replica_registers_config_signers_at_boot_and_reconfig(signers):
    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.server.replica import MochiReplica

    async def drive():
        sids = [f"server-{i}" for i in range(4)]
        cfg = ClusterConfig.build(
            {sid: "127.0.0.1:1" for sid in sids},
            rf=4,
            public_keys={sid: kp.public_key for sid, kp in zip(sids, signers)},
        )
        verifier = _RecordingVerifier()
        replica = MochiReplica(
            "server-0", cfg, signers[0], verifier=verifier, port=0
        )
        await replica.start()
        try:
            assert verifier.registered, "boot did not register config signers"
            assert set(verifier.registered[0]) == {
                kp.public_key for kp in signers
            }
            # live reconfiguration re-registers the FULL new membership
            extra = keys.keypair_from_seed(bytes([99] * 32))
            new_cfg = cfg.evolve(
                {**{sid: "127.0.0.1:1" for sid in sids}, "server-4": "127.0.0.1:1"},
                public_keys={"server-4": extra.public_key},
            )
            replica._install_config(new_cfg.to_json().encode())
            assert set(verifier.registered[-1]) == {
                kp.public_key for kp in signers
            } | {extra.public_key}
        finally:
            await replica.close()

    asyncio.run(drive())


# ------------------------------------------------------- routed mixed batch


def test_routed_mixed_batch_differential_vs_host(signers):
    """Forged-signature and unknown-signer items through the ROUTED
    BatchingVerifier path: registry hits ride the comb program, misses the
    ladder, one merged bitmap — bit-for-bit the host verifier's verdicts
    (OpenSSL when installed, else the pure-Python fallback)."""
    backend = TorchBatchBackend(device="cpu", min_device_items=0)
    v = BatchingVerifier(backend, max_delay_s=0.0)
    assert v.register_signers([kp.public_key for kp in signers])
    backend.warmup([16])  # launches the general AND the comb path at 16 lanes

    unknown = keys.keypair_from_seed(bytes([77] * 32))
    items = []
    for i, kp in enumerate(signers):
        msg = b"routed %d" % i
        items.append(VerifyItem(kp.public_key, msg, kp.sign(msg)))
    # registered signer, forged signature (fails alone on the comb leg)
    items.append(
        VerifyItem(signers[0].public_key, b"forged", signers[0].sign(b"other"))
    )
    # unknown signer, valid signature (rides the ladder leg, passes)
    items.append(VerifyItem(unknown.public_key, b"u", unknown.sign(b"u")))
    # unknown signer, forged signature (ladder leg, fails alone)
    items.append(VerifyItem(unknown.public_key, b"u2", unknown.sign(b"xx")))
    # malformed: rejected at host precheck on either leg
    items.append(VerifyItem(b"\x00" * 31, b"m", b"\x00" * 64))
    # registered signer, signature by a DIFFERENT registered key
    items.append(
        VerifyItem(signers[1].public_key, b"swap", signers[2].sign(b"swap"))
    )

    before = batch_verify.comb_routing_counts()
    bitmap = asyncio.run(v.verify_batch(items))
    asyncio.run(v.close())
    expected = [
        keys.verify(it.public_key, it.message, it.signature) for it in items
    ]
    assert bitmap == expected, (bitmap, expected)
    # sanity on the workload itself: real passes AND real failures occurred
    assert any(bitmap) and not all(bitmap)

    after = batch_verify.comb_routing_counts()
    # registered items (4 valid + forged + wrong-key = 6) routed comb;
    # 2 unknown + 1 malformed routed ladder; one mixed merged round trip
    assert after["comb_items"] - before["comb_items"] == 6
    assert after["ladder_items"] - before["ladder_items"] == 3
    assert after["mixed_batches"] - before["mixed_batches"] == 1


def test_routed_all_known_batch_uses_comb_only(signers):
    backend = TorchBatchBackend(device="cpu", min_device_items=0)
    backend.register_signers([kp.public_key for kp in signers])
    backend.warmup([16])
    items = [
        VerifyItem(kp.public_key, b"all-known", kp.sign(b"all-known"))
        for kp in signers
    ]
    before = batch_verify.comb_routing_counts()
    bitmap = backend(items)
    after = batch_verify.comb_routing_counts()
    assert list(bitmap) == [True] * len(signers)
    assert after["comb_items"] - before["comb_items"] == len(signers)
    assert after["ladder_items"] == before["ladder_items"]
    assert after["mixed_batches"] == before["mixed_batches"]


def test_registry_and_routing_equal_the_reference(signers):
    """The same registrations (repeats, a refused x = 0 key with the sign
    bit, a non-point) in the reference's SignerRegistry and the port's give
    the same indices, refusals and generation, and the port's routed
    verdicts equal the reference's host verify on a seeded mixed batch."""
    import numpy as np

    from mochi_tpu.crypto import comb as ref_comb
    from mochi_tpu.crypto import keys as ref_keys
    from mochi_tpu_torch.crypto import comb

    x0_sign = (1).to_bytes(32, "little")[:31] + bytes([0x80])  # y = 1 with the sign bit: x = 0, refused
    non_point = (2).to_bytes(32, "little")
    pubs = [kp.public_key for kp in signers]
    seq = [pubs[0], pubs[1], pubs[0], x0_sign, pubs[2], non_point, pubs[3], pubs[1]]
    ref, mine = ref_comb.SignerRegistry(), comb.SignerRegistry("cpu")
    assert [ref.register(p) for p in seq] == [mine.register(p) for p in seq]
    assert [ref.index_of(p) for p in seq] == [mine.index_of(p) for p in seq]
    assert ref.generation == mine.generation == len(mine) == 4

    rng = np.random.default_rng(5)
    unknown = keys.keypair_from_seed(bytes([78] * 32))
    items = []
    for i in range(24):
        kp = signers[i % 4] if i % 3 else unknown
        msg = b"routed %d " % i + rng.bytes(8)
        sig = kp.sign(msg if i % 7 else b"something else")
        items.append(VerifyItem(kp.public_key, msg, sig))
    backend = TorchBatchBackend(device="cpu", min_device_items=0)
    backend.register_signers(pubs)
    want = [ref_keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert list(backend(items)) == want and any(want) and not all(want)
