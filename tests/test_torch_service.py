"""The port's verifier service, held against the JAX package on the wire.

``VerifierService(CudaBatchVerifier(device="cpu"))`` (the kernel's plain
version on the host) must answer the JAX package's ``RemoteVerifier`` with
the same bitmaps as the JAX package's ``CpuVerifier``, with and without a
shared secret; refuse an over-limit request with a typed failure; and
carry a JAX-package ``VirtualCluster`` whose replicas check certificates
through ``CoalescingVerifier(RemoteVerifier(...))``.
"""

import asyncio
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

from mochi_tpu.client import TransactionBuilder
from mochi_tpu.cluster.config import ServerInfo as JServerInfo
from mochi_tpu.crypto.keys import generate_keypair
from mochi_tpu.net.transport import _Connection as JConnection, new_msg_id
from mochi_tpu.protocol import (
    Envelope,
    FailType,
    RequestFailedFromServer,
    VerifyRequestToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
)
from mochi_tpu.testing import VirtualCluster
from mochi_tpu.verifier.service import RemoteVerifier as JRemoteVerifier
from mochi_tpu.verifier.spi import CoalescingVerifier, CpuVerifier as JCpuVerifier
from mochi_tpu.verifier.spi import VerifyItem as JItem
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
from mochi_tpu_torch.verifier.service import VerifierService, load_secret, load_signers
from mochi_tpu_torch.verifier.spi import BatchingVerifier, VerifyItem


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def make_items(n, forge=()):
    kp = generate_keypair()
    items = []
    for i in range(n):
        msg = b"torch svc %d" % i
        sig = kp.sign(msg)
        if i in forge:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(JItem(kp.public_key, msg, sig))
    # malformed and non-canonical items ride along
    items.append(JItem(b"\x01" * 31, b"t", items[0].signature))
    items.append(JItem(b"\xff" * 32, b"z", items[0].signature))
    return items


@pytest.mark.parametrize("secret", [None, bytes(range(32))], ids=["loopback", "secret"])
def test_port_service_answers_the_reference_client(secret):
    async def main():
        service = VerifierService(port=0, verifier=CudaBatchVerifier(device="cpu"), secret=secret)
        await service.start()
        rv = JRemoteVerifier("127.0.0.1", service.bound_port, secret=secret, timeout_s=60)
        try:
            items = make_items(10, forge={2, 7})
            want = await JCpuVerifier().verify_batch(items)
            got = await rv.verify_batch(items)
            assert got == want
            assert want[:10] == [i not in (2, 7) for i in range(10)] and want[10:] == [False, False]
            assert rv.remote_batches == 1 and rv.fallback_batches == 0
            st = service.status()
            assert st["requests"] == 1 and st["items"] == len(items)
            assert st["authenticated"] is (secret is not None)
            inner = st["verifier"]["inner"]
            assert inner["type"] == "CudaBatchVerifier" and inner["fallback_batches"] == 0
            assert inner["comb"]["registered_signers"] == 0
        finally:
            await rv.close()
            await service.close()

    run(main())


def test_wire_bytes_are_identical_to_the_reference_codec():
    """The port's pure-Python codec writes the bytes the reference's codec
    (native or pure) writes, for verify envelopes, MAC'd and not."""
    from mochi_tpu.crypto import session as jsession
    from mochi_tpu.protocol import codec as jcodec, messages as jm
    from mochi_tpu_torch.crypto import session as tsession
    from mochi_tpu_torch.protocol import codec as tcodec, messages as tm

    items = tuple((i.public_key, i.message, i.signature) for i in make_items(4))
    values = [0, 1, -5, 2**63 - 1, b"", b"\x00\xff" * 40, "kéy", [1, [b"x", None]], True, None]
    for v in values:
        assert tcodec.encode(v) == jcodec.encode(v), v
        assert tcodec.decode(jcodec.encode(v)) == jcodec.decode(jcodec.encode(v))
    secret = bytes(range(32))
    for payload_j, payload_t in [
        (jm.VerifyRequestToServer(items), tm.VerifyRequestToServer(items)),
        (jm.VerifyBitmapFromServer((True, False, True)), tm.VerifyBitmapFromServer((True, False, True))),
        (jm.RequestFailedFromServer(jm.FailType.BAD_REQUEST, "x"),
         tm.RequestFailedFromServer(tm.FailType.BAD_REQUEST, "x")),
    ]:
        ej = jm.Envelope(payload_j, msg_id="m1", sender_id="s", reply_to="r")
        et = tm.Envelope(payload_t, msg_id="m1", sender_id="s", reply_to="r")
        assert tm.encode_envelope(et) == jm.encode_envelope(ej)
        assert tm.encode_envelope(tsession.seal(et, secret)) == jm.encode_envelope(jsession.seal(ej, secret))
        assert tm.decode_envelope(jm.encode_envelope(ej)) == et


def test_unauthenticated_request_and_over_limit_request_get_typed_failures():
    async def main():
        secret = bytes(range(32))
        service = VerifierService(port=0, verifier=CudaBatchVerifier(device="cpu"),
                                  max_items_per_request=4, secret=None)
        await service.start()
        conn = JConnection(JServerInfo("verifier", "127.0.0.1", service.bound_port))
        try:
            items = make_items(3)
            req = Envelope(VerifyRequestToServer(tuple((i.public_key, i.message, i.signature)
                                                       for i in items)),
                           msg_id=new_msg_id(), sender_id="t")
            resp = await conn.send_and_receive(req, 30)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_REQUEST
            assert "limit 4" in resp.payload.detail
        finally:
            await conn.close()
            await service.close()
        # a service with a secret refuses an unMAC'd request, typed
        service = VerifierService(port=0, verifier=CudaBatchVerifier(device="cpu"), secret=secret)
        await service.start()
        conn = JConnection(JServerInfo("verifier", "127.0.0.1", service.bound_port))
        try:
            req = Envelope(VerifyRequestToServer(()), msg_id=new_msg_id(), sender_id="t")
            resp = await conn.send_and_receive(req, 30)
            assert resp.payload.fail_type == FailType.BAD_SIGNATURE
        finally:
            await conn.close()
            await service.close()

    run(main())


def test_backend_failure_falls_back_to_cpu_and_is_counted():
    def broken(items):
        raise RuntimeError("device lost")

    async def main():
        v = BatchingVerifier(backend=broken, max_delay_s=0.0)
        items = [VerifyItem(i.public_key, i.message, i.signature) for i in make_items(3, forge={1})]
        assert await v.verify_batch(items) == [True, False, True, False, False]
        assert v.fallback_batches == 1
        await v.close()

    run(main())


def test_card_verifier_raises_a_kernel_failure_instead_of_verifying_on_the_cpu(monkeypatch):
    # a CudaBatchVerifier on the card, whose kernel launch is refused; the
    # card itself is not touched (nothing is built or uploaded)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(BV.TorchBatchBackend, "warmup", lambda self, batch_sizes=(): None)

    def refused(*args, **kwargs):
        raise RuntimeError("comb kernel launch refused")

    monkeypatch.setattr(BV, "verify_batch", refused)

    async def main():
        v = CudaBatchVerifier(device="cuda", max_delay_s=0.0)
        assert v.fallback is None
        items = [VerifyItem(i.public_key, i.message, i.signature) for i in make_items(3)]
        with pytest.raises(RuntimeError, match="launch refused"):
            await v.verify_batch(items)
        assert v.fallback_batches == 0 and v.items_verified == 0
        await v.close()

    run(main())


def test_cluster_commits_through_the_port_service_and_drops_a_forged_grant():
    from tests.test_byzantine import write1_via_wire

    async def main():
        service = VerifierService(port=0, verifier=CudaBatchVerifier(device="cpu", max_delay_s=0.005))
        await service.start()
        port = service.bound_port
        try:
            async with VirtualCluster(
                4, rf=4,
                verifier_factory=lambda: CoalescingVerifier(JRemoteVerifier("127.0.0.1", port, timeout_s=120)),
            ) as vc:
                client = vc.client()
                await client.execute_write_transaction(TransactionBuilder().write("tk", b"tv").build())
                res = await client.execute_read_transaction(TransactionBuilder().read("tk").build())
                assert res.operations[0].value == b"tv"

                txn = TransactionBuilder().write("tk2", b"honest").build()
                grants = await write1_via_wire(vc, client, txn)
                attacker = generate_keypair()
                victim = sorted(grants)[0]
                forged = replace(grants[victim], signature=None)
                forged = forged.with_signature(attacker.sign(forged.signing_bytes()))
                wc = WriteCertificate({**grants, victim: forged})
                env = client._envelope(Write2ToServer(wc, txn), "w2-torch-forged")
                tid = sorted(vc.config.servers)[1]
                resp = await client.pool.send_and_receive(vc.config.servers[tid], env)
                assert isinstance(resp.payload, Write2AnsFromServer)
                assert resp.payload.result.operations[0].value == b"honest"
                assert vc.replica(tid).metrics.counters.get("replica.dropped-grants", 0) == 1
                for r in vc.replicas:
                    assert r.verifier.inner.fallback_batches == 0
            assert service.requests > 0
            assert service.verifier.inner.fallback_batches == 0
        finally:
            await service.close()

    before = BV.device_dispatch_count()
    run(main(), timeout=300)
    assert BV.device_dispatch_count() > before  # the plain version carried the checks


def test_cuda_verifier_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaBatchVerifier()
    assert CudaBatchVerifier(device="cpu").backend.device.type == "cpu"


def test_cli_backend_choice_and_loaders(tmp_path):
    out = subprocess.run([sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "--backend {cuda,cuda-sharded,cpu}" in out.stdout and "--admin-port" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0"],
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0 and "no CUDA device" in out.stderr
    # --backend cpu serves on the host: READY on stdout, then SIGTERM stops it
    proc = subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0", "--backend", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY verifier-service "), line
        assert int(line.split()[-1]) > 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    (tmp_path / "s").write_text("00" * 8)
    with pytest.raises(SystemExit):
        load_secret(str(tmp_path / "s"))
    (tmp_path / "s").write_text("ab" * 32 + "\n")
    assert load_secret(str(tmp_path / "s")) == b"\xab" * 32
    (tmp_path / "k").write_text("# signers\n" + "11" * 32 + "  # one\n\n" + "22" * 32 + "\n")
    assert load_signers(str(tmp_path / "k")) == [b"\x11" * 32, b"\x22" * 32]


# ------------------------------------------------------------------- warmup


def _record_dispatches(monkeypatch):
    """Every launch-path dispatch as (lanes, comb?)."""
    seen = []
    real = BV._dispatch

    def dispatch(prepared, device, k=0, comb=None):
        seen.append((len(prepared[6]), comb is not None))
        return real(prepared, device, k, comb)

    monkeypatch.setattr(BV, "_dispatch", dispatch)
    return seen


def _every_lane_verifies(monkeypatch):
    """Stand-ins for the two wrappers' plain arithmetic, which the warmup
    tests do not count: every lane verifies."""
    from mochi_tpu_torch.crypto import cuda_comb, cuda_verify

    monkeypatch.setattr(cuda_verify, "verify_prepared_packed", lambda *t: torch.ones(len(t[1]), dtype=torch.bool))
    monkeypatch.setattr(cuda_comb, "verify_comb_prepared",
                        lambda table, *t, **kw: torch.ones(len(t[0]), dtype=torch.bool))


def test_warmup_launches_each_path_once_at_each_size(monkeypatch):
    """TorchBatchBackend.warmup((16, 256)) launches the general path once
    at each size on items its prechecks accept, and with signers
    registered the comb path too, through the live launch path."""
    seen = _record_dispatches(monkeypatch)
    _every_lane_verifies(monkeypatch)
    backend = BV.TorchBatchBackend(device="cpu")
    backend.warmup((16, 256))
    assert seen == [(16, False), (256, False)]
    seen.clear()
    backend.register_signers([generate_keypair().public_key for _ in range(3)])
    backend.warmup((16, 256))
    assert seen == [(16, False), (16, True), (256, False), (256, True)]
    seen.clear()
    backend.warmup()
    assert seen == []


def test_verifier_warmup_buckets_reach_the_backend_and_its_stats(monkeypatch):
    """CudaBatchVerifier(warmup_buckets=) warms its backend at those sizes
    before it serves, and its stats name the sizes and the seconds; the
    sharded verifier warms every slice's device."""
    from mochi_tpu_torch.verifier.cuda import ShardedCudaBatchVerifier
    from mochi_tpu_torch.verifier.spi import verifier_stats

    seen = _record_dispatches(monkeypatch)
    pubs = [generate_keypair().public_key for _ in range(2)]

    async def main():
        v = CudaBatchVerifier(device="cpu", signers=pubs, warmup_buckets=(16,))
        assert seen == [(16, False), (16, True)]
        st = verifier_stats(v)
        assert st["warmup"]["buckets"] == [16] and st["warmup"]["seconds"] > 0
        await v.close()
        seen.clear()
        sv = ShardedCudaBatchVerifier(devices=["cpu", "cpu"], signers=pubs, warmup_buckets=(16,))
        assert seen == [(16, False), (16, True)]  # the one device of the mesh, once
        await sv.close()

    run(main())


def test_a_warmup_failure_fails_the_verifier(monkeypatch):
    """No fallback hides a warmup: a launch error raises out of the
    verifier's construction, and so does a warm launch that rejects the
    valid items."""
    import numpy as np

    def refused(*args, **kwargs):
        raise RuntimeError("launch refused at warmup")

    monkeypatch.setattr(BV, "_dispatch", refused)
    with pytest.raises(RuntimeError, match="launch refused at warmup"):
        CudaBatchVerifier(device="cpu", warmup_buckets=(16,))
    monkeypatch.undo()
    monkeypatch.setattr(BV, "_readback", lambda launched: np.zeros(len(launched[3]), dtype=bool))
    with pytest.raises(RuntimeError, match="rejected valid items"):
        CudaBatchVerifier(device="cpu", warmup_buckets=(16,))


def test_server_warms_16_lanes_before_ready(monkeypatch):
    """The replica entry point's card verifier is built (before any
    replica prints READY) with warmup_buckets=(16,) and the cluster's
    identities as its signers."""
    import argparse

    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.server import __main__ as server_main
    from mochi_tpu_torch.verifier import cuda as cuda_mod

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_mod, "CudaBatchVerifier", lambda **kw: built.append(kw) or object())
    kps = [generate_keypair() for _ in range(4)]
    cfg = ClusterConfig.build({f"server-{i}": f"127.0.0.1:{9500 + i}" for i in range(4)}, rf=4,
                              public_keys={f"server-{i}": kp.public_key for i, kp in enumerate(kps)})
    shared: dict = {}
    v = server_main._build_verifier(argparse.Namespace(verifier="cuda"), cfg, shared)
    assert server_main._build_verifier(argparse.Namespace(verifier="cuda"), cfg, shared) is v  # one per process
    assert len(built) == 1 and built[0]["warmup_buckets"] == (16,) and built[0]["device"] == "cuda"
    assert sorted(built[0]["signers"]) == sorted(kp.public_key for kp in kps)


def test_service_accepts_warmup_and_passes_it_to_the_card_verifier(monkeypatch, capsys):
    """The service's --warmup (default 16,256) reaches the card verifier it
    builds before READY; here the verifier runs the plain versions."""
    from mochi_tpu_torch.verifier import cuda as cuda_mod
    from mochi_tpu_torch.verifier import service as service_mod

    built = []
    real = cuda_mod.CudaBatchVerifier

    def recording(**kw):
        built.append(kw)
        return real(**dict(kw, device="cpu"))

    monkeypatch.setattr(cuda_mod, "CudaBatchVerifier", recording)
    _every_lane_verifies(monkeypatch)
    assert service_mod.build_parser().parse_args([]).warmup == "16,256"

    async def boot(argv):
        task = asyncio.ensure_future(service_mod.amain(service_mod.build_parser().parse_args(argv)))
        for _ in range(600):
            await asyncio.sleep(0.05)
            if "READY" in capsys.readouterr().out:
                break
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    run(boot(["--port", "0"]))
    run(boot(["--port", "0", "--warmup", "16,32,"]))
    assert [kw["warmup_buckets"] for kw in built] == [(16, 256), (16, 32)]
