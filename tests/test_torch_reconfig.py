"""Configstamp-gated live reconfiguration in the port (paper
mochiDB.tex:184-199), against the port's ``VirtualCluster`` with its CPU
verifier.

The membership document lives at CONFIG_CLUSTER_KEY, commits through the
standard 2-phase write (every server owns the _CONFIG_ keyspace), and each
replica's apply hook installs it live.  Clients refresh on demand or
automatically when a cross-config write fails.  The last tests hold the
port's ``ClusterConfig.build(...).evolve(...)`` to the JAX package's.
"""

import asyncio
import random

import pytest

from mochi_tpu_torch.client import MochiDBClient, TransactionBuilder
from mochi_tpu_torch.cluster.config import CONFIG_CLUSTER_KEY, ClusterConfig
from mochi_tpu_torch.crypto.keys import generate_keypair
from mochi_tpu_torch.server.replica import MochiReplica
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


def current_servers(vc):
    return {r.server_id: f"{vc.host}:{r.bound_port}" for r in vc.replicas}


def test_commit_config_installs_on_all_replicas():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("pre", b"v").build()
            )
            new_cfg = vc.config.evolve(current_servers(vc))  # same members, cs+1
            await client.reconfigure_cluster(new_cfg)
            for r in vc.replicas:
                assert r.config.configstamp == new_cfg.configstamp, r.server_id
            # traffic continues under the new configstamp
            await client.execute_write_transaction(
                TransactionBuilder().write("post", b"w").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("pre").read("post").build()
            )
            assert [r.value for r in res.operations] == [b"v", b"w"]

    run(main())


def test_stale_client_auto_refreshes_after_reconfig():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            admin = vc.client()
            stale = vc.client()
            await stale.execute_write_transaction(
                TransactionBuilder().write("k0", b"v0").build()
            )
            await admin.reconfigure_cluster(vc.config.evolve(current_servers(vc)))
            # The stale client still holds cs=1; its Write1 grants will carry
            # the NEW configstamp (replicas already switched), its own config
            # check passes... the cross-config path it must survive is a
            # full write + the refresh_config fallback.
            await stale.execute_write_transaction(
                TransactionBuilder().write("k1", b"v1").build()
            )
            res = await stale.execute_read_transaction(
                TransactionBuilder().read("k1").build()
            )
            assert res.operations[0].value == b"v1"
            assert await stale.refresh_config() or stale.config.configstamp >= 2

    run(main())


def test_add_server_live():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            for i in range(12):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"pre-{i}", b"v%d" % i).build()
                )

            # boot the 5th server with the NEW (cs=2) config
            kp5 = generate_keypair()
            servers = current_servers(vc)
            # reserve a port by starting the replica on port 0 with a
            # placeholder config, then evolving with its bound port
            new_replica = MochiReplica(
                server_id="server-4",
                config=vc.config,  # placeholder until install
                keypair=kp5,
                client_public_keys=vc.client_keys,
                host=vc.host,
                port=0,
            )
            await new_replica.start()
            servers["server-4"] = f"{vc.host}:{new_replica.bound_port}"
            new_cfg = vc.config.evolve(
                servers, public_keys={"server-4": kp5.public_key}
            )
            new_replica.config = new_cfg
            new_replica.store.config = new_cfg
            vc.replicas.append(new_replica)
            vc.keypairs["server-4"] = kp5

            await client.reconfigure_cluster(new_cfg)
            for r in vc.replicas[:4]:
                assert r.config.configstamp == new_cfg.configstamp

            # new member pulls its keys from peers
            await new_replica.resync()
            owned = [f"pre-{i}" for i in range(12) if new_replica.store.owns(f"pre-{i}")]
            assert owned, "5-server ring should give server-4 some pre keys"
            for key in owned:
                sv = new_replica.store._get(key)
                assert sv is not None and sv.exists, key

            # writes keyed to sets including the new server work
            for i in range(12):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"post-{i}", b"w%d" % i).build()
                )
                res = await client.execute_read_transaction(
                    TransactionBuilder().read(f"post-{i}").build()
                )
                assert res.operations[0].value == b"w%d" % i

    run(main())


def test_reconfig_registers_new_identity_with_verifier():
    """Adding a server live also registers its identity with a
    comb-capable verifier (crypto/comb.py) — new-member certificates take
    the fast path instead of silently staying on the general ladder."""

    class RecordingVerifier:
        def __init__(self):
            self.registered = []

        async def verify_batch(self, items):
            from mochi_tpu_torch.crypto import keys as _k

            return [
                _k.verify(it.public_key, it.message, it.signature)
                for it in items
            ]

        def register_signers(self, pubs):
            self.registered.extend(bytes(p) for p in pubs)

        async def close(self):
            pass

    verifiers = []

    def factory():
        v = RecordingVerifier()
        verifiers.append(v)
        return v

    async def main():
        async with VirtualCluster(4, rf=4, verifier_factory=factory) as vc:
            client = vc.client()
            kp5 = generate_keypair()
            servers = current_servers(vc)
            new_replica = MochiReplica(
                server_id="server-4",
                config=vc.config,
                keypair=kp5,
                client_public_keys=vc.client_keys,
                host=vc.host,
                port=0,
            )
            await new_replica.start()
            servers["server-4"] = f"{vc.host}:{new_replica.bound_port}"
            new_cfg = vc.config.evolve(
                servers, public_keys={"server-4": kp5.public_key}
            )
            new_replica.config = new_cfg
            new_replica.store.config = new_cfg
            vc.replicas.append(new_replica)
            vc.keypairs["server-4"] = kp5
            await client.reconfigure_cluster(new_cfg)
            for v in verifiers:
                assert kp5.public_key in v.registered

    run(main())


def test_remove_server_live():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("rk", b"v").build()
            )
            servers = current_servers(vc)
            del servers["server-4"]
            new_cfg = vc.config.evolve(servers)
            await client.reconfigure_cluster(new_cfg)

            retired = vc.replica("server-4")
            assert retired.config.configstamp == new_cfg.configstamp
            assert "server-4" not in retired.config.servers

            # cluster keeps serving with 4 members; retired server answers
            # WRONG_SHARD (owns nothing)
            await client.execute_write_transaction(
                TransactionBuilder().write("rk2", b"v2").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("rk").read("rk2").build()
            )
            assert [r.value for r in res.operations] == [b"v", b"v2"]
            assert not retired.store.owns("rk2")

    run(main())


def test_configstamp_gating_rejects_mixed_certificates():
    from mochi_tpu_torch.cluster.config import ClusterConfig as CC
    from mochi_tpu_torch.protocol import (
        Grant, MultiGrant, Status, Transaction, Operation, Action,
        Write2ToServer, WriteCertificate, RequestFailedFromServer,
        transaction_hash,
    )
    from mochi_tpu_torch.server.store import DataStore

    cfg = CC.build({f"server-{i}": f"127.0.0.1:{9200+i}" for i in range(4)}, rf=4)
    ds = DataStore("server-0", cfg)
    txn = Transaction((Operation(Action.WRITE, "k", b"v"),))
    h = transaction_hash(txn)

    def mg(sid, cs):
        return MultiGrant({"k": Grant("k", 500, cs, h, Status.OK)}, "c", sid)

    # mixed configstamps -> rejected
    wc = WriteCertificate({"server-0": mg("server-0", 1), "server-1": mg("server-1", 2),
                           "server-2": mg("server-2", 1)})
    resp = ds.process_write2(Write2ToServer(wc, txn))
    assert isinstance(resp, RequestFailedFromServer)

    # configstamp ahead of the replica -> rejected with the ahead marker
    wc = WriteCertificate({f"server-{i}": mg(f"server-{i}", 7) for i in range(3)})
    resp = ds.process_write2(Write2ToServer(wc, txn))
    assert isinstance(resp, RequestFailedFromServer)
    assert "configstamp ahead" in resp.detail

    # uniform current configstamp -> applies
    wc = WriteCertificate({f"server-{i}": mg(f"server-{i}", 1) for i in range(3)})
    resp = ds.process_write2(Write2ToServer(wc, txn))
    assert not isinstance(resp, RequestFailedFromServer)


def test_fresh_member_bootstraps_history_from_archive():
    """A server that never saw configstamp 1 (booted at cs=2, after a
    remove+add reconfiguration) must still import pre-reconfig data: it
    learns the cs=1 config from the committed archive (resync pulls the
    _CONFIG_ keyspace first) and validates historical certificates against
    it — including grants signed by the since-removed member."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            for i in range(10):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"old-{i}", b"v%d" % i).build()
                )

            # one reconfiguration: remove server-4, add server-5
            kp6 = generate_keypair()
            servers = current_servers(vc)
            del servers["server-4"]
            newcomer = MochiReplica(
                server_id="server-5",
                config=vc.config,  # placeholder
                keypair=kp6,
                client_public_keys=vc.client_keys,
                host=vc.host,
                port=0,
            )
            await newcomer.start()
            servers["server-5"] = f"{vc.host}:{newcomer.bound_port}"
            new_cfg = vc.config.evolve(servers, public_keys={"server-5": kp6.public_key})
            # the newcomer boots knowing ONLY cs=2 — no cs=1 in its history
            newcomer.config = new_cfg
            newcomer.store.config = new_cfg
            newcomer.store.config_history = {new_cfg.configstamp: new_cfg}
            vc.replicas.append(newcomer)
            vc.keypairs["server-5"] = kp6

            await client.reconfigure_cluster(new_cfg)
            n = await newcomer.resync()
            assert 1 in newcomer.store.config_history, "archive not learned"

            owned = [
                f"old-{i}" for i in range(10) if newcomer.store.owns(f"old-{i}")
            ]
            assert owned, "newcomer should own some moved keys"
            for key in owned:
                sv = newcomer.store._get(key)
                assert sv is not None and sv.exists, (key, n)

    run(main())


def test_admin_gating_blocks_non_admin_reconfig():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            admin = vc.client()
            rogue = vc.client()
            # lock the config keyspace to the admin's key (replicas share
            # the config object, so this mutation reaches all of them)
            vc.config.admin_keys.append(admin.keypair.public_key)

            # rogue (registered, valid signatures, but not an admin) is denied
            try:
                await rogue.reconfigure_cluster(vc.config.evolve(current_servers(vc)))
                raise AssertionError("rogue reconfig should have failed")
            except AssertionError:
                raise
            except Exception:
                pass
            for r in vc.replicas:
                assert r.config.configstamp == 1
                assert r.metrics.counters.get("replica.admin-denied", 0) >= 1

            # the admin key goes through
            await admin.reconfigure_cluster(vc.config.evolve(current_servers(vc)))
            for r in vc.replicas:
                assert r.config.configstamp == 2

            # ordinary data traffic is unaffected by admin gating
            await rogue.execute_write_transaction(
                TransactionBuilder().write("plain", b"ok").build()
            )

    run(main())


def test_laggard_catches_up_after_two_missed_reconfigs():
    """A replica offline through cs=1->2->3 must walk the archive catch-up
    chain (each rung's certificate is stamped with the PREVIOUS config) and
    end at cs=3 with its data — the permanent-wedge scenario from review."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("survivor", b"v1").build()
            )
            # take server-4 down; reconfigure TWICE without it (membership
            # unchanged — stamps 2 and 3)
            victim = vc.replica("server-4")
            victim_port = victim.bound_port
            await victim.close()
            urls = {sid: info.url for sid, info in vc.config.servers.items()}
            await client.reconfigure_cluster(vc.config.evolve(urls))
            client.config = vc.replicas[0].config
            await client.reconfigure_cluster(client.config.evolve(urls))
            assert vc.replicas[0].config.configstamp == 3

            # server-4 comes back at cs=1 and resyncs
            fresh = MochiReplica(
                server_id="server-4",
                config=ClusterConfig.from_json(victim.config.to_json())
                if victim.config.configstamp == 1
                else vc.config,
                keypair=vc.keypairs["server-4"],
                client_public_keys=vc.client_keys,
                host=vc.host,
                port=victim_port,
            )
            # force its view back to cs=1 regardless of shared-object drift
            base = ClusterConfig.from_json(vc.config.to_json())
            base.configstamp = 1
            fresh.config = base
            fresh.store.config = base
            fresh.store.config_history = {1: base}
            await fresh.start()
            vc.replicas[vc.replicas.index(victim)] = fresh

            # the AUTOMATIC path: a targeted config resync (what the
            # configstamp-ahead nudge schedules) must fetch the archive
            # rungs even though it names only the head document
            await fresh.resync(keys=(CONFIG_CLUSTER_KEY,))
            assert fresh.config.configstamp == 3, fresh.config.configstamp
            # then data follows on a full sweep
            await fresh.resync()
            sv = fresh.store._get("survivor")
            assert sv is not None and sv.exists

    run(main())


def test_non_sequential_config_write_rejected():
    """A concurrent/stale admin commit whose document stamp is not current
    or current+1 must be refused — otherwise the stored membership document
    diverges from what replicas installed (split-brain from review)."""
    from mochi_tpu_torch.protocol import (
        Action, Grant, MultiGrant, Operation, RequestFailedFromServer,
        Status, Transaction, Write2ToServer, WriteCertificate,
        transaction_hash,
    )
    from mochi_tpu_torch.server.store import DataStore

    cfg = ClusterConfig.build(
        {f"s{i}": f"127.0.0.1:{9400+i}" for i in range(4)}, rf=4
    )
    ds = DataStore("s0", cfg)
    bad_doc = ClusterConfig.build(
        {f"s{i}": f"127.0.0.1:{9400+i}" for i in range(4)}, rf=4
    )
    bad_doc.configstamp = 7  # far from current 1
    txn = Transaction(
        (Operation(Action.WRITE, CONFIG_CLUSTER_KEY, bad_doc.to_json().encode()),)
    )
    h = transaction_hash(txn)
    wc = WriteCertificate({
        f"s{i}": MultiGrant(
            {CONFIG_CLUSTER_KEY: Grant(CONFIG_CLUSTER_KEY, 500, 1, h, Status.OK)},
            "c", f"s{i}",
        )
        for i in range(3)
    })
    resp = ds.process_write2(Write2ToServer(wc, txn))
    assert isinstance(resp, RequestFailedFromServer)
    assert "non-sequential" in resp.detail


def test_admin_gating_covers_client_registry():
    """_CONFIG_CLIENT_* writes are admin-gated when admin_keys is set: an
    ordinary registered client must NOT be able to overwrite another
    client's key binding (impersonation), while the admin key can — and a
    registry rotation drops the victim's live MAC session."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            admin = vc.client()
            rogue = vc.client()
            victim = vc.client()
            # establish victim sessions, then lock the config keyspace
            await victim.execute_write_transaction(
                TransactionBuilder().write("v", b"1").build()
            )
            vc.config.admin_keys.append(admin.keypair.public_key)

            try:
                await rogue.register_client_key(victim.client_id, bytes(32))
                raise AssertionError("non-admin registry write should fail")
            except AssertionError:
                raise
            except Exception:
                pass

            assert victim.client_id in vc.replicas[0]._sessions
            await admin.register_client_key(
                victim.client_id, victim.keypair.public_key
            )
            # rotation hook: victim's sessions were dropped on every replica
            for r in vc.replicas:
                assert victim.client_id not in r._sessions
            # and the victim transparently re-handshakes
            await victim.execute_write_transaction(
                TransactionBuilder().write("v", b"2").build()
            )
            res = await victim.execute_read_transaction(
                TransactionBuilder().read("v").build()
            )
            assert res.operations[0].value == b"2"

    run(main())


def test_evolve_carries_keys_and_bumps_stamp():
    kp = generate_keypair()
    cfg = ClusterConfig.build(
        {f"s{i}": f"127.0.0.1:{9300+i}" for i in range(4)},
        rf=4,
        public_keys={f"s{i}": kp.public_key for i in range(4)},
    )
    grown = cfg.evolve(
        {**{f"s{i}": f"127.0.0.1:{9300+i}" for i in range(4)}, "s4": "127.0.0.1:9304"},
        public_keys={"s4": kp.public_key},
    )
    assert grown.configstamp == cfg.configstamp + 1
    assert set(grown.servers) == {f"s{i}" for i in range(5)}
    assert grown.public_keys["s0"] == kp.public_key
    shrunk = grown.evolve({f"s{i}": f"127.0.0.1:{9300+i}" for i in range(4)})
    assert shrunk.configstamp == grown.configstamp + 1
    assert "s4" not in shrunk.public_keys


def test_reconfig_at_scale_n16():
    """Live removal from an n=16 rf=16 (f=5, quorum=11) cluster — the
    large-cluster shape.  Quorum math shifts under reconfiguration
    (rf 16 -> 15: f=(15-1)//3=4, quorum 9), and the archive/configstamp
    chain must hold when every server owns every key.  Pre-reconfig data
    stays readable and new writes commit with the NEW quorum size."""

    async def main():
        async with VirtualCluster(16, rf=16) as vc:
            assert vc.config.f == 5 and vc.config.quorum == 11
            client = vc.client(timeout_s=30.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("big-rk", b"v").build()
            )
            servers = current_servers(vc)
            del servers["server-15"]
            new_cfg = vc.config.evolve(servers, rf=15)
            assert new_cfg.f == 4 and new_cfg.quorum == 9
            await client.reconfigure_cluster(new_cfg)

            # pre-reconfig key readable; new write commits under new quorum
            await client.execute_write_transaction(
                TransactionBuilder().write("big-rk2", b"w").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("big-rk").read("big-rk2").build()
            )
            assert [r.value for r in res.operations] == [b"v", b"w"]
            cert = res.operations[1].current_certificate
            assert cert is not None and len(cert.grants) == new_cfg.quorum
            retired = vc.replica("server-15")
            assert "server-15" not in retired.config.servers

    run(main())


# ------------------------------------- differential: the two packages' evolve

_BASE = {f"server-{i}": f"127.0.0.1:{9500 + i}" for i in range(7)}


def _evolve_cases():
    grown = dict(_BASE, **{"server-7": "127.0.0.1:9507"})
    shrunk = {k: v for k, v in _BASE.items() if k != "server-6"}
    return {
        "add": (grown, {"server-7": 7}, None),
        "remove": (shrunk, {}, None),
        "rf": (dict(_BASE), {}, 7),
    }


@pytest.mark.parametrize("case", ["add", "remove", "rf"])
def test_evolve_equals_the_reference(case):
    from mochi_tpu.cluster.config import ClusterConfig as RefConfig

    servers, new_keys, rf = _evolve_cases()[case]
    seed_keys = {sid: bytes([i + 1]) * 32 for i, sid in enumerate(_BASE)}
    added = {sid: bytes([b]) * 32 for sid, b in new_keys.items()}
    kwargs = {"public_keys": added} if added else {}
    if rf is not None:
        kwargs["rf"] = rf
    configs = []
    for cls in (ClusterConfig, RefConfig):
        base = cls.build(dict(_BASE), rf=4, public_keys=dict(seed_keys))
        configs.append(base.evolve(dict(servers), **kwargs))
    port, ref = configs
    assert port.to_json() == ref.to_json()
    assert (port.f, port.quorum, port.configstamp) == (ref.f, ref.quorum, ref.configstamp)
    rng = random.Random(f"evolve-{case}")
    for _ in range(256):
        key = "k-%x" % rng.getrandbits(64)
        assert list(port.replica_set_for_key(key)) == list(ref.replica_set_for_key(key)), key
    assert set(port.servers) == set(servers)
