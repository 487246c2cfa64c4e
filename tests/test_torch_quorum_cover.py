"""Property tests for the client's quorum-cover machinery at large rf.

`_trim_to_quorum_cover` decides how many Ed25519 verifications the WHOLE
cluster pays per transaction (every replica in a key's set checks every
grant in the certificate — rf x |cert| verifies), and the real
n=64 f=21 cluster exercises it at quorum=43 for the first time.  These
properties pin the contract the integration tests rely on:

- validity: the trimmed subset still gives every key >= quorum distinct
  in-replica-set OK voters (safety: a thin cover would fail Write2);
- tightness: with single-key transactions and all-OK grants the cover is
  EXACTLY quorum (each extra grant costs rf verifies cluster-wide);
- never worse than the input: |trimmed| <= |chosen|.

Randomized over n in {4..64} with seeded rng — failures reproduce.
"""

from __future__ import annotations

import random

from mochi_tpu_torch.client.client import MochiDBClient
from mochi_tpu_torch.cluster.config import ClusterConfig
from mochi_tpu_torch.crypto.keys import generate_keypair
from mochi_tpu_torch.protocol.messages import (
    Action,
    Grant,
    MultiGrant,
    Operation,
    Status,
    Transaction,
)


def _config(n: int) -> ClusterConfig:
    return ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{20000 + i}" for i in range(n)}, rf=n
    )


def _client(cfg: ClusterConfig) -> MochiDBClient:
    # No network use: only the pure cover/trim methods are exercised.
    return MochiDBClient(config=cfg, keypair=generate_keypair())


def _multigrant(server_id: str, keys, ts: int = 7) -> MultiGrant:
    return MultiGrant(
        grants={
            k: Grant(
                object_id=k,
                timestamp=ts,
                configstamp=1,
                transaction_hash=b"h" * 64,
                status=Status.OK,
            )
            for k in keys
        },
        client_id="c",
        server_id=server_id,
    )


def _txn(keys) -> Transaction:
    return Transaction(
        tuple(Operation(Action.WRITE, k, b"v") for k in keys)
    )


def _cover_valid(client, txn, cert_grants) -> bool:
    cfg = client.config
    for op in txn.operations:
        rset = set(cfg.replica_set_for_key(op.key))
        voters = {
            mg.server_id
            for mg in cert_grants
            if mg.server_id in rset
            and (g := mg.grants.get(op.key)) is not None
            and g.status == Status.OK
        }
        if len(voters) < cfg.quorum:
            return False
    return True


def test_single_key_cover_is_exactly_quorum():
    for n in (4, 7, 16, 64):
        cfg = _config(n)
        client = _client(cfg)
        txn = _txn(["k"])
        rset = cfg.replica_set_for_key("k")
        chosen = [_multigrant(sid, ["k"]) for sid in rset]  # all rf respond
        trimmed = client._trim_to_quorum_cover(txn, chosen)
        assert len(trimmed) == cfg.quorum, (n, len(trimmed))
        assert _cover_valid(client, txn, trimmed)


def test_random_multikey_covers_stay_valid_and_never_grow():
    rng = random.Random(20260731)
    for trial in range(25):
        n = rng.choice([4, 8, 16, 32, 64])
        cfg = _config(n)
        client = _client(cfg)
        keys = [f"k{trial}-{i}" for i in range(rng.randint(1, 4))]
        txn = _txn(keys)
        # responders: a random superset of some quorum per key (the
        # _quorum_grant_subset stage guarantees coverage before trimming
        # runs, so build inputs that satisfy it)
        responders = set()
        for k in keys:
            rset = list(cfg.replica_set_for_key(k))
            rng.shuffle(rset)
            take = rng.randint(cfg.quorum, len(rset))
            responders.update(rset[:take])
        chosen = []
        for sid in sorted(responders):
            # each server grants the keys it replicates
            mine = [k for k in keys if sid in cfg.replica_set_for_key(k)]
            if mine:
                chosen.append(_multigrant(sid, mine))
        assert _cover_valid(client, txn, chosen), "test setup broken"
        trimmed = client._trim_to_quorum_cover(txn, chosen)
        assert len(trimmed) <= len(chosen)
        assert _cover_valid(client, txn, trimmed), (
            n, keys, len(chosen), len(trimmed)
        )


def test_quorum_grant_subset_drops_conflicting_timestamps():
    """A lagging/Byzantine minority at a different timestamp must be
    dropped while the majority's certificate still forms — the liveness
    fix over the reference's unanimity requirement
    (``MochiDBClient.java:195-219``)."""
    cfg = _config(16)
    client = _client(cfg)
    txn = _txn(["k"])
    rset = list(cfg.replica_set_for_key("k"))
    good = [_multigrant(sid, ["k"], ts=7) for sid in rset[: cfg.quorum]]
    laggards = [_multigrant(sid, ["k"], ts=3) for sid in rset[cfg.quorum :]]
    subset = client._quorum_grant_subset(txn, good + laggards)
    assert subset is not None
    ids = {mg.server_id for mg in subset}
    assert ids == {mg.server_id for mg in good}


def test_covers_and_grant_subsets_equal_the_reference():
    """Seeded multi-key grant sets (some at a lagging timestamp) through
    the port's client and the reference's: the grant subset each chooses
    and the cover each trims it to name the same servers in the same
    order."""
    from mochi_tpu.client.client import MochiDBClient as RefClient
    from mochi_tpu.cluster.config import ClusterConfig as RefConfig
    from mochi_tpu.crypto.keys import generate_keypair as ref_keypair
    from mochi_tpu_torch.protocol import Write1OkFromServer, Write2ToServer, WriteCertificate
    from tests.torch_crosswire import to_reference

    rng = random.Random(20261018)
    for trial in range(20):
        n = rng.choice([4, 7, 16, 64])
        cfg = _config(n)
        ref_cfg = RefConfig.from_json(cfg.to_json())
        client, ref_client = _client(cfg), RefClient(config=ref_cfg, keypair=ref_keypair())
        keys = [f"d{trial}-{i}" for i in range(rng.randint(1, 4))]
        txn = _txn(keys)
        responders = set()
        for k in keys:
            rset = list(cfg.replica_set_for_key(k))
            rng.shuffle(rset)
            responders.update(rset[: rng.randint(cfg.quorum, len(rset))])
        chosen = []
        for sid in sorted(responders):
            mine = [k for k in keys if sid in cfg.replica_set_for_key(k)]
            if mine:
                chosen.append(_multigrant(sid, mine, ts=7 if rng.random() < 0.85 else 3))
        ref_txn = to_reference(Write2ToServer(WriteCertificate({}), txn)).transaction
        ref_chosen = [to_reference(Write1OkFromServer(mg, {})).multi_grant for mg in chosen]
        subset, ref_subset = client._quorum_grant_subset(txn, chosen), ref_client._quorum_grant_subset(
            ref_txn, ref_chosen)
        assert (subset is None) == (ref_subset is None), trial
        if subset is None:
            continue
        assert [mg.server_id for mg in subset] == [mg.server_id for mg in ref_subset], trial
        trimmed = client._trim_to_quorum_cover(txn, list(subset))
        ref_trimmed = ref_client._trim_to_quorum_cover(ref_txn, list(ref_subset))
        assert [mg.server_id for mg in trimmed] == [mg.server_id for mg in ref_trimmed], trial
