"""Cluster config: token ring, replica sets, quorum math, properties parsing.

Mirrors ``server/ClusterConfigurationTest.java``: token arithmetic (``:21-45``)
and key distribution over a bootstrap ring (``:47-103``) — and additionally
asserts keys spread across *distinct* replica sets, the behavior the
reference's ring-lookup bug (``ClusterConfiguration.java:215``) destroyed.
"""

import os

import pytest

from mochi_tpu_torch.cluster import ClusterConfig, round_robin_token_assignment
from mochi_tpu_torch.cluster.config import SHARD_TOKENS


def make_config(n=5, rf=4) -> ClusterConfig:
    return ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(n)}, rf=rf
    )


def test_round_robin_assignment_covers_ring():
    ids = [f"s{i}" for i in range(4)]
    assignment = round_robin_token_assignment(ids)
    all_tokens = sorted(t for tokens in assignment.values() for t in tokens)
    assert all_tokens == list(range(SHARD_TOKENS))
    assert all(len(v) == SHARD_TOKENS // 4 for v in assignment.values())


def test_quorum_math():
    cfg = make_config(5, 4)
    assert cfg.f == 1
    assert cfg.quorum == 3
    cfg7 = make_config(7, 7)
    assert cfg7.f == 2
    assert cfg7.quorum == 5


def test_replica_set_size_and_uniqueness():
    cfg = make_config(5, 4)
    for key in [f"key-{i}" for i in range(200)]:
        rs = cfg.replica_set_for_key(key)
        assert len(rs) == 4
        assert len(set(rs)) == 4


def test_keys_distribute_across_servers():
    # ref: ClusterConfigurationTest.java:47-103 — 200 random keys, each server
    # should serve a healthy share.
    cfg = make_config(5, 4)
    counts = {sid: 0 for sid in cfg.servers}
    for i in range(200):
        for sid in cfg.replica_set_for_key(f"random-key-{i}"):
            counts[sid] += 1
    assert all(c >= 20 for c in counts.values()), counts


def test_distinct_replica_sets_exist():
    # The fixed ring walk must produce >1 distinct replica set (the reference
    # bug collapsed all keys onto one).
    cfg = make_config(5, 4)
    sets = {tuple(sorted(cfg.replica_set_for_key(f"key-{i}"))) for i in range(100)}
    assert len(sets) > 1


def test_config_keys_owned_everywhere():
    cfg = make_config(5, 4)
    assert cfg.replica_set_for_key("_CONFIG_epoch") == sorted(cfg.servers)
    assert cfg.owns_key("server-3", "_CONFIG_epoch")


def test_validation_rejects_bad_rf():
    with pytest.raises(ValueError):
        make_config(5, rf=3)
    with pytest.raises(ValueError):
        make_config(3, rf=4)


def test_properties_roundtrip():
    cfg = make_config(5, 4)
    cfg.public_keys["server-0"] = b"\x07" * 32
    parsed = ClusterConfig.from_properties(cfg.to_properties())
    assert parsed.rf == cfg.rf
    assert parsed.token_owners == cfg.token_owners
    assert {s.url for s in parsed.servers.values()} == {s.url for s in cfg.servers.values()}
    assert parsed.public_keys == {"server-0": b"\x07" * 32}


def test_reference_properties_file_parses():
    # The repo's shipped properties config (the reference's format) loads
    # unmodified, to the same membership the reference package reads.
    from mochi_tpu.cluster import ClusterConfig as RefConfig

    path = os.path.join(os.path.dirname(__file__), "..", "config", "sample5_props", "cluster_config.properties")
    with open(path) as fh:
        text = fh.read()
    cfg = ClusterConfig.from_properties(text)
    assert cfg.n_servers == 5
    assert cfg.rf == 4
    assert cfg.quorum == 3
    assert cfg.to_json() == RefConfig.from_properties(text).to_json()


def test_json_roundtrip():
    cfg = make_config(6, 4)
    parsed = ClusterConfig.from_json(cfg.to_json())
    assert parsed == cfg


# ------------------------------------------------ token-ring ownership edges
#
# The shard-per-core scale-out (config 8) leans on exactly these properties:
# the ring walk at the top of the ring, non-dividing round-robin deals,
# ownership consistency across reconfiguration, and routing determinism
# across client restarts (same key -> same replica set in every process).


def test_replica_set_wraps_at_top_of_ring():
    cfg = make_config(6, 4)
    rs = cfg.replica_set_for_token(SHARD_TOKENS - 1)
    assert len(rs) == 4 and len(set(rs)) == 4
    # round-robin deal: token t is owned by server-(t % n); the walk from
    # 1023 must WRAP to tokens 0,1,... to collect its rf distinct owners.
    # 1024 % 6 != 0, so the owner sequence restarts at the wrap — the
    # expected set follows the RING position, not the modular pattern.
    expected = [
        f"server-{((SHARD_TOKENS - 1 + i) % SHARD_TOKENS) % 6}" for i in range(4)
    ]
    assert rs == expected  # ['server-3', 'server-0', 'server-1', 'server-2']
    # and the wrapped walk agrees with the unwrapped one structurally:
    # every token's set is rf distinct CONSECUTIVE ring owners
    for token in (0, 1, SHARD_TOKENS // 2, SHARD_TOKENS - 2, SHARD_TOKENS - 1):
        rs = cfg.replica_set_for_token(token)
        assert len(set(rs)) == cfg.rf


def test_round_robin_with_non_dividing_server_count():
    # 1024 % n != 0 for n in (5, 6, 7): the deal must still cover every
    # token exactly once with per-server counts within one of each other
    for n in (5, 6, 7):
        ids = [f"s{i}" for i in range(n)]
        assignment = round_robin_token_assignment(ids)
        all_tokens = sorted(t for tokens in assignment.values() for t in tokens)
        assert all_tokens == list(range(SHARD_TOKENS)), n
        counts = {sid: len(tokens) for sid, tokens in assignment.items()}
        assert max(counts.values()) - min(counts.values()) <= 1, counts
        # early ids get the extra token (deal order), never a hole
        assert counts[ids[0]] == -(-SHARD_TOKENS // n)


def test_owns_key_consistent_after_evolve():
    cfg = make_config(6, 4)
    grown = cfg.evolve(
        {
            **{sid: s.url for sid, s in cfg.servers.items()},
            "server-6": "127.0.0.1:8007",
            "server-7": "127.0.0.1:8008",
        },
        public_keys={"server-6": b"\x01" * 32, "server-7": b"\x02" * 32},
    )
    assert grown.configstamp == cfg.configstamp + 1
    keys = [f"evolve-key-{i}" for i in range(200)]
    for c in (cfg, grown):
        for key in keys:
            rset = set(c.replica_set_for_key(key))
            # owns_key must agree with replica-set membership for EVERY
            # server — replicas enforce WRONG_SHARD with owns_key while
            # clients route with replica_set_for_key; divergence would
            # make correctly-routed requests bounce
            for sid in c.servers:
                assert c.owns_key(sid, key) == (sid in rset), (key, sid)
    # minimal movement: the vast majority of keys keep at least one member
    # of their old replica set (the consistent-hash property evolve()
    # exists for; stolen tokens cluster at the top of donors' lists, so a
    # FEW keys can land on fully-fresh sets — a full re-deal would move
    # essentially all of them)
    moved = sum(
        1
        for key in keys
        if not set(cfg.replica_set_for_key(key)) & set(grown.replica_set_for_key(key))
    )
    assert moved <= len(keys) * 0.1, f"evolve() fully moved {moved}/{len(keys)} keys"


def test_shard_routing_deterministic_across_restarts():
    # Same key -> same replica set from two independently-parsed config
    # objects (a client restart re-parses the committed document; routing
    # must not depend on process state, dict order, or cache warmth)
    cfg = make_config(7, 4)
    doc = cfg.to_json()
    a = ClusterConfig.from_json(doc)
    b = ClusterConfig.from_json(doc)
    for i in range(300):
        key = f"route-{i}"
        assert a.replica_set_for_key(key) == b.replica_set_for_key(key)
        assert a.token_for_key(key) == b.token_for_key(key)
    # and the hash itself is pinned (process-independent SHA-512 prefix):
    # a silent change here would strand every existing deployment's data
    assert a.token_for_key("route-0") == b.token_for_key("route-0")
    from mochi_tpu_torch.cluster.config import stable_key_hash

    assert stable_key_hash("mochi") == int.from_bytes(
        __import__("hashlib").sha512(b"mochi").digest()[:8], "big"
    )


@pytest.mark.parametrize("n,rf", [(4, 4), (7, 4), (16, 10), (64, 64)])
def test_ring_walk_and_quorum_targets_equal_the_reference(n, rf):
    """The same membership built by both packages: equal token ring, equal
    replica set for every seeded key (the ring walk), equal f and quorum,
    equal JSON, and the client's trimmed read fan-out
    (``_quorum_targets``) picks the same servers call after call."""
    import random

    from mochi_tpu.client import MochiDBClient as RefClient
    from mochi_tpu.client.txn import TransactionBuilder as RefBuilder
    from mochi_tpu.cluster import ClusterConfig as RefConfig
    from mochi_tpu_torch.client import MochiDBClient
    from mochi_tpu_torch.client.txn import TransactionBuilder

    servers = {f"server-{i}": f"127.0.0.1:{9400 + i}" for i in range(n)}
    mine, theirs = ClusterConfig.build(servers, rf=rf), RefConfig.build(servers, rf=rf)
    assert mine.to_json() == theirs.to_json()
    assert (mine.f, mine.quorum) == (theirs.f, theirs.quorum)
    rng = random.Random(n * 1000 + rf)
    keys = [f"key-{rng.getrandbits(48):x}" for _ in range(200)]
    for key in keys:
        assert [s.server_id for s in mine.servers_for_key(key)] == [s.server_id for s in theirs.servers_for_key(key)]
    c_mine, c_theirs = MochiDBClient(mine), RefClient(theirs)
    for k in range(12):
        chosen = keys[k * 5 : k * 5 + 1 + k % 5]
        tb_mine, tb_theirs = TransactionBuilder(), RefBuilder()
        for key in chosen:
            tb_mine.read(key)
            tb_theirs.read(key)
        assert [sid for sid, _ in c_mine._quorum_targets(tb_mine.build())] == [
            sid for sid, _ in c_theirs._quorum_targets(tb_theirs.build())]
