"""The traffic generator: deterministic by seed, the same sizes for every
seed, and the configuration's shares."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import ed25519 as E
from portbench.generate import fnv64, make_pool, zipf_ranks

ROOT = Path(__file__).resolve().parents[2]


def tiny_config(n=4, f=1):
    cfg = json.loads((ROOT / "portbench/configs/n16_f5.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(replicas=n, f=f, quorum=2 * f + 1, grants_per_certificate=2 * f + 1)
    cfg["assumed"].update(forged_certificate_share=0.25, noncanonical_lane_share=1 / 16, nonce_pool=8,
                          forged_grants_per_certificate=[1, f])
    return cfg


TRAFFIC = {"name": "tiny", "loop": "closed", "ops_per_step": 16, "pool_batches": 3}


def test_same_seed_same_pool_other_seed_other_bytes_same_sizes():
    cfg = tiny_config(7, 2)
    a = make_pool(cfg, TRAFFIC, 2**31 + 5)
    b = make_pool(cfg, TRAFFIC, 2**31 + 5)
    c = make_pool(cfg, TRAFFIC, 12)
    for x, y in zip(a, b):
        assert (x.pubs, x.msgs, x.sigs) == (y.pubs, y.msgs, y.sigs)
        assert x.group_ids.tolist() == y.group_ids.tolist()
    assert [x.sigs for x in a] != [z.sigs for z in c]
    assert [(x.lanes, x.n_ops, x.n_updates, x.n_canonical) for x in a] == \
           [(z.lanes, z.n_ops, z.n_updates, z.n_canonical) for z in c]


def test_shares_and_shapes():
    cfg = tiny_config(7, 2)  # quorum 5
    pool = make_pool(cfg, TRAFFIC, 99)
    ops, quorum = 16, 5
    for b in pool:
        assert b.n_updates == 8
        assert b.lanes == 8 * quorum + 8
        per_slot = np.bincount(b.group_ids, minlength=ops)
        assert sorted(per_slot.tolist()) == [1] * 8 + [quorum] * 8
        noncanon = [i for i, s in enumerate(b.sigs) if int.from_bytes(s[32:], "little") >= E.L]
        assert len(noncanon) == round(b.lanes / 16) == b.lanes - b.n_canonical
        valid = [E.verify(p, m, s) for p, m, s in zip(b.pubs, b.msgs, b.sigs)]
        malleable = [E.verify(p, m, s, check_s=False) for p, m, s in zip(b.pubs, b.msgs, b.sigs)]
        assert all(malleable[i] for i in noncanon)  # S + L of a valid signature
        forged_slots = {int(b.group_ids[i]) for i, ok in enumerate(malleable) if not ok}
        assert len(forged_slots) == 2  # a quarter of 8 certificates
        for slot in forged_slots:
            lanes = np.flatnonzero(b.group_ids == slot)
            assert len(lanes) == quorum
            assert 1 <= sum(not malleable[i] for i in lanes) <= 2  # 1 to f forged grants
        for slot in range(ops):
            lanes = np.flatnonzero(b.group_ids == slot)
            if len(lanes) == quorum:  # a certificate's grants come from distinct replicas
                assert len({b.pubs[i] for i in lanes}) == quorum
                assert all(b.msgs[i].startswith(b"grant|user") for i in lanes)
            else:
                assert b.msgs[lanes[0]].startswith(b"read|user")
        assert sum(valid) == b.n_canonical - sum(not m for m in malleable)


def test_keys_are_ycsb_shaped():
    rng = np.random.default_rng(3)
    ranks = zipf_ranks(rng, 1000, 0.99, 20000)
    assert ranks.min() >= 0 and ranks.max() < 1000
    hits = np.bincount(ranks, minlength=1000)
    assert hits[0] > hits[1] > hits[10] > hits[500]  # zipfian: rank 0 the hottest
    assert 0.05 < hits[0] / 20000 < 0.2  # theta 0.99 over 1,000 items: ~13%
    hashed = [fnv64(v) for v in range(1000)]
    assert len(set(hashed)) == 1000 and all(0 <= h < 2**63 for h in hashed)
    cfg = tiny_config()
    pool = make_pool(cfg, TRAFFIC, 1)
    key = pool[0].msgs[0].split(b"|")[1]
    assert key.startswith(b"user") and len(key) == 4 + 19 and key[4:].isdigit()


def test_rejects_a_config_that_is_no_quorum_system():
    cfg = tiny_config(4, 1)
    cfg["quorum"] = 2
    with pytest.raises(ValueError):
        make_pool(cfg, TRAFFIC, 1)
