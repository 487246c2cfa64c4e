"""Rehearsal of ``chip_smoke.py``'s phases 15, 15p and 15s on the CPU, at a
cut size.

Phase 15 runs 10 replicas (f = 3) with a forge-cert, an equivocating and a
stale-replay replica (no silent one: a silent replica costs every client a
handshake timeout, which the process rehearsal below pays instead), one
honest client writing one key twice and one partial-write2 client, over
``CudaBatchVerifier`` on the CPU (the plain versions), one probed replica
and one honest key nudged; 15p runs 7 replicas in 2 processes with a
silent and a forge-cert replica on the CPU verifier; 15s runs two scenario
seeds under ``verifier="cpu"``.  Each phase's check is held on the records
these drives return, and on records broken on purpose.  These live apart
from ``tests/test_torch_chip_smoke.py`` so that they run beside it.
"""

import asyncio
import copy

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def adversaries():
    return asyncio.run(asyncio.wait_for(cs.drive_adversaries(
        "cpu", 10, (("forge-cert", 1), ("equivocate", 1), ("stale-replay", 1)), 1, 1, 2, 1, 1, honest_nudged=1), 240))


def test_adversary_phase_rehearsal_on_cpu(adversaries):
    """Phase 15 at a cut size: every acked write reads back with a
    2f+1-grant certificate, no invariant is violated, the equivocator is
    convicted on the probed replica, the forged-grant certificate is
    refused with BAD_CERTIFICATE, the forge-cert and stale-replay replicas
    are suspected as they must be, the adversary's minority commit heals
    on the nudged replicas, which refuse the forge-cert replica's sync
    entries, and nothing falls back."""
    rec = adversaries
    assert rec["byzantine"] == {"server-1": "forge-cert", "server-2": "equivocate", "server-3": "stale-replay"}
    assert rec["quorum"] == 7 and rec["honest"] == 7 and rec["probed"] == ["server-0"]
    assert rec["acked"] == 1 and rec["writes"] == 2 and rec["read_back"] == 1 and rec["read_back_bad"] == []
    assert rec["invariants"]["ok"] and rec["invariants"]["acked_writes"] == 2
    assert rec["convictions"] == {"server-0": {"server-2": 1}}
    fp = rec["forged_probe"]
    assert fp["refused"] == [True] and fp["grants"] == 7 and fp["forger_grant_had_zero_hash"]
    assert rec["suspicion"]["server-1"]["bad-grant"] > 0
    assert rec["suspicion"]["server-3"]["grant-conflict"] > 0
    assert rec["adversary_client"]["partial_commits_acked"] == 1 and rec["resync"]["healed"]
    assert all(r["resync-bad-certificate"] > 0 for r in rec["resync"]["by_replica"].values())
    assert rec["fallback_batches"] == rec["crossover_batches"] == 0
    assert cs.adversary_problems(rec, launched=False) == []


def test_adversary_phase_check_flags_what_it_must(adversaries):
    """Phase 15's check: a violation, a key that does not read back, an
    unconvicted equivocator, a forged certificate that was accepted, a
    forge-cert replica nobody suspected, no grant-conflict against the
    stale-replay replicas, a nudged replica that did not heal or refused no
    forged sync entry and a fallback are each flagged; on the card a
    forged-grant span and a phase without comb launches are too."""
    good = copy.deepcopy(adversaries)
    good["comb_launches"] = {"chain": 3, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}
    good["routing"] = {"comb_items": 42}
    good["forged_probe"]["comb_launches"] = {"chain": 2, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}
    assert cs.adversary_problems(good) == []
    breaks = [
        lambda r: r["invariants"].update(ok=False, violations=["conflicting commits"]),
        lambda r: r.update(read_back_bad=["adv-0-1"]),
        lambda r: r.update(acked=r["acked"] - 1),
        lambda r: r["convictions"]["server-0"].update({"server-2": 0}),
        lambda r: r["forged_probe"].update(refused=[False]),
        lambda r: r["suspicion"]["server-1"].update({"bad-grant": 0}),
        lambda r: r["suspicion"].pop("server-3"),
        lambda r: r.update(fallback_batches=1),
        lambda r: r["resync"].update(healed=False),
        lambda r: r["resync"]["by_replica"]["server-0"].update({"resync-bad-certificate": 0}),
    ]
    for brk in breaks:
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.adversary_problems(bad)) == 1, bad
        assert len(cs.adversary_problems(bad, launched=False)) == 1
    for brk in (lambda r: r["forged_probe"].update(comb_launches={"chain": 0}),
                lambda r: r["comb_launches"].update(chain=0)):
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.adversary_problems(bad)) == 1 and cs.adversary_problems(bad, launched=False) == []


def test_byzantine_map_assigns_from_server_1():
    assert cs.byzantine_map(cs.ADV_STRATEGIES) == {
        **{f"server-{i}": "forge-cert" for i in range(1, 7)},
        **{f"server-{i}": "equivocate" for i in range(7, 12)},
        **{f"server-{i}": "stale-replay" for i in range(12, 17)},
        **{f"server-{i}": "silent" for i in range(17, 22)},
    }
    assert len(cs.byzantine_map(cs.ADV_PROC_STRATEGIES)) == (cs.ADV_N - 1) // 3 == 21


def test_adversary_process_phase_rehearsal_on_cpu():
    """Phase 15p at a cut size: the children host their adversaries from
    ``--byzantine``, every write acks and reads back, every honest
    replica's admin shell answers, every child is alive; on the CPU the
    card's parts of the check fail, the rest pass, and a missing ack or a
    dead child is flagged."""
    rec = asyncio.run(asyncio.wait_for(cs.drive_adversary_processes(
        "cpu", 7, 2, (("silent", 1), ("forge-cert", 1)), 2, 2, sdk_timeout_s=2.0, ready_timeout_s=120,
        timeout_s=120), 240))
    assert sorted(sum(rec["byzantine_by_process"].values(), [])) == ["server-1", "server-2"]
    assert rec["acked"] == rec["expected"] == 4 and rec["read_back_bad"] == []
    assert sum(ch["replicas"] for ch in rec["status"].values()) == 5  # the honest ones
    assert {tuple(ch["types"]) for ch in rec["status"].values()} == {("CpuVerifier",)}
    assert rec["alive"] == ["proc-0", "proc-1"]
    assert cs.adversary_process_problems(rec, on_card=False) == []
    assert cs.adversary_process_problems(rec)  # no card here: the card's checks fail
    short = dict(rec, acked=3)
    assert len(cs.adversary_process_problems(short, on_card=False)) == 1
    dead = dict(rec, alive=["proc-0"])
    assert len(cs.adversary_process_problems(dead, on_card=False)) == 1


def test_scenario_phase_rehearsal_on_cpu():
    """Phase 15s at a cut size (two of its seeds, the CPU posture): clean
    verdicts and canonical records recorded by sha256; the check flags a
    violation, records that differ between postures, and a card run
    without launches or with a fallback."""
    rec, logs = cs.run_scenarios((0, 7), postures=("cpu",))
    assert sorted(rec["runs"]) == ["0", "7"] and set(logs) == {(0, "cpu"), (7, "cpu")}
    assert rec["runs"]["0"]["families"] == {"byz-replica": 1}
    assert rec["runs"]["7"]["families"] == {"byz-client": 1}
    assert cs.scenario_problems(rec, launched=False) == []
    two = copy.deepcopy(rec)
    two["postures"] = ["cuda", "cpu"]
    for runs in two["runs"].values():
        runs["cuda"] = dict(runs["cpu"], comb_launches={"chain": 2}, verify_launches=1,
                            verifier={"posture": "cuda", "fallback_batches": 0, "crossover_batches": 0})
    assert cs.scenario_problems(two) == []
    for brk in (lambda r: r["runs"]["0"]["cuda"].update(canonical_sha256="0" * 64),
                lambda r: r["runs"]["7"]["cpu"].update(ok=False, violations=["conflicting commits"]),
                lambda r: r["runs"]["0"]["cuda"].update(comb_launches={"chain": 0}, verify_launches=0),
                lambda r: r["runs"]["7"]["cuda"]["verifier"].update(fallback_batches=1)):
        bad = copy.deepcopy(two)
        brk(bad)
        assert len(cs.scenario_problems(bad)) == 1, bad


def test_only_15_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(["--only", "15"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
