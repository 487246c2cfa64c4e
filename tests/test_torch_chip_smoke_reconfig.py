"""Rehearsal of ``chip_smoke.py``'s phase 16 on the CPU, at a cut size.

The cluster is n = 8 -> 9 -> 7 (f = 2, quorum 5 throughout): the add of
``server-8`` crosses the signer registry's capacity doubling from 8 to 16
signers as the card's n = 64 -> 65 crosses 64 -> 128.  Two clients x two
PUTs a stage, two probed replicas, over ``CudaBatchVerifier`` on the CPU
(the plain versions, so no launch is counted).  The phase's check is held
on the record this drive returns, and on records broken on purpose; the
grown-table comb check runs at 9 signers.  These live apart from
``tests/test_torch_chip_smoke.py`` so that they run beside it.
"""

import asyncio
import copy

import numpy as np
import pytest

import chip_smoke as cs

N, CLIENTS, WRITES, PROBED, REMOVED = 8, 2, 2, 2, 2


@pytest.fixture(scope="module")
def reconfig():
    return asyncio.run(asyncio.wait_for(cs.drive_reconfig(
        "cpu", N, CLIENTS, WRITES, PROBED, REMOVED, cs.member_seed(0), sdk_timeout_s=120.0), 600))


def test_reconfig_phase_rehearsal_on_cpu(reconfig):
    """Phase 16 at a cut size: the member is registered at index n and the
    table doubles once a comb batch has run; the altered certificate is
    refused with BAD_CERTIFICATE and the valid one accepted on every probed
    replica, with no item routed to the general kernel in either span;
    every acked key reads back with its stage's certificate; the retired
    replicas drop themselves; nothing falls back."""
    rec = reconfig
    st = rec["stages"]
    assert rec["member"] == "server-8" and rec["removed"] == ["server-6", "server-7"]
    assert st["before"]["generation"] == 8 and st["before"]["table_rows"]["fe17"] == 8 * 576
    assert st["add"]["generation"] == 9 and st["add"]["new_member_index"] == 8
    assert st["add"]["table_rows"]["fe17"] == 16 * 576
    assert [b["rows"] for b in st["add"]["table_builds"]] == [16 * 576]
    assert [(st[s]["members"], st[s]["f"], st[s]["quorum"]) for s in ("before", "add", "remove")] == [
        (8, 2, 5), (9, 2, 5), (7, 2, 5)]
    assert rec["acked"] == rec["expected"] == 3 * CLIENTS * WRITES and rec["read_back_bad"] == []
    assert set(rec["certificate_signers"]) == {"before", "add", "remove"}
    assert not {6, 7} & set(rec["certificate_signers"]["remove"])  # the retired ones sign no more
    pr = rec["probe"]
    assert pr["grants"] == 5 and pr["errors"] == [] and pr["probed"] == ["server-0", "server-1"]
    assert pr["altered_refused"] == [True, True] and pr["valid_accepted"] == [True, True]
    for name in ("probe_altered", "probe_valid"):
        assert st[name]["routing"]["ladder_items"] == 0 and st[name]["routing"]["comb_items"] > 0
    assert st["remove"]["retired_still_listed"] == []
    assert rec["generation"] == 9 and rec["table_rows_not_equal_to_host"] == 0
    assert rec["radix25_rows"] == 16 * 576
    assert rec["fallback_batches"] == rec["crossover_batches"] == 0
    assert cs.reconfig_problems(rec, launched=False) == []


def test_reconfig_phase_check_flags_what_it_must(reconfig):
    """Phase 16's check: a registry that did not grow (or grew elsewhere),
    a table that did not double, a member not installed everywhere, a
    retired replica still listing itself, a lost or wrongly certified key,
    an altered certificate accepted or a valid one refused, a general-kernel
    item in a probe span, a table row that is not its registry row and a
    fallback are each flagged; on the card a probe span without comb
    launches or with a general launch is too."""
    good = copy.deepcopy(reconfig)
    launched = {"chain": 2, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}
    for name in ("add", "probe_altered", "probe_valid"):
        good["stages"][name]["comb_launches"] = dict(launched)
    good["table_layout"] = "fe17"
    assert cs.reconfig_problems(good) == []
    breaks = [
        lambda r: r["stages"]["before"].update(generation=9),
        lambda r: r["stages"]["add"].update(new_member_index=None),
        lambda r: r["stages"]["add"]["table_rows"].update(fe17=8 * 576),
        lambda r: r["stages"]["add"].update(installed=8),
        lambda r: r["stages"]["remove"].update(retired_still_listed=["server-7"]),
        lambda r: r.update(read_back_bad=["rc-add-0-0"]),
        lambda r: r.update(acked=r["acked"] - 1),
        lambda r: r["probe"].update(altered_refused=[True, False]),
        lambda r: r["probe"].update(valid_accepted=[False, True]),
        lambda r: r["stages"]["probe_valid"]["routing"].update(ladder_items=1),
        lambda r: r.update(table_rows_not_equal_to_host=3),
        lambda r: r.update(fallback_batches=1),
    ]
    for brk in breaks:
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.reconfig_problems(bad)) == 1, bad
        assert len(cs.reconfig_problems(bad, launched=False)) == 1
    for brk in (lambda r: r["stages"]["probe_altered"]["comb_launches"].update(chain=0),
                lambda r: r["stages"]["probe_valid"].update(verify_launches=1),
                lambda r: r["stages"]["add"]["comb_launches"].update(chain=0)):
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.reconfig_problems(bad)) == 1 and cs.reconfig_problems(bad, launched=False) == []


def test_member_seed_gives_the_signer_the_cluster_registers():
    from mochi_tpu_torch.crypto.keys import keypair_from_seed

    seed = cs.member_seed(0)
    assert seed != cs.member_seed(1) and len(seed) == 32
    signer = cs.signer_from_seed(seed, np.random.default_rng(16))
    assert keypair_from_seed(seed).public_key == signer.pub


def test_member_comb_check_at_the_grown_table_on_cpu(monkeypatch):
    """The grown-table check at 8 signers and the member: the table pads to
    16 signers and equals its rows, lane 0 is under the member's index and
    the member's lanes are spread; each lane count asked for is held once
    against the plain version, on that table and those lanes (the
    comparison itself is recorded here: on the CPU both sides are the plain
    version, which the card run holds the kernel to)."""
    calls = []

    def held(n, table, table15, lanes, big_lanes, pre_ok, want, impl="chain"):
        calls.append((n, tuple(table.shape), int(lanes[0][0]), len(want)))
        return 0

    monkeypatch.setattr(cs, "_check_comb_at", held)
    signers = cs.make_signers(np.random.default_rng(3), 8)
    check, checked, info = cs.member_comb_check(0, signers, "cpu", n_items=128)
    assert info["registered"] == 9 and info["member_index"] == 8 and info["table_rows"] == 16 * 576
    assert info["table_entries_not_equal_to_host_rows"] == 0 and info["first_member_lane"] == 0
    assert info["member_lanes"] >= 4
    assert sorted(checked) == [1, cs.PARTIAL, 128] and set(checked.values()) == {0}
    check([5, 128, 300])
    assert [c[0] for c in calls] == [1, cs.PARTIAL, 128, 5, 300]
    assert {c[1:] for c in calls} == {((16 * 576, 51), 8, 128)}  # the CPU's fe17 rows; lane 0 the member's


def test_only_16_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(["--only", "16"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
