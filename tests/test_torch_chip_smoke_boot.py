"""Rehearsals of ``chip_smoke.py``'s phases 9t and 17a-17c on the CPU, at a
cut size, with the checks each phase makes held on the records these
drives return and on records broken on purpose; and the operator scripts
(``scripts/*_torch.sh``) run here in the postures that need no card.  On
the CPU the kernels' plain versions run and no launch is counted.  These
live apart from ``tests/test_torch_chip_smoke.py`` so that they run beside
it.
"""

import asyncio
import copy
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run small tensors: one intra-op thread each keeps
    this file's workers from contending with the other files' for the
    host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def signers():
    return cs.make_signers(np.random.default_rng(0), 16)


# ------------------------------------------------------------- 17a: warmup


@pytest.fixture(scope="module")
def boot():
    warmed = cs.boot_child(0, "16,32", checks=2, device="cpu", n_signers=8)
    cold = cs.boot_child(0, "", checks=2, device="cpu", n_signers=8)
    return warmed, cold


def _card_like(ch: dict, warm) -> dict:
    """A child's record as the card gives it: launches of both kernels in
    each check and, when warmed, at each warmup size."""
    ch = copy.deepcopy(ch)
    launches = [["verify_pad", 1, 0.55], ["comb_chain", 43, 0.18]]
    ch.update(warm_launches=[[k, n] for n in warm for k in ("comb_chain", "verify_pad")], has_fallback=False,
              first_check={"wall_ms": 9.0, "right": True, "launches": launches},
              last_check={"wall_ms": 6.0, "right": True, "launches": launches},
              all_right=all(c["right"] for c in ch.pop("checks")))
    return ch


def test_boot_phase_rehearsal_on_cpu(boot):
    """Phase 17a at a cut size: both children verify every check right with
    no fallback batch; the warmed one took its warmup seconds for the two
    sizes, and the checks' walls are recorded."""
    warmed, cold = boot
    for ch, sizes in ((warmed, [16, 32]), (cold, [])):
        assert ch["warmup_buckets"] == sizes and ch["fallback_batches"] == 0
        assert len(ch["checks"]) == 2 and all(c["right"] and c["wall_ms"] > 0 for c in ch["checks"])
        assert ch["warm_launches"] == [] and ch["construct_s"] >= ch["warmup_s"] > 0


def test_boot_check_flags_what_it_must(boot):
    """Phase 17a's check: a kernel not warmed at one of the sizes, a wrong
    verdict, a fallback, a cold child that launched at construction and a
    first check that reached one kernel only are each flagged."""
    warmed, cold = boot
    good = {"warmed": _card_like(warmed, cs.BOOT_WARMUP), "cold": _card_like(cold, ()), "nvidia_smi": "x"}
    assert cs.boot_problems(good) == []
    breaks = [
        lambda r: r["warmed"]["warm_launches"].remove(["verify_pad", 256]),
        lambda r: r["warmed"].update(all_right=False),
        lambda r: r["cold"].update(fallback_batches=1),
        lambda r: r["cold"].update(warm_launches=[["comb_chain", 16]]),
        lambda r: r["warmed"]["first_check"].update(launches=[["comb_chain", 43, 0.2]]),
    ]
    for brk in breaks:
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.boot_problems(bad)) == 1, bad


# ------------------------------------------------------------- 17b: window


@pytest.fixture(scope="module")
def window(signers):
    return cs.run_window(0, signers, "cpu", sizes=(16, 32, 64), counts=(48, 16, 64))


def test_window_phase_rehearsal_on_cpu(window):
    """Phase 17b at a cut size: every chunk size gives the expected
    verdicts, at most four chunks in flight (exactly four where there are
    more), an all-rejected chunk each, and a sample equal to keys.verify."""
    rec = window
    assert cs.window_problems(rec, launched=False) == []
    assert rec["sizes_agree"] and rec["sample_vs_keys_verify_wrong"] == 0
    assert [(r["chunks"], r["peak_chunks_in_flight"], r["chunks_all_rejected"]) for r in rec["sizes"].values()] == [
        (8, 4, 4), (5, 4, 2), (3, 3, 1)]
    assert all(r["wrong"] == 0 and r["routing"]["comb_items"] == 48 for r in rec["sizes"].values())


def test_window_check_flags_what_it_must(window):
    """Phase 17b's check: a wrong verdict, more than four chunks in flight,
    no all-rejected chunk, sizes that disagree, a sample off keys.verify,
    and on the card a size without a launch of each default kernel, or with
    an mxu launch, are each flagged."""
    good = copy.deepcopy(window)
    for r in good["sizes"].values():
        r["verify_launches"], r["comb_launches"]["chain"] = 1, 2
    assert cs.window_problems(good) == []
    breaks = [
        lambda r: r["sizes"][16].update(wrong=1),
        lambda r: r["sizes"][32].update(peak_chunks_in_flight=5),
        lambda r: r["sizes"][64].update(chunks_all_rejected=0),
        lambda r: r.update(sizes_agree=False),
        lambda r: r.update(sample_vs_keys_verify_wrong=2),
        lambda r: r["sizes"][16].update(verify_launches=0),
        lambda r: r["sizes"][32].update(verify_mxu_launches=1),
    ]
    for brk in breaks:
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.window_problems(bad)) == 1, bad


# ---------------------------------------------------- 17c: operator scripts


@pytest.mark.parametrize("verifier", ["remote", "cpu"])
def test_operators_phase_rehearsal_on_cpu(verifier):
    """Phase 17c at its own size with the host's verifier:
    ``start_cluster_torch.sh`` boots (under ``remote``, a sidecar with
    ``--backend cpu`` first), 8 PUTs read back with a quorum of grants, and
    SIGINT to the group stops every process of it, the script exiting 0."""
    rec = asyncio.run(asyncio.wait_for(cs.drive_operators(verifier, "cpu", cs.OPS_N, cs.OPS_RF, cs.OPS_WRITES), 300))
    assert cs.operators_problems(rec, on_card=False) == []
    assert set(rec["ready_s"]) == {f"server-{i}" for i in range(cs.OPS_N)} | (
        {"verifier-service"} if verifier == "remote" else set())
    assert rec["read_back_grants"] == [3] * cs.OPS_WRITES and len(rec["group_pids"]) >= cs.OPS_N + 1
    if verifier == "remote":
        assert rec["service"]["types"] == ["CachingVerifier", "CpuVerifier"] and rec["service"]["items"] > 0
    else:
        assert rec["service"] is None


def test_operators_check_flags_what_it_must():
    """Phase 17c's check: a lost or thinly certified key, a replica that
    fell back or is not on the remote verifier, a script that did not exit
    0 on SIGINT or left a process, and on the card a sidecar without comb
    dispatches after READY, without its warmup, or that fell back."""
    remote = {"CoalescingVerifier", "RemoteVerifier"}
    good = {"verifier": "remote", "acked": cs.OPS_WRITES, "read_back_bad": [], "script_rc": 0,
            "left_after_stop": [],
            "replica_verifiers": {f"server-{i}": {"types": sorted(remote), "fallback_batches": 0} for i in range(5)},
            "service": {"dispatches_after_ready": 8, "comb_items_after_ready": 24, "fallback_batches": 0,
                        "warmup": {"buckets": list(cs.BOOT_WARMUP), "seconds": 0.3}}}
    assert cs.operators_problems(good) == []
    breaks = [
        lambda r: r.update(read_back_bad=["ops-1"]),
        lambda r: r["replica_verifiers"]["server-2"].update(fallback_batches=1),
        lambda r: r["replica_verifiers"]["server-0"].update(types=["CpuVerifier"]),
        lambda r: r.update(script_rc=1),
        lambda r: r.update(left_after_stop=[123]),
        lambda r: r["service"].update(dispatches_after_ready=0),
        lambda r: r["service"].update(warmup=None),
        lambda r: r["service"].update(fallback_batches=2),
    ]
    for brk in breaks:
        bad = copy.deepcopy(good)
        brk(bad)
        assert len(cs.operators_problems(bad)) == 1, bad


def test_default_posture_fails_loudly_without_a_card(tmp_path):
    """``start_cluster_torch.sh`` with no ``MOCHI_VERIFIER`` runs every
    replica on the card: here, with none, it exits non-zero, says so, and
    leaves no replica running."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MOCHI_VERIFIER")}
    base = cs.free_port_range(4, hi=40000)
    p = subprocess.Popen(["bash", str(REPO / "scripts" / "start_cluster_torch.sh"), "4", "4", str(base),
                          str(tmp_path / "cluster")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    out, _ = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "no CUDA device is available" in out
    assert cs._group_pids(p.pid) == []  # the script's session: nothing of it left


def test_scripts_run_the_port_and_lint_clean():
    """Every ``_torch`` operator script runs the port's modules and none of
    the JAX package's; ``lint_torch.sh`` passes over the port's tree and
    the scripts' Python against the port's empty baseline."""
    for name in ("start_cluster_torch.sh", "start_server_torch.sh", "soak_torch.sh", "lint_torch.sh"):
        text = (REPO / "scripts" / name).read_text()
        mods = [w for w in text.split() if w.startswith("mochi_tpu")]
        assert mods and all(m.startswith("mochi_tpu_torch") for m in mods), (name, mods)
    p = subprocess.run(["bash", str(REPO / "scripts" / "lint_torch.sh")], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new" in p.stdout


# ------------------------------------------------------------------ 9t, knobs


def test_cluster_tree_phase_rehearsal_on_cpu(monkeypatch):
    """Phase 9t at a small size: the cluster under the tree switch commits
    and reads back every write, its grants on the comb path's plain tree
    (no launch on the CPU), and the phase's check passes it once a card's
    launches are not asked for."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    real_client = VirtualCluster.client
    monkeypatch.setattr(VirtualCluster, "client", lambda self, **kw: real_client(self, **{"timeout_s": 240, **kw}))
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")
    seen = []
    real = comb.verify_comb_prepared
    monkeypatch.setattr(comb, "verify_comb_prepared", lambda *a, impl=None, multiply=None: seen.append(
        (impl, multiply)) or real(*a, impl=impl, multiply=multiply))
    cs._zero_counts()
    out = asyncio.run(asyncio.wait_for(cs.drive_cluster("cpu", 4, 2, 2), 300))
    cs._read_counts(out)
    assert out["quorum"] == 3 and out["writes"] == out["acked"] == out["read_back"] == 4
    assert seen and {impl for impl, _ in seen} == {"tree"}
    assert cs.cluster_tree_problems(out, launched=False) == []
    assert cs.cluster_tree_problems(out) == [f"the tree carried nothing: {out['comb_launches']}, {out['routing']}"]
    chain = copy.deepcopy(out)
    chain["comb_launches"].update(tree=3, chain=1)
    assert len(cs.cluster_tree_problems(chain)) == 1


@pytest.mark.parametrize("value", ["", "0", "-5", "abc", "100", "8192", "20000", None])
def test_max_bucket_equals_the_reference(monkeypatch, value):
    """``MOCHI_MAX_BUCKET`` is read as the reference reads it: default 8192,
    clamped to at least 16, rounded down to a power of two."""
    from mochi_tpu.crypto import batch_verify as ref_bv
    from mochi_tpu_torch.crypto import batch_verify as bv

    if value is None:
        monkeypatch.delenv("MOCHI_MAX_BUCKET", raising=False)
    else:
        monkeypatch.setenv("MOCHI_MAX_BUCKET", value)
    assert bv._max_bucket() == ref_bv._max_bucket()


def test_only_17_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(["--only", "17"]) == 2
    assert cs.main(["--boot-child", "16"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
