"""Rehearsal of ``chip_smoke.py`` on the CPU, at a small size.

The script itself runs only where there is a card; here its corpus, its
expected verdicts and its service drive are checked against OpenSSL and the
port's plain version, and its refusal to run without a card is pinned.
"""

import asyncio
import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mochi_tpu.crypto import hostfallback as jhf
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import cuda_verify as CV
from mochi_tpu_torch.crypto import keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def signers():
    return cs.make_signers(np.random.default_rng(3), 8)


def test_corpus_verdicts_match_openssl_and_the_plain_version(signers):
    items, want, kinds = cs.make_corpus(5, 192, signers)
    assert len(items) == len(want) == len(kinds) == 192
    assert {"valid", "wrong key", "mixed-order A", "x=0 sign=1 A", "65-byte signature"} <= set(kinds)
    assert [keys.verify(i.public_key, i.message, i.signature) for i in items] == want
    assert BV.verify_batch(items, device="cpu") == want
    # the adversarial kinds the reference answers include acceptances
    adv_true = {k for k, w in zip(kinds, want) if w and k != "valid"}
    assert "identity A, S=r" in adv_true and "identity A and R, S=0" in adv_true
    # the JAX package's pure-Python engine agrees on every canonical item
    for it, w in zip(items, want):
        if cs.reference_verdict(it.public_key, it.message, it.signature) != w:
            pytest.fail(f"reference disagrees on {it}")
        if len(it.public_key) == 32 and len(it.signature) == 64 and w:
            assert jhf.verify(it.public_key, it.message, it.signature)


def test_traffic_is_distinct_certificates_of_2f_plus_1_grants(signers):
    traffic = cs.make_traffic(9, signers, clients=3, requests=2, grants=5, forge_rate=0.2)
    reqs = [r for per_client in traffic for r in per_client]
    assert len(reqs) == 6 and all(len(items) == 5 for items, _ in reqs)
    flat = [(i.public_key, i.message, i.signature) for items, _ in reqs for i in items]
    assert len(set(flat)) == len(flat) == 30
    want = [w for _, ws in reqs for w in ws]
    assert [keys.verify(*t) for t in flat] == want
    assert 0 < sum(want) < 30


def test_traffic_waves_put_each_wave_of_checks_together(signers):
    traffic = cs.make_traffic(9, signers, clients=3, requests=2, grants=5, forge_rate=0.2)
    items, want = cs.traffic_waves(traffic)
    assert items[:15] == [it for per_client in traffic for it in per_client[0][0]]
    assert want[15:] == [w for per_client in traffic for w in per_client[1][1]]


def test_kernel_vs_plain_check_raises_on_a_wrong_verdict(signers):
    traffic = cs.make_traffic(13, signers, clients=2, requests=1, grants=5, forge_rate=0.3)
    items, want = cs.traffic_waves(traffic)
    prepared = BV.prepare_packed(items)
    tens = CV.from_reference_prepared(prepared, "cpu")
    assert cs.check_kernel_vs_plain(tens, prepared[6], want) == 0
    with pytest.raises(AssertionError, match="1 wrong verdicts"):
        cs.check_kernel_vs_plain(tens, prepared[6], [not want[0]] + want[1:])


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_busy_is_the_union_of_launch_intervals():
    log = [(8, _Ev(1.0), _Ev(3.0)), (8, _Ev(2.0), _Ev(4.0)), (4, _Ev(6.0), _Ev(7.0)), (8, _Ev(2.5), _Ev(3.5))]
    got = cs.device_busy(log, _Ev(0.0), _Ev(10.0))
    assert got["span_ms"] == 10.0 and got["kernel_busy_ms"] == 4.0 and got["kernel_sum_ms"] == 6.0
    assert got["idle_share"] == pytest.approx(0.6)
    assert got["launch_ms_by_lanes"] == {4: {"launches": 1, "median_ms": 1.0},
                                         8: {"launches": 3, "median_ms": 2.0}}


def test_service_drive_counts_on_cpu(signers):
    traffic = cs.make_traffic(11, signers, clients=3, requests=2, grants=5)
    CV.launches.update(pad=0, mxu=0)
    BV.reset_counts()
    svc = asyncio.run(asyncio.wait_for(cs.drive_service(traffic, "cpu", b"k" * 32), 240))
    assert svc["requests"] == 6 and svc["items"] == 30 and svc["mismatched_requests"] == 0
    assert BV.device_item_count() == 30
    assert svc["fallback_batches"] == svc["crossover_batches"] == svc["remote_fallbacks"] == 0
    assert CV.launches == {"pad": 0, "mxu": 0}  # the plain version on the CPU is no kernel launch


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no CUDA device" in out.err


def test_sass_counts_name_every_width_and_predicate():
    sass = """
        Function : mochi_ed25519_verify_kernel
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;         /* 0x0000000504027225 */
        /*0020*/               @P0 IMAD R6, R7, R8, R9 ;                  /* 0x0000000807060224 */
        /*0030*/                   STL.128 [R1], R4 ;                     /* 0x0000000401007387 */
        /*0040*/              @!P2 STL [R1+0x10], R2 ;                    /* 0x0000100201002387 */
        /*0050*/                   LDL.LU R3, [R1+0x10] ;                 /* 0x0000100001037983 */
        /*0060*/                   LDS R9, [R10] ;                        /* 0x000000000a097984 */
        /*0070*/                   IMMA.16832.U8.U8 R12, R16.ROW, R20.COL, R12 ; /* 0x000000141010723c */
        /*0080*/                   EXIT ;                                 /* 0x000000000000794d */
    """
    assert cs.sass_counts(sass) == {"instructions": 9, "imad": 2, "mma": 1, "local_stores": 2, "local_loads": 1}


def test_fails_alone_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ------------------------------------------------------------ comb phases


def test_comb_corpus_verdicts_match_openssl_and_the_routed_plain_version(signers):
    from mochi_tpu.crypto import keys as jkeys
    from mochi_tpu_torch.crypto import comb

    items, want, kinds = cs.make_comb_corpus(6, 200, signers)
    assert len(items) == len(want) == len(kinds) == 200
    assert {"valid", "another signer's key", "order-8 R", "x=0 sign=1 R", "R y = p + 1",
            "S >= L (S + L)", "identity R, S=ha"} <= set(kinds)
    assert [jkeys.verify(i.public_key, i.message, i.signature) for i in items] == want
    reg = comb.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers])
    assert {reg.index_of(i.public_key) for i in items} <= set(range(len(signers)))
    BV.reset_counts()
    assert BV.verify_batch(items, device="cpu", registry=reg) == want
    assert BV.comb_routing_counts()["comb_items"] == 200
    # "identity R, S = h a" is the one adversarial kind the equation accepts
    assert {k for k, w in zip(kinds, want) if w and k != "valid"} == {"identity R, S=ha"}


def test_table_radix_check_counts_a_wrong_entry(signers):
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg = comb.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers[:2]])
    t15 = reg.device_table("cpu", layout="fe17")
    t25 = torch.from_numpy(CC.to_radix25(t15.numpy()))
    assert cs.check_table_radix(t25, t15) == 0
    t25[577, 2, 4] ^= 1
    assert cs.check_table_radix(t25, t15) == 1


def _sweep_rehearsal(signers, monkeypatch, impl, ref_kw, skew="mxu"):
    """A launch-size sweep of ``impl`` under ``skew`` (on the CPU its plain
    version; under ``mxu`` every multiply through ``_mul_mxu``) over the
    comb corpus tiled past its length, held by ``chip_smoke.sweep_vs``
    against the bitmap of ``verify_comb_prepared(..., **ref_kw)`` on the
    same lanes and the expected verdicts: no lane differs, every count is timed; a bitmap with
    one lane flipped is flagged at every count that reaches the lane and at
    no other."""
    import time

    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    items, want, _ = cs.make_comb_corpus(8, 10, signers)
    reg = comb.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers])
    prep = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(i.public_key) for i in items], dtype=np.int32)
    tiled = [torch.cat([t] * 2) for t in CC.from_prepared(kidx, prep, "cpu")]
    table = reg.device_table("cpu", layout="fe17")
    ref = CC.verify_comb_prepared(table, *tiled, **ref_kw).numpy()
    pre_ok, want2 = np.tile(prep[6], 2), np.tile(np.asarray(want, dtype=bool), 2)
    monkeypatch.setattr(F, "SKEW_IMPL", skew)
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))

    def launch(n):
        return CC.verify_comb_prepared(table, *[t[:n] for t in tiled], impl=impl)

    def host_ms(n):
        t0 = time.perf_counter()
        launch(n)
        return 1e3 * (time.perf_counter() - t0)

    counts = (1, 8, 20)
    before = dict(CC.launches)
    sweep, differing = cs.sweep_vs(launch, ref, pre_ok, want2, counts, host_ms)
    assert bool(used) == (skew == "mxu") and differing == {1: 0, 8: 0, 20: 0}
    assert sorted(sweep) == list(counts) and all(v["ms"] > 0 and v["sigs_per_s"] > 0 for v in sweep.values())
    assert CC.launches == before  # the plain version launches nothing

    def flipped(n):
        bits = launch(n).clone()
        if n > 12:
            bits[12] = ~bits[12]
        return bits

    _, differing = cs.sweep_vs(flipped, ref, pre_ok, want2, counts, lambda n: 1.0)
    assert differing[1] == differing[8] == 0 and differing[20] >= 1


def test_comb_mxu_sweep_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 7m's launch-size sweep at a small size: the chain under
    ``mxu`` held at each count against the chain under ``pad`` on the same
    lanes (``comb.cu``'s stand-in) and the expected verdicts."""
    _sweep_rehearsal(signers, monkeypatch, "chain", {"multiply": "pad"})


def test_comb_tree_sweep_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 7's tree sweep at a small size: the tree under ``pad`` held
    at each count against the chain under ``pad`` on the same lanes
    (``comb.cu``'s stand-in) and the expected verdicts."""
    _sweep_rehearsal(signers, monkeypatch, "tree", {"impl": "chain", "multiply": "pad"}, skew="pad")


def test_comb_tree_mxu_sweep_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 7tm's launch-size sweep at a small size: the tree under
    ``mxu`` held at each count against the chain under ``mxu`` on the same
    lanes (``comb_mxu.cu``'s stand-in) and the expected verdicts."""
    _sweep_rehearsal(signers, monkeypatch, "tree", {"impl": "chain", "multiply": "mxu"})


def test_tree_service_phase_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 8t at a small size: the service with signers under the tree
    switch sends every item down the comb path's tree (its plain version on
    the CPU, which launches nothing), with every bitmap as expected."""
    from mochi_tpu_torch.crypto import comb

    traffic = cs.make_traffic(19, signers, clients=3, requests=2, grants=5)
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")
    seen = []
    real = comb.verify_comb_prepared
    monkeypatch.setattr(comb, "verify_comb_prepared", lambda *a, impl=None, multiply=None: seen.append(impl) or real(
        *a, impl=impl, multiply=multiply))
    cs._zero_counts()
    svc = asyncio.run(asyncio.wait_for(
        cs.drive_service(traffic, "cpu", b"k" * 32, signers=[s.pub for s in signers]), 240))
    logs = cs._read_counts(svc)
    assert svc["requests"] == 6 and svc["items"] == 30 and svc["mismatched_requests"] == 0
    assert svc["routing"]["comb_items"] == 30 and svc["routing"]["ladder_items"] == 0
    assert svc["fallback_batches"] == svc["crossover_batches"] == svc["remote_fallbacks"] == 0
    assert svc["comb_launches"] == {"chain": 0, "tree": 0, "chain_mxu": 0, "tree_mxu": 0} and svc["verify_launches"] == 0
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert seen and set(seen) == {"tree"}


def test_mxu_service_phase_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 5m at a small size: the service with no signers under
    ``MOCHI_SKEW_IMPL=mxu`` sends every item down the general path, whose
    plain version multiplies through ``_mul_mxu`` on the CPU (launching
    nothing), every bitmap as expected; the phase's check passes it once a
    card's mxu launches are not asked for, and flags what it must."""
    from mochi_tpu_torch.crypto import field as F

    traffic = cs.make_traffic(29, signers, clients=3, requests=2, grants=5)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    cs._zero_counts()
    svc = asyncio.run(asyncio.wait_for(cs.drive_service(traffic, "cpu", b"k" * 32), 240))
    logs = cs._read_counts(svc)
    assert svc["requests"] == 6 and svc["items"] == svc["device_items"] == 30
    assert svc["verify_mxu_launches"] == svc["verify_launches"] == 0 and used
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert cs.mxu_service_problems(svc, launched=False) == []
    assert cs.mxu_service_problems(svc) == ["the mxu kernel was never launched"]
    bad = dict(svc, mismatched_requests=1, verify_launches=2, verify_mxu_launches=24)
    assert len(cs.mxu_service_problems(bad)) == 2
    a, b = cs.mul_operands(1, 128)
    assert a.shape == b.shape == (17, 128) and (a[:, :64] == F.LOOSE).all() and (b[:, 32:96] == F.LOOSE).all()
    assert torch.equal(CV.fe_mul_mxu(torch.from_numpy(a), torch.from_numpy(b)).long(),
                       F.mul(torch.from_numpy(a).long(), torch.from_numpy(b).long()))


def test_comb_mxu_service_phase_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 8m at a small size: the service with signers under
    ``MOCHI_SKEW_IMPL=mxu`` sends every item down the comb path, whose plain
    chain multiplies through ``_mul_mxu`` on the CPU (launching nothing),
    every bitmap as expected, and the stats name the mxu multiply; the
    phase's check passes it once a card's launches are not asked for, and
    flags what it must."""
    from mochi_tpu_torch.crypto import field as F

    traffic = cs.make_traffic(31, signers, clients=3, requests=2, grants=5)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    cs._zero_counts()
    svc = asyncio.run(asyncio.wait_for(
        cs.drive_service(traffic, "cpu", b"k" * 32, signers=[s.pub for s in signers]), 240))
    logs = cs._read_counts(svc)
    assert svc["requests"] == 6 and svc["items"] == svc["device_items"] == 30 and used
    assert svc["routing"]["comb_items"] == 30 and svc["stats_multiply"] == {"general": "mxu", "comb": "mxu"}
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert cs.comb_mxu_service_problems(svc, launched=False) == []
    assert cs.comb_mxu_service_problems(svc) == ["the chain under mxu was never launched"]
    bad = dict(svc, comb_launches=dict(svc["comb_launches"], chain=3, chain_mxu=21),
               stats_multiply={"general": "mxu", "comb": "pad"}, fallback_batches=1)
    assert len(cs.comb_mxu_service_problems(bad)) == 3


def test_comb_tree_mxu_service_phase_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 8tm at a small size: the service with signers under both
    switches sends every item down the comb path, whose plain tree
    multiplies through ``_mul_mxu`` on the CPU (launching nothing), every
    bitmap as expected, and the stats name the tree and the mxu multiply;
    the phase's check passes it once a card's launches are not asked for,
    and flags what it must."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import field as F

    traffic = cs.make_traffic(37, signers, clients=3, requests=2, grants=5)
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    seen, used = [], []
    real, real_mul = comb.verify_comb_prepared, F._mul_mxu
    monkeypatch.setattr(comb, "verify_comb_prepared", lambda *a, impl=None, multiply=None: seen.append(
        (impl, multiply)) or real(*a, impl=impl, multiply=multiply))
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real_mul(a, b))
    cs._zero_counts()
    svc = asyncio.run(asyncio.wait_for(
        cs.drive_service(traffic, "cpu", b"k" * 32, signers=[s.pub for s in signers]), 240))
    logs = cs._read_counts(svc)
    assert svc["requests"] == 6 and svc["items"] == svc["device_items"] == 30 and used
    assert seen and set(seen) == {("tree", "mxu")}
    assert svc["routing"]["comb_items"] == 30 and svc["stats_multiply"] == {"general": "mxu", "comb": "mxu"}
    assert svc["stats_comb_impl"] == "tree"
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert cs.comb_mxu_service_problems(svc, launched=False, kernel="tree_mxu") == []
    assert cs.comb_mxu_service_problems(svc, kernel="tree_mxu") == ["the tree under mxu was never launched"]
    good = dict(svc, comb_launches=dict(svc["comb_launches"], tree_mxu=24))
    assert cs.comb_mxu_service_problems(good, kernel="tree_mxu") == []
    # the chain under mxu (8m's kernel), or stats that name the chain, are flagged here
    assert len(cs.comb_mxu_service_problems(good, kernel="chain_mxu")) == 3
    bad = dict(good, comb_launches=dict(good["comb_launches"], chain_mxu=2), stats_comb_impl="chain",
               verify_mxu_launches=1)
    assert len(cs.comb_mxu_service_problems(bad, kernel="tree_mxu")) == 2


def test_cluster_drive_counts_on_cpu():
    from mochi_tpu_torch.crypto import cuda_comb as CC

    CV.launches.update(pad=0, mxu=0)
    CC.launches.update(chain=0, tree=0, chain_mxu=0, tree_mxu=0)
    BV.reset_counts()
    out = asyncio.run(asyncio.wait_for(cs.drive_cluster("cpu", 7, 2, 2), 300))
    assert out["quorum"] == 5 and out["writes"] == out["acked"] == out["read_back"] == 4
    assert out["fallback_batches"] == out["crossover_batches"] == 0
    assert out["registered_signers"] == 7 and out["txn_per_s"] > 0
    routed = BV.comb_routing_counts()
    assert routed["comb_items"] >= 4 * 5 and BV.comb_dispatch_count() > 0
    assert CV.launches == {"pad": 0, "mxu": 0} and CC.launches == {"chain": 0, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}  # the plain versions on the CPU launch no kernel


# ------------------------------------------- multi-device phases (10-12)


def test_quorum_stream_forges_a_quarter_of_the_certificates(signers):
    traffic = cs.make_traffic(21, signers, clients=4, requests=2, grants=5, forge_rate=0.0)
    items, want, gids, forged = cs.quorum_stream(traffic, 3, 5)
    flat, flat_want = cs.traffic_waves(traffic)
    assert len(items) == 40 and gids.tolist() == [c for c in range(8) for _ in range(5)]
    assert len(forged) == 2 and all(flat_want)
    changed = [k for k in range(40) if items[k] != flat[k]]
    assert 2 <= len(changed) <= 6 and {k // 5 for k in changed} == set(forged)
    assert [keys.verify(i.public_key, i.message, i.signature) for i in items] == want
    assert [k for k, w in enumerate(want) if not w] == changed
    counts = cs.quorum_oracle(want, gids, 8)
    assert [c for c in range(8) if counts[c] == 5] == [c for c in range(8) if c not in forged]


def test_north_star_votes_and_host_rejected_items(signers):
    items, want, gids = cs.north_star_votes(signers, slots=2, voters=6, forged_votes=3)
    assert gids.tolist() == [0] * 6 + [1] * 6 and want == [True] * 6 + [False] * 3 + [True] * 3
    assert [keys.verify(i.public_key, i.message, i.signature) for i in items] == want
    assert cs.quorum_oracle(want, gids, 2).tolist() == [6, 3]
    bad = cs.host_rejected_items(signers[0])
    assert [keys.verify(i.public_key, i.message, i.signature) for i in bad] == [False, False]
    prepared = BV.prepare_packed(bad)
    assert prepared[6].tolist() == [False, False]
    assert CV.verify_prepared_packed(*CV.from_reference_prepared(prepared, "cpu")).tolist() == [True, True]


def test_quorum_phase_rehearsal_on_cpu(signers, monkeypatch):
    """Phase 11 at a small size: its cards become CPU slices, its north-star
    leg shrinks, and the CUDA timers stand aside."""
    import mochi_tpu_torch.parallel as P

    real_make_mesh = P.make_mesh
    monkeypatch.setattr(P, "make_mesh", lambda devices=None: real_make_mesh(
        devices=["cpu"] if devices is None else ["cpu"] * len(devices)))
    monkeypatch.setattr(cs, "NS_SLOTS", 2)
    monkeypatch.setattr(cs, "NS_VOTERS", 6)
    monkeypatch.setattr(cs, "NS_FORGED", 3)
    monkeypatch.setattr(cs, "_graph_ms", lambda fn, calls: 0.0)
    monkeypatch.setattr(cs, "_ms_per_call", lambda fn, calls: 0.0)
    traffic = cs.make_traffic(23, signers, clients=2, requests=2, grants=5, forge_rate=0.0)
    res = {}
    out = cs.quorum_phase(7, traffic, signers, torch.device("cpu"), res)
    assert res["quorum"] is out and out["certificates"] == 4 and out["lanes"] == 22
    assert out["forged_certificates"] == 1 and out["host_rejected_lanes_device_verdict"] == [True, True]
    assert out["legs"]["north star / two slices of cuda:0"]["counts"] == [6, 3]
    assert out["legs"]["certificate stream / all cards"]["committed"] == 3
    assert out["tally"]["lane_counts_checked"] == [6, 11, 12, 22]
    assert out["tally"]["max_abs_err"] == 0 and out["commit"]["max_abs_err"] == 0
    assert out["launches"]["tally"] == out["launches"]["commit"] == 0  # the plain versions launch nothing
    assert out["launches"]["fused_tally_commit"] == 0
    assert out["fused"]["max_abs_err"] == 0 and out["fused"]["lane_counts_checked"] == [6, 11, 12, 22]
    assert out["tally"]["cases_max_abs_err"] == dict.fromkeys(("wrap_and_drop_ids", "one_slot", "offset_1",
                                                               "no_lane"), 0)


def test_tally_check_raises_on_a_wrong_count(monkeypatch):
    from mochi_tpu_torch.parallel import cuda_tally as CT

    b = torch.ones(6, dtype=torch.bool)
    ids = torch.tensor([0, 1, 2, -1, 5, 2], dtype=torch.int32)
    assert cs.check_tally_vs_plain(b, b, ids, 3) == 0
    monkeypatch.setattr(CT, "quorum_tally", lambda *a: torch.tensor([1, 1, 4], dtype=torch.int32))
    with pytest.raises(AssertionError, match="max abs error 1"):
        cs.check_tally_vs_plain(b, b, ids, 3)


def test_fused_check_raises_on_a_wrong_commit(monkeypatch):
    from mochi_tpu_torch.parallel import cuda_tally as CT

    b = torch.ones(6, dtype=torch.bool)
    ids = torch.tensor([0, 1, 2, -1, 5, 2], dtype=torch.int32)
    assert cs.check_fused_vs_plain(b, b, ids, 3, 2) == 0
    assert cs.check_fused_vs_plain(b[:0], b[:0], ids[:0], 3, 0) == 0
    monkeypatch.setattr(CT, "quorum_tally_commit", lambda *a: (torch.tensor([1, 1, 3], dtype=torch.int32),
                                                               torch.tensor([False, False, False])))
    with pytest.raises(AssertionError, match="max abs error 1"):
        cs.check_fused_vs_plain(b, b, ids, 3, 2)


def test_sharded_service_drive_counts_on_cpu(signers):
    from mochi_tpu_torch.verifier.cuda import ShardedCudaBatchVerifier

    traffic = cs.make_traffic(17, signers, clients=3, requests=2, grants=5)
    pubs = [s.pub for s in signers]
    BV.reset_counts()
    svc = asyncio.run(asyncio.wait_for(cs.drive_service(
        traffic, "cpu", b"k" * 32,
        make_verifier=lambda: ShardedCudaBatchVerifier(devices=["cpu", "cpu"], signers=pubs)), 240))
    assert svc["requests"] == 6 and svc["items"] == 30 and svc["mismatched_requests"] == 0
    assert BV.comb_routing_counts()["comb_items"] == 30 and BV.device_item_count() == 30
    assert svc["fallback_batches"] == svc["crossover_batches"] == svc["remote_fallbacks"] == 0


def test_multihost_leg_on_cpu_with_gloo():
    recs = cs.run_multihost("gloo", 1, lanes=8, timeout_s=240)
    assert cs.check_multihost(recs, "gloo") == [2, 2, 2]
    assert cs.multihost_expected(8, 4) == [8, 8, 8]
    wrong = [dict(recs[0], counts=[2, 2, 1])]
    with pytest.raises(AssertionError, match="expected counts"):
        cs.check_multihost(wrong, "gloo")


def test_cluster_mxu_phase_check_flags_what_it_must():
    """Phase 9m's check: a run with only the chain under mxu and the mxu
    general kernel passes; a pad launch of either kernel, a tree launch, no
    grant on the comb path or a fallback is flagged."""
    good = {"comb_launches": {"chain": 0, "tree": 0, "chain_mxu": 9}, "verify_launches": 0,
            "verify_mxu_launches": 12, "routing": {"comb_items": 600}, "fallback_batches": 0,
            "crossover_batches": 0}
    assert cs.cluster_mxu_problems(good) == []
    assert cs.cluster_mxu_problems(dict(good, comb_launches={"chain": 0, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}),
                                   launched=False) == []
    assert len(cs.cluster_mxu_problems(dict(good, comb_launches={"chain": 0, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}))) == 1
    assert len(cs.cluster_mxu_problems(dict(good, verify_launches=1))) == 1
    assert len(cs.cluster_mxu_problems(dict(good, comb_launches={"chain": 2, "tree": 1, "chain_mxu": 9}))) == 1
    assert len(cs.cluster_mxu_problems(dict(good, routing={"comb_items": 0}, crossover_batches=1))) == 2


def test_cluster_tree_mxu_phase_check_flags_what_it_must():
    """Phase 9tm's check: a run with only the tree under mxu and the mxu
    general kernel passes; a launch of the chain under mxu (9m's kernel),
    of ``comb_tree.cu`` or of ``verify.cu``, no grant on the comb path or a
    fallback is flagged."""
    comb0 = {"chain": 0, "tree": 0, "chain_mxu": 0, "tree_mxu": 0}
    good = {"comb_launches": dict(comb0, tree_mxu=7), "verify_launches": 0, "verify_mxu_launches": 12,
            "routing": {"comb_items": 600}, "fallback_batches": 0, "crossover_batches": 0}
    assert cs.cluster_mxu_problems(good, kernel="tree_mxu") == []
    assert cs.cluster_mxu_problems(dict(good, comb_launches=comb0), launched=False, kernel="tree_mxu") == []
    assert cs.cluster_mxu_problems(dict(good, comb_launches=comb0), kernel="tree_mxu") == [
        f"the tree under mxu carried nothing: {comb0}"]
    assert len(cs.cluster_mxu_problems(good)) == 2  # 9m's check: no chain under mxu, a tree launch
    for other in ("chain", "tree", "chain_mxu"):
        assert len(cs.cluster_mxu_problems(dict(good, comb_launches=dict(good["comb_launches"], **{other: 1})),
                                           kernel="tree_mxu")) == 1
    assert len(cs.cluster_mxu_problems(dict(good, verify_launches=1), kernel="tree_mxu")) == 1
    assert len(cs.cluster_mxu_problems(dict(good, routing={"comb_items": 0}, fallback_batches=1),
                                       kernel="tree_mxu")) == 2


def test_cluster_mxu_phase_rehearsal_on_cpu(monkeypatch):
    """Phase 9m at a small size: the cluster under ``MOCHI_SKEW_IMPL=mxu``
    commits and reads back every write, its grants on the comb path's plain
    chain multiplying through ``_mul_mxu`` (no launch on the CPU), and the
    phase's check passes it once a card's launches are not asked for.  The
    SDK clients get a request budget sized to the plain versions on a
    loaded host, as tests/test_torch_cluster.py gives its clients."""
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    real_client = VirtualCluster.client
    monkeypatch.setattr(VirtualCluster, "client", lambda self, **kw: real_client(self, **{"timeout_s": 240, **kw}))
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    cs._zero_counts()
    out = asyncio.run(asyncio.wait_for(cs.drive_cluster("cpu", 4, 2, 2), 300))
    logs = cs._read_counts(out)
    assert out["quorum"] == 3 and out["writes"] == out["acked"] == out["read_back"] == 4 and used
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert cs.cluster_mxu_problems(out, launched=False) == []
    assert cs.cluster_mxu_problems(out) == [f"the chain under mxu carried nothing: {out['comb_launches']}"]


def test_cluster_tree_mxu_phase_rehearsal_on_cpu(monkeypatch):
    """Phase 9tm at a small size: the cluster under both switches commits
    and reads back every write, its grants on the comb path's plain tree
    multiplying through ``_mul_mxu`` (no launch on the CPU), and the phase's
    check passes it once a card's launches are not asked for.  The SDK
    clients get the request budget of the 9m rehearsal."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    real_client = VirtualCluster.client
    monkeypatch.setattr(VirtualCluster, "client", lambda self, **kw: real_client(self, **{"timeout_s": 240, **kw}))
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    seen = []
    real = comb.verify_comb_prepared
    monkeypatch.setattr(comb, "verify_comb_prepared", lambda *a, impl=None, multiply=None: seen.append(
        (impl, multiply)) or real(*a, impl=impl, multiply=multiply))
    cs._zero_counts()
    out = asyncio.run(asyncio.wait_for(cs.drive_cluster("cpu", 4, 2, 2), 300))
    logs = cs._read_counts(out)
    assert out["quorum"] == 3 and out["writes"] == out["acked"] == out["read_back"] == 4
    assert seen and set(seen) == {("tree", "mxu")}
    assert logs == ({"pad": [], "mxu": []}, {"chain": [], "tree": [], "chain_mxu": [], "tree_mxu": []})
    assert cs.cluster_mxu_problems(out, launched=False, kernel="tree_mxu") == []
    assert cs.cluster_mxu_problems(out, kernel="tree_mxu") == [
        f"the tree under mxu carried nothing: {out['comb_launches']}"]


# ------------------------------------------- verified recovery (13, 13p)


def test_host_prepare_times_native_and_pure_agree(signers):
    """Phase 4's host prepare record: the native and the pure prepare give
    the same arrays, each is timed, and native_status() rides along."""
    flat, _ = cs.traffic_waves(cs.make_traffic(5, signers, clients=4, requests=2, grants=5))
    out = cs.host_prepare_times(flat, repeats=2)
    assert out["items"] == len(flat) and out["python_h"]
    assert out["native_status"]["_hbatch"]["built"] and out["native_equals_pure"]
    assert out["native_us_per_item"] > 0 and out["pure_us_per_item"] > 0


def test_host_prepare_times_fail_when_python_h_is_there_but_the_build_is_not(signers, monkeypatch):
    from mochi_tpu_torch import native

    broken = {"_mcode": {"built": False, "error": "cc exit 1"}, "_hbatch": {"built": False, "error": "cc exit 1"}}
    monkeypatch.setattr(native, "native_status", lambda: broken)
    with pytest.raises(AssertionError, match="Python.h is present"):
        cs.host_prepare_times([], repeats=1)


def _recovery_record(**over):
    span = {"comb_launches": {"chain": 2, "tree": 0, "chain_mxu": 0, "tree_mxu": 0},
            "routing": {"comb_items": 129}}
    honest = dict(copy.deepcopy(span), server_id="server-1", planted=None, convicted=0, convictions=[], missing=[])
    planted = {"seq": 7, "key": "rec-1-2"}
    tampered = dict(copy.deepcopy(span), server_id="server-3", planted=planted, convicted=2, missing=["rec-1-2"],
                    missing_after_resync=[],
                    convictions=[{"seq": 7, "key": "rec-1-2", "reason": "1 grant signature(s) failed re-verification"},
                                 {"seq": 7, "key": "rec-1-2", "reason": "replayed commit did not advance state"}])
    rec = {"recoveries": [honest, dict(copy.deepcopy(honest), server_id="server-2"), tampered], "read_back_bad": [],
           "fallback_batches": 0}
    rec.update(over)
    return rec


def test_recovery_check_flags_what_it_must():
    """Phase 13's check: three recoveries with comb launches, the planted
    entry alone convicted and healed by the resync, pass; a recovery with
    no comb launch, a conviction on an honest disk, a conviction of
    another entry or none of the planted one, a missing value and a bad
    read-back are each flagged."""
    good = _recovery_record()
    assert cs.recovery_problems(good) == []
    no_launch = copy.deepcopy(good)
    no_launch["recoveries"][0]["comb_launches"]["chain"] = 0
    assert len(cs.recovery_problems(no_launch)) == 1 and cs.recovery_problems(no_launch, launched=False) == []
    honest_convicted = copy.deepcopy(good)
    honest_convicted["recoveries"][1]["convicted"] = 1
    assert len(cs.recovery_problems(honest_convicted)) == 1
    other = copy.deepcopy(good)
    other["recoveries"][2]["convictions"].append({"seq": 3, "key": "rec-0-0", "reason": "reordered"})
    assert len(cs.recovery_problems(other)) == 1
    unsigned = copy.deepcopy(good)
    unsigned["recoveries"][2]["convictions"] = unsigned["recoveries"][2]["convictions"][1:]
    assert len(cs.recovery_problems(unsigned)) == 1
    unhealed = copy.deepcopy(good)
    unhealed["recoveries"][2]["missing_after_resync"] = ["rec-1-2"]
    assert len(cs.recovery_problems(unhealed)) == 1
    assert len(cs.recovery_problems(dict(good, read_back_bad=["rec-0-1"]))) == 1


def test_recovery_phase_rehearsal_on_cpu(tmp_path):
    """Phase 13 at a small size (4 replicas, 2 clients x 2 PUTs): three
    recoveries, each re-verifying every stored grant on the comb path's
    plain version (no launch on the CPU), the planted forgery convicted
    alone and healed by the resync, every key read back."""
    spans = cs.Spans("cpu")
    rec = asyncio.run(asyncio.wait_for(cs.drive_recovery("cpu", 4, 2, 2, str(tmp_path), spans), 300))
    assert rec["acked"] == 4 and rec["quorum"] == 3 and rec["read_back_bad"] == []
    assert [r["server_id"] for r in rec["recoveries"]] == ["server-1", "server-2", "server-3"]
    for r in rec["recoveries"]:
        assert r["routing"]["comb_items"] == r["device_items"] == 4 * 3, r
        assert "device" not in r and r["grants_per_s"] > 0
    assert [r["convicted"] for r in rec["recoveries"]] == [0, 0, 2]
    assert rec["recoveries"][2]["missing"] == [rec["recoveries"][2]["planted"]["key"]]
    assert cs.recovery_problems(rec, launched=False) == []
    problems = cs.recovery_problems(rec)  # a card's launches asked for: none on the CPU
    assert len(problems) == 3 and all("no comb launch" in p for p in problems)


def test_recovery_paged_phase_rehearsal_on_cpu(tmp_path):
    """Phase 13p at a small size: the compaction re-verifies every
    surviving entry's grants, the boot audit every paged entry's, nothing
    is convicted, every second-generation value is in the restarted store
    and reads back; the environment is left as it was."""
    env0 = dict(os.environ)
    spans = cs.Spans("cpu")
    rec = asyncio.run(asyncio.wait_for(cs.drive_recovery_paged("cpu", 4, 2, 2, str(tmp_path), spans), 300))
    assert dict(os.environ) == env0
    comp, audit = rec["compaction"], rec["audit"]
    assert comp["result"] == {"pages": 2, "rewritten": 4} and comp["pages_after"] == 1 and comp["debt"] == 0
    assert comp["reverified"] == comp["device_items"] == 4 * 3
    assert audit["audits"] == 1 and audit["audited_entries"] == 4 and audit["device_items"] == 4 * 3
    assert audit["missing"] == [] and rec["read_back_bad"] == []
    assert cs.recovery_paged_problems(rec, launched=False) == []
    assert len(cs.recovery_paged_problems(rec)) == 2
    bad = copy.deepcopy(rec)
    bad["audit"]["pages_convicted"] = 1
    bad["compaction"]["reverified"] = 3
    assert len(cs.recovery_paged_problems(bad, launched=False)) == 2


def _card(holders, smi_ours: bool = False, parent: bool = True, pids=None):
    """A card view: ``holders`` have the device node open, and nvidia-smi
    lists one row a holder (and the parent), with pids ours or all 1."""
    pids = pids or {}
    rows = [[pids.get(name, 1) if smi_ours else 1, "3048 MiB"] for name in holders] + [[4242 if smi_ours else 1,
                                                                                          "3048 MiB"]] * parent
    return {"compute_apps": rows, "smi_pids_are_ours": smi_ours, "parent_holds_card": parent,
            "holds_card": {name: name in holders for name in pids}}


def _process_record(**over):
    """A phase-14 record that passes: 4 children, 44 acked, none lost,
    every child a CudaBatchVerifier with 64 signers and comb dispatches
    before the kill and after the restart, each holding the card."""
    child = {"pid": 0, "replicas": 16, "types": ["CudaBatchVerifier"], "registered_signers": [64],
             "dispatches": 16, "comb_items": 30272, "ladder_items": 0, "fallback_batches": 0}
    names = [f"proc-{i}" for i in range(4)]
    before, after = {n: 10 + i for i, n in enumerate(names)}, {n: 20 + i for i, n in enumerate(names)}
    rec = {"replicas": 64, "acked": 44, "min_acked": 32, "lost": 0, "lost_keys": [],
           "status": {phase: {n: dict(copy.deepcopy(child), pid=pids[n]) for n in names}
                      for phase, pids in (("before_kill", before), ("after_restart", after))},
           "pids_before_kill": before, "pids_after_restart": after,
           "card_before_kill": _card(names, pids=before), "card_after_restart": _card(names, pids=after)}
    rec.update(over)
    return rec


def test_process_phase_check_flags_what_it_must():
    """Phase 14's check: the passing record passes (nvidia-smi's pids ours
    or not); a lost write, too few acked writes, a child without comb
    dispatches (before the kill or after the restart), a child that is not
    a CudaBatchVerifier or lacks the signers, and a child that does not hold
    the card (by its open device node, or missing from nvidia-smi's rows)
    are each flagged; on the CPU only the writes are held."""
    good = _process_record()
    assert cs.process_problems(good) == []
    ours = _process_record()
    for phase in ("before_kill", "after_restart"):
        ours[f"card_{phase}"] = _card(sorted(ours[f"pids_{phase}"]), smi_ours=True, pids=ours[f"pids_{phase}"])
    assert cs.process_problems(ours) == []
    lost = _process_record(lost=1, lost_keys=["p14-0-3"])
    assert len(cs.process_problems(lost)) == 1 and len(cs.process_problems(lost, on_card=False)) == 1
    assert len(cs.process_problems(_process_record(acked=31))) == 1
    for phase in ("before_kill", "after_restart"):
        idle = copy.deepcopy(good)
        idle["status"][phase]["proc-2"]["dispatches"] = 0
        assert len(cs.process_problems(idle)) == 1 and cs.process_problems(idle, on_card=False) == []
    cpu = copy.deepcopy(good)
    cpu["status"]["after_restart"]["proc-1"]["types"] = ["CpuVerifier"]
    assert len(cs.process_problems(cpu)) == 1
    unsigned = copy.deepcopy(good)
    unsigned["status"]["before_kill"]["proc-0"]["registered_signers"] = [0]
    assert len(cs.process_problems(unsigned)) == 1
    no_fd = copy.deepcopy(good)
    no_fd["card_after_restart"]["holds_card"]["proc-3"] = False
    assert len(cs.process_problems(no_fd)) == 1
    short = copy.deepcopy(good)
    short["card_before_kill"]["compute_apps"].pop()
    assert len(cs.process_problems(short)) == 1
    unlisted = copy.deepcopy(ours)
    unlisted["card_before_kill"]["compute_apps"][0][0] = 99999
    assert len(cs.process_problems(unlisted)) == 1


def _service_record(**over):
    """A phase-14s record that passes: every replica child a RemoteVerifier
    under the coalescer without fallbacks, the service with comb
    dispatches, and the service alone holding the card."""
    child = {"pid": 0, "replicas": 16, "types": ["CoalescingVerifier/RemoteVerifier"],
             "registered_signers": [None], "dispatches": 0, "comb_items": 0, "ladder_items": 0,
             "fallback_batches": 0}
    pids = {f"proc-{i}": 30 + i for i in range(4)}
    rec = {"read_back_bad": [], "replica_status": {n: dict(copy.deepcopy(child), pid=p) for n, p in pids.items()},
           "service": {"types": ["CachingVerifier", "CudaBatchVerifier"], "dispatches": 32, "comb_items": 1376},
           "pids": pids, "service_pid": 29,
           "card": _card(["verifier-service"], pids=dict(pids, **{"verifier-service": 29}))}
    rec.update(over)
    return rec


def test_process_service_phase_check_flags_what_it_must():
    """Phase 14s's check: the passing record passes; a key that does not
    read back, a replica with a local fallback, a replica not on the
    service, a service without comb dispatches, and a replica child that
    holds the card (by its device node, by an extra nvidia-smi row, or by
    its pid in nvidia-smi's list) are each flagged."""
    good = _service_record()
    assert cs.process_service_problems(good) == []
    assert len(cs.process_service_problems(_service_record(read_back_bad=["p14s-0-1"]))) == 1
    fallback = copy.deepcopy(good)
    fallback["replica_status"]["proc-2"]["fallback_batches"] = 1
    assert len(cs.process_service_problems(fallback)) == 1
    assert len(cs.process_service_problems(fallback, on_card=False)) == 1
    inline = copy.deepcopy(good)
    inline["replica_status"]["proc-0"]["types"] = ["CpuVerifier"]
    assert len(cs.process_service_problems(inline)) == 1
    idle = copy.deepcopy(good)
    idle["service"]["dispatches"] = 0
    assert len(cs.process_service_problems(idle)) == 1 and cs.process_service_problems(idle, on_card=False) == []
    held = copy.deepcopy(good)
    held["card"]["holds_card"]["proc-1"] = True
    assert len(cs.process_service_problems(held)) == 1
    extra = copy.deepcopy(good)
    extra["card"]["compute_apps"].append([1, "3048 MiB"])
    assert len(cs.process_service_problems(extra)) == 1
    pids = dict(good["pids"], **{"verifier-service": 29})
    listed = copy.deepcopy(good)
    listed["card"] = _card(["verifier-service", "proc-3"], smi_ours=True, pids=pids)
    listed["card"]["holds_card"]["proc-3"] = False  # seen by nvidia-smi alone
    assert len(cs.process_service_problems(listed)) == 1


def test_process_phases_rehearsal_on_cpu():
    """Phases 14 and 14s at a small size on the CPU (4 replicas in 2
    processes, ``--verifier cpu`` and a ``--backend cpu`` sidecar): the
    SIGKILL of every process loses no acked write, every key reads back,
    every replica's admin shell answers for it, and the checks pass but for
    the card's parts."""
    rec = asyncio.run(asyncio.wait_for(cs.drive_process_cluster("cpu", 4, 2, 2, 6, ready_timeout_s=120,
                                                                timeout_s=120), 240))
    assert rec["acked"] >= 6 and rec["lost"] == 0 and rec["read_back"] == rec["acked"]
    assert sorted(rec["restart_to_ready_s"]) == ["proc-0", "proc-1"]
    assert rec["pids_before_kill"] != rec["pids_after_restart"]
    for phase in ("before_kill", "after_restart"):
        assert {ch["replicas"] for ch in rec["status"][phase].values()} == {2}
        assert {tuple(ch["types"]) for ch in rec["status"][phase].values()} == {("CpuVerifier",)}
    assert cs.process_problems(rec, on_card=False) == []
    assert cs.process_problems(rec)  # no card here: the card's checks fail
    svc = asyncio.run(asyncio.wait_for(cs.drive_process_service("cpu", 4, 2, 2, 2, ready_timeout_s=120,
                                                                 timeout_s=120), 240))
    assert svc["acked"] == 4 and svc["read_back_bad"] == [] and svc["service"]["items"] > 0
    assert cs.process_service_problems(svc, on_card=False) == []
    assert cs.process_service_problems(svc)
