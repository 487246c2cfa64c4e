"""The port's deterministic scenario engine (``testing/scenario.py``) on the
CPU.

Ported from the JAX package's ``tests/test_scenario.py``, every run under
``verifier="cpu"`` (the process-backend cases too): spec-draw and run
determinism (same seed, byte-identical canonical record three times), one
small end-to-end scenario per fault family with its evidence, the engine and
fast-path dimensions, the violation arc (detect, flight dump, replay from
the seed, minimize), the nondeterminism regressions, and a smoke-scale soak
(``test_soak_slow_wide`` stays slow).  Added, against the JAX package: the
drawn spec's JSON and ``spec_hash`` for seeds 0-255 of every profile, and
``canonical_bytes()`` for virtual-backend seeds covering the Byzantine-
replica, Byzantine-client, crash-restart and partition families; and the
card posture (``verifier="cuda"``) refusing without a card, in
``run_scenario``, ``soak`` and the CLI.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os

import pytest

from mochi_tpu_torch.testing import scenario
from mochi_tpu_torch.testing.scenario import ScenarioSpec, draw_spec, run_scenario


def _spec(seed: int = 101, faults=(), **kw) -> ScenarioSpec:
    base = dict(
        seed=seed,
        profile="soak",
        backend="virtual",
        n_servers=4,
        rf=4,
        durable=False,
        net_seed=seed,
        rtt_ms=0.0,
        jitter_ms=0.0,
        drop=0.0,
        n_clients=1,
        keys_per_client=2,
        sweeps=1,
        value_bytes=16,
        timeout_s=2.0,
        op_attempts=6,
        faults=tuple(faults),
    )
    base.update(kw)
    return ScenarioSpec(**base)


# ---------------------------------------------------------------- determinism


def test_spec_draw_is_deterministic_and_json_roundtrips():
    for seed in (0, 3, 10, 41):
        a, b = draw_spec(seed), draw_spec(seed)
        assert a == b
        assert a.spec_hash() == b.spec_hash()
        rt = ScenarioSpec.from_json(a.to_json())
        assert rt == a and rt.spec_hash() == a.spec_hash()
    assert draw_spec(1).spec_hash() != draw_spec(2).spec_hash()


def test_same_seed_three_runs_byte_identical():
    records = [run_scenario(4, verifier="cpu").canonical_bytes() for _ in range(3)]
    assert records[0] == records[1] == records[2]
    doc = json.loads(records[0])
    assert doc["verdict"]["ok"] is True
    assert doc["acked"], "a run with no acked writes pins nothing"
    assert doc["schedule"][-1] == "final: invariants ok"


# ------------------------------------------------------- one leg per family


def test_family_crash_restart_durable_replays_wal():
    spec = _spec(
        201,
        durable=True,
        wal_fsync="off",
        faults=[{"family": "crash-restart", "victim": "server-1", "resync": True}],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("restart server-1 convicted=0" in s for s in res.steps), res.steps
    replays = res.info.get("replays")
    assert replays and replays[0]["entries"] > 0  # recovery actually replayed
    assert res.report["storage_replay_convictions"] == 0


def test_family_partition_heal_drops_and_recovers():
    spec = _spec(
        202,
        faults=[{"family": "partition-heal", "victim": "server-2", "hold_s": 0.2}],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("partition server-2" in s for s in res.steps)
    assert any("heal server-2" in s for s in res.steps)
    # the partition must have actually eaten frames, or the leg is a no-op
    assert res.info["netsim_totals"]["dropped"] > 0


def test_family_byzantine_replica_invariants_hold():
    spec = _spec(
        203,
        n_servers=5,
        faults=[{"family": "byz-replica", "sid": "server-1", "strategy": "equivocate"}],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert res.report["byzantine_replicas"] == ["server-1"]
    assert res.report["honest_replicas"] == [
        f"server-{i}" for i in range(5) if i != 1
    ]


def test_family_byzantine_client_attacks_and_invariants_hold():
    spec = _spec(
        204,
        faults=[
            {
                "family": "byz-client",
                "strategy": "withhold",
                "seed": 9,
                "ttl_ms": 300.0,
                "quota": 64,
                "wedge_seeds": 32,
            }
        ],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    stats = res.info["byz_client_stats"][0]
    assert stats["strategy"] == "withhold"
    assert stats["write1_sent"] > 0  # the adversary actually attacked


def test_family_load_spike_sheds_absorbed():
    spec = _spec(205, faults=[{"family": "load-spike", "burst": 8}])
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("spike acked=8" in s for s in res.steps)
    assert len(res.acked) >= 8 + 2 * 2  # spike keys + warm/leg bursts


def test_family_reconfig_converges_under_writes():
    spec = _spec(206, faults=[{"family": "reconfig", "rounds": 1}])
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("reconfig configstamp=2" in s for s in res.steps), res.steps


def test_family_sigkill_process_cluster_recovers_acked():
    spec = _spec(
        207,
        backend="process",
        durable=True,
        wal_fsync="group",
        keys_per_client=3,
        timeout_s=8.0,
        faults=[{"family": "sigkill", "victims": 1, "restart": True}],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("sigkill server-0" in s for s in res.steps)
    assert res.report["backend"] == "process"
    assert res.report["acked_writes"] == len(res.acked) > 0


def test_family_sigkill_paged_engine_recovers_acked():
    """The paged engine under the harshest family: SIGKILL a real
    process mid-load, restart, recover from page index + WAL tail — every
    acked write must read back (the engine dimension of generator v2)."""
    spec = _spec(
        208,
        backend="process",
        durable=True,
        wal_fsync="group",
        engine="paged",
        keys_per_client=3,
        timeout_s=8.0,
        faults=[{"family": "sigkill", "victims": 1, "restart": True}],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("sigkill server-0" in s for s in res.steps)
    assert any("engine=paged" in s for s in res.steps), res.steps
    assert res.report["acked_writes"] == len(res.acked) > 0


def test_engine_dimension_drawn_and_gated_on_durable():
    """Generator v2's engine stream: paged and wal both actually drawn,
    never a paged engine without durability, and the dimension rides a
    NEW stream (existing components' draws did not shift)."""
    engines = set()
    for seed in range(160):
        sp = draw_spec(seed)
        engines.add((sp.durable, sp.engine))
        if not sp.durable:
            assert sp.engine == "wal", seed
    assert (True, "paged") in engines
    assert (True, "wal") in engines


def test_fastpath_dimension_draws_both_postures():
    """Generator v3's fastpath stream: both verification postures actually
    drawn (the signed-everything wire keeps soak weight), riding a NEW
    stream so existing components' draws did not shift."""
    postures = {draw_spec(seed).fast_path for seed in range(32)}
    assert postures == {True, False}


def test_pinned_seed_fast_path_on_posture_lands_cluster_wide():
    """Posture pin, fast path ON (seed 4 draws fast_path=True —
    re-pin the seed if the draw ever shifts): the MAC'd-session wire runs
    a full scenario with invariants held, and the drawn posture actually
    landed on every replica and client."""
    spec = draw_spec(4)
    assert spec.fast_path is True, spec
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("fast_path=True" in s for s in res.steps), res.steps
    assert res.info["fast_path_postures"] == {
        "spec": True, "replicas": [True], "clients": [True],
    }


def test_pinned_seed_fast_path_off_posture_lands_cluster_wide():
    """Posture pin, fast path OFF (seed 11 draws
    fast_path=False): the pre-r18 signed-everything wire stays a
    first-class soak posture — spec-pinned, immune to MOCHI_FAST_PATH."""
    spec = draw_spec(11)
    assert spec.fast_path is False, spec
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("fast_path=False" in s for s in res.steps), res.steps
    assert res.info["fast_path_postures"] == {
        "spec": False, "replicas": [False], "clients": [False],
    }


# ------------------------------------------------------------- violation arc


def test_injected_violation_detect_dump_replay_minimize(tmp_path):
    flight = str(tmp_path / "flights")
    spec = dataclasses.replace(draw_spec(4), inject_violation=True)
    res = run_scenario(spec, flight_dir=flight, verifier="cpu")
    # detected
    assert not res.ok and res.violations
    assert "conflicting commits" in res.violations[0]
    # dumped, with the scenario seed stamped into the artifact
    dumps = res.info["flight_dumps"]
    assert dumps, "violation produced no flight dumps"
    with open(os.path.join(flight, dumps[0])) as fh:
        doc = json.load(fh)
    stamp = doc["run"]
    assert stamp["scenario_seed"] == 4
    assert stamp["injected"] is True
    # the dump's stamp regenerates the IDENTICAL spec (repro --seed / --dump)
    redrawn = dataclasses.replace(
        draw_spec(stamp["scenario_seed"], stamp["profile"]),
        inject_violation=stamp["injected"],
    )
    assert redrawn.spec_hash() == stamp["spec_hash"] == spec.spec_hash()
    # replays byte-identically from the seed alone
    again = run_scenario(redrawn, verifier="cpu")
    assert again.canonical_bytes() == res.canonical_bytes()
    # minimizes to a strictly smaller spec that still reproduces
    mini = scenario.minimize(spec, verifier="cpu")
    assert mini.spec.weight() < spec.weight()
    still = run_scenario(mini.spec, verifier="cpu")
    assert still.violations and "conflicting commits" in still.violations[0]
    repro = mini.reproducer()
    assert repro["spec_hash"] == mini.spec.spec_hash()


def test_report_carries_run_stamp():
    from mochi_tpu_torch.obs import trace as obs_trace
    from mochi_tpu_torch.testing.invariants import InvariantChecker

    try:
        obs_trace.set_run_stamp(scenario_seed=5, spec_hash="abcd")
        report = InvariantChecker([]).report()
        assert report["run"]["scenario_seed"] == 5
        assert report["run"]["spec_hash"] == "abcd"
    finally:
        obs_trace.clear_run_stamp()
    assert "run" not in InvariantChecker([]).report()


# ------------------------------------------------- nondeterminism regressions


def test_client_rng_seed_replays_draw_sequence():
    """The SDK's RNG (Write1 seed draws, backoff jitter) must ride the
    scenario seed: unseeded OS entropy here made two same-seed scenario
    runs diverge at the first seed collision/backoff (the fix)."""
    from mochi_tpu_torch.client.client import MochiDBClient
    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.crypto.keys import generate_keypair

    kps = {f"server-{i}": generate_keypair() for i in range(4)}
    cfg = ClusterConfig.build(
        {sid: "127.0.0.1:1" for sid in kps},
        rf=4,
        public_keys={sid: kp.public_key for sid, kp in kps.items()},
    )

    async def draws(rng_seed):
        client = MochiDBClient(config=cfg, rng_seed=rng_seed)
        try:
            return [client._rand.randrange(1000) for _ in range(8)]
        finally:
            await client.close()

    async def case():
        a = await draws(7)
        b = await draws(7)
        c = await draws(8)
        assert a == b, "same rng_seed must replay the same draw sequence"
        assert a != c
    asyncio.run(case())


def test_explorer_loop_keeps_asyncio_bookkeeping_fifo():
    """Regression for the shuffle-vs-sock_connect race: the ExplorerLoop
    reordering ``_sock_write_done`` after the task wakeup that creates
    the connection's transport raised 'File descriptor N is used by
    transport ...' inside loop callbacks and left connect watchers
    registered.  Drive real socket connects on several seeds and assert
    the loop's exception handler stays silent."""
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.schedule import ExplorerLoop
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    for seed in range(4):
        loop = ExplorerLoop(seed)
        asyncio.set_event_loop(loop)
        errors = []
        loop.set_exception_handler(
            lambda l, ctx: errors.append(
                f"{ctx.get('message')}: {ctx.get('exception')!r}"
            )
        )

        async def case():
            async with VirtualCluster(4, rf=4) as vc:
                client = vc.client(timeout_s=5.0)
                await client.execute_write_transaction(
                    TransactionBuilder().write("fifo-pin", b"v").build()
                )

        try:
            loop.run_until_complete(case())
        finally:
            asyncio.set_event_loop(None)
            loop.close()
        fd_errors = [e for e in errors if "File descriptor" in e]
        assert not fd_errors, (seed, fd_errors)


def test_silent_byzantine_plus_reconfig_converges_honest_only():
    """Soak-found composition bug: the reconfig leg waited for
    EVERY replica to learn the new configstamp, but a silent adversary
    never answers the config-resync traffic that would teach it — every
    silent+reconfig draw wedged at the 15 s convergence deadline.
    Convergence is only promised for honest replicas."""
    spec = _spec(
        208,
        n_servers=5,
        faults=[
            {"family": "byz-replica", "sid": "server-1", "strategy": "silent"},
            {"family": "reconfig", "rounds": 1},
        ],
    )
    res = run_scenario(spec, verifier="cpu")
    assert res.ok, (res.error, res.violations)
    assert any("reconfig configstamp=2" in s for s in res.steps), res.steps


def test_final_check_retries_transient_read_failure():
    """Soak-found verdict bug: ONE un-retried quorum read that
    timed out under host overload convicted 'acked write unreadable' —
    a tenancy artifact recorded as durability loss.  final_check now
    retries (the SDK's recovery machinery is part of the contract); a
    key that stays unreadable through the retries still convicts."""
    from mochi_tpu_torch.testing.invariants import InvariantChecker

    class FlakyClient:
        def __init__(self, fail_times: int):
            self.fail_times = fail_times
            self.calls = 0

        async def execute_read_transaction(self, txn):
            self.calls += 1
            if self.calls <= self.fail_times:
                raise TimeoutError("stalled responders")

            class Op:
                value = b"v"
                existed = True

            class Res:
                operations = [Op()]

            return Res()

    async def case():
        checker = InvariantChecker([])
        checker.record_ack("k", b"v")
        flaky = FlakyClient(fail_times=1)
        await checker.final_check(flaky)
        assert checker.ok, checker.violations  # one transient → recovered
        assert flaky.calls == 2

        checker2 = InvariantChecker([])
        checker2.record_ack("k", b"v")
        dead = FlakyClient(fail_times=99)
        await checker2.final_check(dead)
        assert not checker2.ok  # persistent unreadability still convicts
        assert "unreadable" in checker2.violations[0]

    asyncio.run(case())


# ---------------------------------------------------------------------- soak


def test_soak_smoke_eight_seeds():
    summary = scenario.soak(range(8), verifier="cpu")
    assert summary["seeds_run"] == 8
    assert summary["violations"] == 0, summary["failing_seeds"]
    assert summary["harness_errors"] == 0, summary["failing_seeds"]
    assert summary["acked_writes"] > 0
    # at least a few distinct families drawn even at smoke scale
    drawn = [f for f, n in summary["fault_family_draws"].items() if n > 0]
    assert len(drawn) >= 3, summary["fault_family_draws"]


@pytest.mark.slow
def test_soak_slow_wide():
    count = scenario.soak_seed_count(64)
    summary = scenario.soak(range(count), workers=2, verifier="cpu")
    assert summary["seeds_run"] == count
    assert summary["violations"] == 0, summary["failing_seeds"]
    assert summary["harness_errors"] == 0, summary["failing_seeds"]
    assert all(
        summary["fault_family_draws"].get(f, 0) > 0 for f in scenario.FAMILIES
    ), summary["fault_family_draws"]


# ------------------------------------------------ against the JAX package

# Seeds whose drawn specs (virtual backend) cover the Byzantine-replica
# (0: equivocate), Byzantine-client (7: seed-bias), durable crash-restart
# (3: paged engine) and partition-heal (62: with a durable crash-restart)
# families; chip_smoke.py's phase 15s runs the same seeds on the card.
FAMILY_SEEDS = (0, 7, 3, 62)


@pytest.mark.parametrize("profile", scenario.PROFILES)
def test_drawn_specs_equal_the_reference(profile):
    from mochi_tpu.testing import scenario as ref

    assert scenario.GENERATOR_VERSION == ref.GENERATOR_VERSION
    assert (scenario.PROFILES, scenario.FAMILIES) == (ref.PROFILES, ref.FAMILIES)
    assert scenario.BYZ_REPLICA_STRATEGIES == ref.BYZ_REPLICA_STRATEGIES
    assert scenario.BYZ_CLIENT_STRATEGIES == ref.BYZ_CLIENT_STRATEGIES
    for seed in range(256):
        ours, theirs = draw_spec(seed, profile), ref.draw_spec(seed, profile)
        assert ours.to_json() == theirs.to_json(), seed
        assert ours.spec_hash() == theirs.spec_hash(), seed
        assert ours.weight() == theirs.weight(), seed


def test_family_seeds_cover_the_families():
    drawn = [draw_spec(seed) for seed in FAMILY_SEEDS]
    assert all(sp.backend == "virtual" for sp in drawn)
    families = set().union(*(sp.fault_families() for sp in drawn))
    assert {"byz-replica", "byz-client", "crash-restart", "partition-heal"} <= families
    assert any(sp.durable for sp in drawn)


@pytest.mark.parametrize("seed", FAMILY_SEEDS)
def test_canonical_record_equals_the_reference(seed):
    """The port under the CPU verifier and the JAX package run the same
    seed to the same canonical record, byte for byte."""
    from mochi_tpu.testing import scenario as ref

    ours = run_scenario(seed, verifier="cpu")
    theirs = ref.run_scenario(seed)
    assert ours.ok, (ours.error, ours.violations)
    assert ours.canonical_bytes() == theirs.canonical_bytes()
    assert ours.info["verifier"] == {"posture": "cpu"}


def test_cuda_posture_refuses_without_a_card(monkeypatch, capsys):
    """``verifier="cuda"`` (the default) raises before anything boots where
    there is no card, in ``run_scenario``, ``soak`` and ``minimize``, and
    the CLI exits non-zero with the message; nothing falls back to the
    CPU.  An unknown posture is refused too."""
    import subprocess
    import sys
    import time

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.perf_counter()
    for call in (
        lambda: run_scenario(4),
        lambda: run_scenario(draw_spec(10)),  # the process backend too
        lambda: scenario.soak(range(2)),
        lambda: scenario.minimize(draw_spec(4)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert time.perf_counter() - t0 < 5.0, "refused only after booting"
    with pytest.raises(ValueError, match="unknown verifier"):
        run_scenario(4, verifier="tpu")
    assert scenario.main(["run", "--seed", "4"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert scenario.main(["spec", "--seed", "4"]) == 0  # drawing needs no card
    proc = subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.testing.scenario", "run", "--seed", "4"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode == 2 and not proc.stdout, (proc.returncode, proc.stdout)
    assert "no CUDA device" in proc.stderr, proc.stderr
