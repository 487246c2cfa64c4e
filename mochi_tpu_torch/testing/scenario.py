"""Deterministic whole-cluster scenario engine: one seed draws EVERYTHING.

The port owns every ingredient FoundationDB-style simulation testing needs —
seeded netsim conditioning (``netsim/``), a seeded deterministic event loop
(``testing/schedule.ExplorerLoop``), live Byzantine replicas
(``testing/byzantine``) and clients (``testing/byzantine_client``),
admission/overload (``server/admission``), durable restarts (``storage/``)
and the continuous safety ``InvariantChecker``.  This module composes them:
a single integer seed deterministically draws a full scenario —

* **topology** — replica count, rf/f, storage posture (in-memory or the
  durable engine with its fsync policy), and the backend (in-process
  ``VirtualCluster`` or, for SIGKILL legs, a real ``ProcessCluster``);
* **network shape** — a seeded ``NetSim`` mesh (RTT/jitter/drop) whose
  partition/heal/degrade ``LinkEvent``\\ s the engine fires at leg
  boundaries;
* **fault schedule** — an ordered list of legs drawn from the eight fault
  families (``FAMILIES``): crash-and-restart-with-state, partition+heal,
  uplink degrade, one Byzantine replica strategy (``testing/byzantine``
  catalog), one Byzantine client strategy (``testing/byzantine_client``
  catalog), load spikes past the admission knee, live reconfigurations, and
  SIGKILL-the-world on a real process cluster;
* **workload mix** — clients, keys, sweeps, value sizes, timeouts.

and then RUNS the whole cluster on the deterministic ``ExplorerLoop`` with
the ``InvariantChecker`` sampling continuously.

Determinism contract (pinned in ``tests/test_torch_scenario.py``): the drawn
:class:`ScenarioSpec` is a pure function of ``(seed, profile)`` — per-
component RNG streams are derived ``sha256(seed, component)`` exactly like
netsim's per-link streams, so adding a draw to one component never shifts
another's.  The RUN's canonical record (:meth:`ScenarioResult.canonical_
bytes`: drawn spec, executed step schedule, per-family fault counts, the
acked key→value map, and the invariant verdict) is byte-identical run over
run for the same seed: every client RNG is seeded from the scenario seed
(``MochiDBClient.rng_seed``), every adversary seed comes out of the spec,
the netsim plan is seeded, and the engine serializes fault legs at
deterministic logical barriers instead of racing wall-clock timers against
the workload.  Wall-clock timings and the ExplorerLoop's raw callback
trace ride the non-canonical ``info`` side (real sockets, and verifier
batches completing on an executor thread, keep byte-level trace identity off
the table — testing/schedule.py's docstring; the canonical record is exactly
the part kernel and thread timing cannot perturb).  The spec and the record
are byte for byte those of the JAX package's engine for the same seed.

The verifier posture is a RUN argument (``verifier=``), never a field of the
spec, so it moves no spec hash and no canonical byte:

* ``"cuda"`` (the default) — every replica of the virtual backend shares ONE
  ``CudaBatchVerifier(device="cuda")`` (the replicas register the cluster's
  identities, so grant signatures take the comb kernel); the process backend
  passes the posture to ``ProcessCluster(verifier="cuda")``.  Without a card
  it raises before anything boots; nothing verifies on the CPU instead.
* ``"cpu"`` — the inline host verifier in every replica (what tier-1 runs).

Any invariant violation therefore reproduces FROM THE SEED ALONE:

    python -m mochi_tpu_torch.testing.scenario repro --seed 41 [--verifier cpu]

re-draws the identical spec (``spec_hash`` pinned), re-runs it, and — with
``MOCHI_TRACE_DIR`` armed by the CLI — the conviction flight recorder
dumps every honest replica's causal span ring with the scenario seed
stamped in (``obs/trace.run_stamp``), so the artifact on disk names its
own reproducer.  ``minimize`` then greedily shrinks the failing spec
(drop faults, shorten the workload, shrink the topology) while the
violation still reproduces, and emits the minimal spec as a committable
JSON reproducer.

Scale knobs: ``soak(seeds)`` runs seed ranges; ``MOCHI_SCENARIO_SEEDS``
widens the slow-marked tier-1 soak without editing tests.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import hashlib
import json
import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# v2: durable draws gained the ``engine`` dimension (wal vs paged) — a
# new "engine" stream, so v1 seeds draw identical topologies and
# faults, but the spec shape changed and pinned specs re-pin.
# v3: every draw gained the ``fast_path`` dimension (session MAC fast
# path on vs off) — again a new stream ("fastpath"), so v2
# seeds draw identical everything-else; the soak battery now covers both
# verification postures.
GENERATOR_VERSION = 3

# The fault families a seed can draw.  "sigkill" only appears on the
# process backend (a real SIGKILL needs a real process); everything else
# rides the in-process VirtualCluster where the InvariantChecker can see
# the stores.
FAMILIES = (
    "crash-restart",
    "partition-heal",
    "degrade-uplink",
    "byz-replica",
    "byz-client",
    "load-spike",
    "reconfig",
    "sigkill",
)

BYZ_REPLICA_STRATEGIES = (
    "equivocate", "forge-cert", "stale-replay", "silent", "storm",
)
BYZ_CLIENT_STRATEGIES = (
    "withhold", "partial-write2", "seed-bias", "grant-hoard",
)

# The verifier postures a run may take (a run argument, never drawn).
VERIFIERS = ("cuda", "cpu")

# Draw profiles: how big a scenario one seed buys.  "soak" is sized so a
# 2-core container clears a seed in a few seconds (hundreds of seeds per
# battery); "full" is the publish posture (bigger workloads, more faults).
PROFILES = ("soak", "full")


def _stream(seed: int, name: str) -> random.Random:
    """Per-component RNG stream, derived exactly like netsim's per-link
    streams: adding a draw to one component can never shift another's
    (and dict/iteration order can't either — each stream is consumed by
    one component in one deterministic order)."""
    digest = hashlib.sha256(f"mochi.scenario:{seed}:{name}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def soak_seed_count(default: int = 8) -> int:
    """Seed count for the slow soak legs: ``MOCHI_SCENARIO_SEEDS``
    overrides (same contract as schedule.exploration_seeds)."""
    return int(os.environ.get("MOCHI_SCENARIO_SEEDS", str(default)))


class ScenarioHarnessError(AssertionError):
    """The harness itself could not complete the scenario (an op exhausted
    its retry budget with a quorum available, a replica failed to boot).
    Distinct from an invariant VIOLATION: this is 'the run is not
    evidence', not 'the protocol is unsafe'."""


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioSpec:
    """One fully-drawn scenario.  JSON-canonical (``to_json`` sorts keys),
    so ``spec_hash`` pins the draw and a committed reproducer is just this
    object serialized."""

    seed: int
    profile: str = "soak"
    generator_version: int = GENERATOR_VERSION
    backend: str = "virtual"  # "virtual" | "process"
    # topology
    n_servers: int = 4
    rf: int = 4
    durable: bool = False
    wal_fsync: str = "group"
    # which durable engine the storage dir gets ("wal" | "paged");
    # meaningless unless durable
    engine: str = "wal"
    # session MAC fast path posture: True = MAC'd sessions + signed
    # checkpoints + one-attestation certificates; False = every envelope
    # Ed25519-signed and every grant checked (the signed-everything wire).
    # Pinned in the spec so a replay never depends on MOCHI_FAST_PATH.
    fast_path: bool = True
    # netsim shape (the LinkEvent schedule is implied by the fault legs —
    # the engine fires partition/heal/degrade events at leg barriers)
    net_seed: int = 0
    rtt_ms: float = 0.0
    jitter_ms: float = 0.0
    drop: float = 0.0
    # workload mix
    n_clients: int = 1
    keys_per_client: int = 2
    sweeps: int = 1
    value_bytes: int = 24
    timeout_s: float = 2.0
    op_attempts: int = 6
    # ordered fault schedule: one leg per entry, {"family": ..., params}
    faults: Tuple[Dict, ...] = ()
    # never drawn — set by tests/CLI to prove detection→dump→replay→minimize
    inject_violation: bool = False

    @property
    def f(self) -> int:
        return (self.rf - 1) // 3

    # ------------------------------------------------------------- encoding

    def to_obj(self) -> Dict:
        obj = dataclasses.asdict(self)
        obj["faults"] = [dict(fl) for fl in self.faults]
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_obj(), sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_obj(cls, obj: Dict) -> "ScenarioSpec":
        data = dict(obj)
        data["faults"] = tuple(dict(fl) for fl in data.get("faults", ()))
        return cls(**data)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_obj(json.loads(text))

    def spec_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    def weight(self) -> int:
        """Spec size metric the minimizer must STRICTLY decrease: faults
        dominate, then topology, then workload volume."""
        return (
            10 * len(self.faults)
            + self.n_servers
            + self.n_clients
            + self.keys_per_client
            + self.sweeps
            + (2 if self.durable else 0)
            + (1 if self.engine != "wal" else 0)
            + (1 if self.rtt_ms > 0 else 0)
            + (1 if self.drop > 0 else 0)
        )

    def fault_families(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for fl in self.faults:
            fam = fl["family"]
            counts[fam] = counts.get(fam, 0) + 1
        return counts


def draw_spec(seed: int, profile: str = "soak") -> ScenarioSpec:
    """seed -> ScenarioSpec, pure and deterministic (pinned ×3 in tests)."""
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}: use one of {PROFILES}")
    backend_rng = _stream(seed, "backend")
    topo_rng = _stream(seed, "topology")
    net_rng = _stream(seed, "netsim")
    fault_rng = _stream(seed, "faults")
    wl_rng = _stream(seed, "workload")
    # Separate stream (not a draw on topo_rng): existing components keep
    # their exact v1 draws — the engine dimension is purely additive.
    engine_rng = _stream(seed, "engine")
    # v3, same additive-stream discipline: the fast-path
    # posture rides its own stream.  50/50 — the signed-everything wire
    # is the safety argument's baseline and must keep equal soak weight.
    fp_rng = _stream(seed, "fastpath")
    fast_path = fp_rng.random() < 0.5

    # ~1 in 8 seeds buys a real-process SIGKILL scenario: OS processes,
    # durable storage, kill -9 the whole cluster mid-load, recover from
    # disk — half of them against the paged engine.
    if backend_rng.random() < 0.125:
        victims = 1 + backend_rng.randrange(2)
        return ScenarioSpec(
            seed=seed,
            profile=profile,
            backend="process",
            n_servers=4,
            rf=4,
            durable=True,
            wal_fsync="group",
            engine=engine_rng.choice(("wal", "paged")),
            fast_path=fast_path,
            n_clients=1,
            keys_per_client=3 + wl_rng.randrange(3),
            sweeps=1,
            value_bytes=16 + 8 * wl_rng.randrange(3),
            timeout_s=8.0,
            op_attempts=6,
            faults=(
                {"family": "sigkill", "victims": victims, "restart": True},
            ),
        )

    n_servers, rf = topo_rng.choice(((4, 4), (5, 4), (5, 4), (6, 4)))
    durable = topo_rng.random() < 0.35
    wal_fsync = topo_rng.choice(("group", "off")) if durable else "group"
    engine = engine_rng.choice(("wal", "paged")) if durable else "wal"

    rtt_ms = net_rng.choice((0.0, 0.0, 2.0, 4.0, 8.0))
    jitter_ms = round(rtt_ms / 8.0, 2)
    drop = net_rng.choice((0.0, 0.0, 0.0, 0.005, 0.01))

    if profile == "full":
        n_clients = 2 + wl_rng.randrange(2)
        keys_per_client = 6 + wl_rng.randrange(5)
        sweeps = 2 + wl_rng.randrange(2)
    else:
        n_clients = 1 + wl_rng.randrange(2)
        keys_per_client = 2 + wl_rng.randrange(3)
        sweeps = 1 + wl_rng.randrange(2)
    value_bytes = 16 + 8 * wl_rng.randrange(7)
    timeout_s = 2.0 if rtt_ms == 0.0 else max(2.0, rtt_ms * 0.3)

    # The one replica every unavailability-consuming fault targets: with
    # f=1 the scenario may have at most ONE replica simultaneously
    # crashed/partitioned/degraded/Byzantine, so all such legs share a
    # victim (a drawn Byzantine replica IS the victim — attacking the
    # attacker keeps the honest quorum intact).  server-0 is always left
    # honest and reachable: it anchors the injected-violation probe and
    # the reconfig admin path.
    victim = f"server-{1 + topo_rng.randrange(n_servers - 1)}"

    n_faults = 1 + fault_rng.randrange(3)
    drawable = [f for f in FAMILIES if f != "sigkill"]
    families: List[str] = []
    for _ in range(n_faults):
        fam = fault_rng.choice(drawable)
        # at most one Byzantine replica (boot-level) and one Byzantine
        # client per scenario — the f-budget and the determinism argument
        # are written for one of each
        if fam in ("byz-replica", "byz-client") and fam in families:
            fam = fault_rng.choice(
                ("crash-restart", "partition-heal", "load-spike", "reconfig")
            )
        families.append(fam)

    faults: List[Dict] = []
    for fam in families:
        if fam == "crash-restart":
            faults.append({"family": fam, "victim": victim, "resync": True})
        elif fam == "partition-heal":
            faults.append(
                {
                    "family": fam,
                    "victim": victim,
                    "hold_s": round(0.2 + 0.2 * fault_rng.random(), 2),
                }
            )
        elif fam == "degrade-uplink":
            faults.append(
                {
                    "family": fam,
                    "victim": victim,
                    "rtt_ms": float(10 * (2 + fault_rng.randrange(4))),
                    "drop": round(0.02 + 0.03 * fault_rng.random(), 3),
                    "hold_s": round(0.2 + 0.2 * fault_rng.random(), 2),
                }
            )
        elif fam == "byz-replica":
            faults.append(
                {
                    "family": fam,
                    "sid": victim,
                    "strategy": fault_rng.choice(BYZ_REPLICA_STRATEGIES),
                }
            )
        elif fam == "byz-client":
            faults.append(
                {
                    "family": fam,
                    "strategy": fault_rng.choice(BYZ_CLIENT_STRATEGIES),
                    "seed": fault_rng.randrange(1 << 16),
                    "ttl_ms": 500.0,
                    "quota": 64,
                    "wedge_seeds": 32 + 16 * fault_rng.randrange(3),
                }
            )
        elif fam == "load-spike":
            faults.append(
                {"family": fam, "burst": 8 + 4 * fault_rng.randrange(4)}
            )
        elif fam == "reconfig":
            faults.append({"family": fam, "rounds": 1})
    return ScenarioSpec(
        seed=seed,
        profile=profile,
        backend="virtual",
        n_servers=n_servers,
        rf=rf,
        durable=durable,
        wal_fsync=wal_fsync,
        engine=engine,
        fast_path=fast_path,
        net_seed=seed,
        rtt_ms=rtt_ms,
        jitter_ms=jitter_ms,
        drop=drop,
        n_clients=n_clients,
        keys_per_client=keys_per_client,
        sweeps=sweeps,
        value_bytes=value_bytes,
        timeout_s=timeout_s,
        op_attempts=6,
        faults=tuple(faults),
    )


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------


@dataclass
class ScenarioResult:
    """One scenario run's verdict + canonical record.

    ``canonical_bytes()`` is the determinism surface (same seed ⇒ byte-
    identical): the spec, the executed step schedule, per-family fault
    counts, the acked map, and the invariant verdict.  ``info`` carries
    everything wall-clock-flavored (timings, retry hiccups, trace sizes,
    flight-dump paths, the full checker report) and is intentionally OFF
    the canonical surface."""

    spec: ScenarioSpec
    steps: List[str] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    acked: Dict[str, str] = field(default_factory=dict)
    error: Optional[str] = None
    report: Optional[Dict] = None
    info: Dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.error is None and not self.violations

    def canonical(self) -> Dict:
        return {
            "generator_version": self.spec.generator_version,
            "spec": self.spec.to_obj(),
            "spec_hash": self.spec.spec_hash(),
            "schedule": list(self.steps),
            "fault_families": self.spec.fault_families(),
            "acked": dict(sorted(self.acked.items())),
            "verdict": {
                "ok": self.ok,
                "violations": list(self.violations),
                "error": self.error,
            },
        }

    def canonical_bytes(self) -> bytes:
        return json.dumps(
            self.canonical(), sort_keys=True, separators=(",", ":")
        ).encode()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _scenario_env(spec: ScenarioSpec, flight_dir: Optional[str]):
    """Stamp the scenario identity into the process (obs run stamp + env,
    so child server processes and every flight dump are self-describing)
    and arm tracing when a flight dir is given; restore everything after."""
    from ..obs import trace as obs_trace

    patch = {
        "MOCHI_SCENARIO_SEED": str(spec.seed),
        "MOCHI_SCENARIO_SPEC_HASH": spec.spec_hash(),
        "MOCHI_WAL_FSYNC": spec.wal_fsync if spec.durable else None,
        "MOCHI_STORAGE_ENGINE": spec.engine if spec.durable else None,
    }
    if flight_dir:
        patch.update(
            {
                "MOCHI_TRACE_DIR": flight_dir,
                "MOCHI_TRACE_SAMPLE": "1.0",
                "MOCHI_TRACE_SEED": str(spec.seed),
            }
        )
    saved = {k: os.environ.get(k) for k in patch}
    for k, v in patch.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    obs_trace.set_run_stamp(
        scenario_seed=spec.seed,
        generator_version=spec.generator_version,
        profile=spec.profile,
        spec_hash=spec.spec_hash(),
        injected=True if spec.inject_violation else None,
    )
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs_trace.set_run_stamp(
            scenario_seed=None,
            generator_version=None,
            profile=None,
            spec_hash=None,
            injected=None,
        )


async def _put(client, checker, key: str, value: bytes, spec, res) -> None:
    """One acked write with a bounded retry budget.  Transient refusals/
    timeouts under a fault leg are absorbed (counted as hiccups, never
    canonical); exhausting the budget with a quorum available is a
    HARNESS failure — the scenario is sized so it cannot happen unless
    something real broke."""
    from ..client.txn import TransactionBuilder

    txn = TransactionBuilder().write(key, value).build()
    for attempt in range(spec.op_attempts):
        try:
            await client.execute_write_transaction(txn)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            if checker is not None:
                checker.record_attempt(key, value)
            res.info["hiccups"].append(
                f"write {key} attempt {attempt}: {type(exc).__name__}"
            )
            await asyncio.sleep(0.05 * (attempt + 1))
            continue
        if checker is not None:
            checker.record_ack(key, value)
        res.acked[key] = value.decode()
        return
    raise ScenarioHarnessError(
        f"write {key} failed {spec.op_attempts} attempts (leg could not "
        f"make progress with a quorum available)"
    )


async def _read_back(client, keys: Sequence[str]) -> None:
    from ..client.txn import TransactionBuilder

    for key in keys:
        try:
            await client.execute_read_transaction(
                TransactionBuilder().read(key).build()
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # durability is final_check's department, not the burst's


def _value(spec: ScenarioSpec, tag: str) -> bytes:
    raw = f"{tag}-s{spec.seed}".encode()
    return (raw * (spec.value_bytes // len(raw) + 1))[: spec.value_bytes]


async def _burst(clients, checker, tag: str, spec, res) -> int:
    """One deterministic workload burst: every client writes its keys
    (sequentially per client, clients concurrent — key spaces are
    disjoint, so completion interleaving cannot perturb the acked map),
    then reads them back."""
    async def one(ci: int) -> int:
        client = clients[ci]
        n = 0
        for s in range(spec.sweeps):
            for k in range(spec.keys_per_client):
                key = f"{tag}-c{ci}-k{k}"
                await _put(client, checker, key, _value(spec, f"{tag}v{s}"), spec, res)
                n += 1
        await _read_back(client, [f"{tag}-c{ci}-k{k}" for k in range(spec.keys_per_client)])
        return n

    counts = await asyncio.gather(*[one(ci) for ci in range(len(clients))])
    acked = sum(counts)
    res.steps.append(f"{tag}: burst acked={acked}")
    return acked


async def _run_leg(li: int, fault: Dict, vc, sim, clients, checker, spec, res) -> None:
    """Execute one fault leg at a deterministic logical barrier: inject →
    workload burst under the fault → recover → invariant sample."""
    from ..netsim import LinkSpec, NetSim

    fam = fault["family"]
    tag = f"L{li}"
    res.steps.append(f"{tag}: {fam} {json.dumps(fault, sort_keys=True)}")

    if fam == "crash-restart":
        victim = fault["victim"]
        old = vc.replica(victim)
        if getattr(old, "storage", None) is not None and spec.durable:
            await old.storage.flush()  # the crash image a WAL recovery replays
        await _burst(clients, checker, f"{tag}a", spec, res)
        fresh = await vc.restart_replica(victim, resync=bool(fault.get("resync")))
        checker.note_restart(fresh)
        convicted = 0
        if spec.durable and getattr(fresh, "storage", None) is not None:
            report = fresh.storage.replay_report()
            convicted = int(report.get("convicted", 0))
            res.info.setdefault("replays", []).append(
                {"leg": li, "victim": victim, **{k: report.get(k) for k in ("entries", "ms", "convicted")}}
            )
        res.steps.append(f"{tag}: restart {victim} convicted={convicted}")
        await _burst(clients, checker, f"{tag}b", spec, res)
    elif fam == "partition-heal":
        victim = fault["victim"]
        for ev in NetSim.partition(victim, 0.0):
            sim.apply_event(ev)
        res.steps.append(f"{tag}: partition {victim}")
        await _burst(clients, checker, f"{tag}a", spec, res)
        await asyncio.sleep(fault.get("hold_s", 0.3))
        for ev in NetSim.heal(victim):
            sim.apply_event(ev)
        res.steps.append(f"{tag}: heal {victim}")
        await _burst(clients, checker, f"{tag}b", spec, res)
    elif fam == "degrade-uplink":
        victim = fault["victim"]
        spec_bad = LinkSpec(
            delay_ms=fault["rtt_ms"] / 2.0, drop=fault["drop"]
        )
        for ev in NetSim.degrade_uplink(victim, 0.0, spec_bad):
            sim.apply_event(ev)
        res.steps.append(f"{tag}: degrade {victim}")
        await _burst(clients, checker, f"{tag}a", spec, res)
        await asyncio.sleep(fault.get("hold_s", 0.2))
        for ev in NetSim.degrade_uplink(victim, 0.0, spec_bad, until_s=0.0)[1:]:
            sim.apply_event(ev)
        res.steps.append(f"{tag}: restore {victim}")
        await _burst(clients, checker, f"{tag}b", spec, res)
    elif fam == "byz-replica":
        # the adversary serves from boot (VirtualCluster byzantine map);
        # this leg is the workload burst it gets to attack
        await _burst(clients, checker, tag, spec, res)
    elif fam == "byz-client":
        from .byzantine_client import defense_knobs

        strategy = fault["strategy"]
        # withhold/seed-bias contend on the honest keys this leg is about
        # to write (they never commit, so the acked map stays canonical);
        # partial-write2/grant-hoard get their own keyspace — their
        # commits must not race the honest acked values.
        if strategy in ("withhold", "seed-bias"):
            attack_keys = [f"{tag}-c0-k{k}" for k in range(spec.keys_per_client)]
        else:
            attack_keys = [f"{tag}-byz-k{k}" for k in range(spec.keys_per_client)]
        with defense_knobs(
            ttl_ms=fault.get("ttl_ms", 500.0), quota=fault.get("quota", 64)
        ):
            byz = vc.byzantine_client(
                strategy,
                seed=fault.get("seed", 0),
                timeout_s=spec.timeout_s,
                client_id=f"scn-{spec.seed}-byz",
                rng_seed=spec.seed ^ 0x5CE,
            )
            task = asyncio.ensure_future(
                byz.run(
                    attack_keys,
                    duration_s=3600.0,  # cancelled at leg end
                    interval_s=0.05,
                    wedge_seeds=fault.get("wedge_seeds", 32),
                    hoard_extra=8,
                )
            )
            try:
                await _burst(clients, checker, tag, spec, res)
            finally:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                except Exception:
                    pass
        res.info.setdefault("byz_client_stats", []).append(
            {"leg": li, "strategy": strategy, **byz.stats}
        )
        res.steps.append(f"{tag}: byz-client {strategy} detached")
    elif fam == "load-spike":
        burst = int(fault.get("burst", 8))

        async def spike(j: int) -> None:
            await _put(
                clients[j % len(clients)],
                checker,
                f"{tag}-spike-{j}",
                _value(spec, f"{tag}sp"),
                spec,
                res,
            )

        await asyncio.gather(*[spike(j) for j in range(burst)])
        res.steps.append(f"{tag}: spike acked={burst}")
        await _burst(clients, checker, f"{tag}b", spec, res)
    elif fam == "reconfig":
        admin = clients[0]
        for _ in range(int(fault.get("rounds", 1))):
            new_cfg = admin.config.evolve(
                {sid: s.url for sid, s in admin.config.servers.items()},
                public_keys=admin.config.public_keys,
            )
            await admin.reconfigure_cluster(new_cfg)
            # Convergence is only promised for HONEST replicas: a silent/
            # storm adversary never answers (or refuses) the config-resync
            # traffic that would teach it the new configstamp, and the
            # protocol makes no claims about a Byzantine member's local
            # state.  Waiting on vc.replicas wedged every silent+reconfig
            # draw at the 15 s deadline (regression-pinned in
            # tests/test_torch_scenario.py).
            honest = vc.honest_replicas()
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                if all(
                    r.config.configstamp == new_cfg.configstamp
                    for r in honest
                ):
                    break
                await asyncio.sleep(0.02)
            converged = all(
                r.config.configstamp == new_cfg.configstamp for r in honest
            )
            if not converged:
                raise ScenarioHarnessError(
                    f"reconfig to configstamp {new_cfg.configstamp} did not "
                    f"converge on every honest replica within 15 s"
                )
            res.steps.append(f"{tag}: reconfig configstamp={new_cfg.configstamp}")
        await _burst(clients, checker, f"{tag}b", spec, res)
    else:
        raise ScenarioHarnessError(f"unknown fault family {fam!r}")
    checker.check_now()


def _inject_conflicting_commit(vc, checker, res) -> None:
    """The seeded violation probe (inject_violation=True): overwrite one
    committed slot's transaction on ONE honest replica — exactly the
    cross-time certificate-agreement violation invariant 1 exists to
    catch.  Deterministic: first honest replica, smallest committed key."""
    from ..protocol import Action, Operation, Transaction

    replica = sorted(checker.replicas, key=lambda r: r.server_id)[0]
    for key in sorted(res.acked):
        sv = replica.store._get(key)
        if sv is not None and sv.current_certificate is not None and sv.last_transaction is not None:
            sv.last_transaction = Transaction(
                (Operation(Action.WRITE, key, b"scenario-injected-conflict"),)
            )
            res.steps.append(
                f"inject: conflicting-commit {replica.server_id} key={key}"
            )
            checker.check_now()
            return
    raise ScenarioHarnessError("no committed slot to inject a violation into")


def _normalized_violations(violations: Sequence[str]) -> List[str]:
    return list(violations)


def _require_verifier(verifier: str) -> None:
    """Refuse an unknown posture, and ``"cuda"`` without a card, before
    anything boots: nothing falls back to the CPU."""
    if verifier not in VERIFIERS:
        raise ValueError(f"unknown verifier {verifier!r}: use one of {VERIFIERS}")
    if verifier == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "scenario verifier 'cuda': no CUDA device is available "
                "(pass verifier='cpu' for the host verifier)"
            )


def _verifier_factory(verifier: str):
    """``VirtualCluster``'s ``verifier_factory`` for a posture: under
    ``"cuda"`` every replica shares ONE card-owning ``CudaBatchVerifier``
    (the replicas register the cluster's identities with it at boot), built
    inside the run's loop; ``"cpu"`` leaves each replica its host default."""
    if verifier == "cpu":
        return None
    from ..verifier.cuda import CudaBatchVerifier

    shared = CudaBatchVerifier(device="cuda")
    return lambda: shared


async def _drive_virtual(
    spec: ScenarioSpec, res: ScenarioResult, storage_dir: Optional[str], verifier: str = "cuda"
) -> None:
    from ..net import transport
    from ..netsim import NetSim
    from .invariants import InvariantChecker
    from .virtual_cluster import VirtualCluster

    byz_map = {
        fl["sid"]: fl["strategy"]
        for fl in spec.faults
        if fl["family"] == "byz-replica"
    }
    sim = NetSim.mesh(
        seed=spec.net_seed,
        rtt_ms=spec.rtt_ms,
        jitter_ms=spec.jitter_ms,
        drop=spec.drop,
    )
    res.steps.append(
        f"topology: n={spec.n_servers} rf={spec.rf} f={spec.f} "
        f"durable={spec.durable} engine={spec.engine} "
        f"fast_path={spec.fast_path} backend=virtual"
    )
    res.steps.append(
        f"netsim: rtt={spec.rtt_ms}ms jitter={spec.jitter_ms}ms drop={spec.drop}"
    )
    prev_floor = transport.RTT_FLOOR_S
    if spec.rtt_ms > 0:
        transport.RTT_FLOOR_S = max(prev_floor, spec.rtt_ms / 1e3)
    try:
        async with VirtualCluster(
            spec.n_servers,
            rf=spec.rf,
            verifier_factory=_verifier_factory(verifier),
            netsim=sim,
            byzantine=byz_map or None,
            storage_dir=storage_dir,
            storage_engine=spec.engine if spec.durable else None,
            fast_path=spec.fast_path,
        ) as vc:
            checker = InvariantChecker(vc.honest_replicas(), sorted(byz_map))
            clients = [
                vc.client(
                    timeout_s=spec.timeout_s,
                    client_id=f"scn-{spec.seed}-c{ci}",
                    rng_seed=spec.seed * 1000 + ci,
                )
                for ci in range(spec.n_clients)
            ]
            await _burst(clients, checker, "warm", spec, res)
            checker.start(0.05)
            try:
                for li, fault in enumerate(spec.faults):
                    await _run_leg(li, fault, vc, sim, clients, checker, spec, res)
            finally:
                await checker.stop()
            await checker.final_check(clients[0])
            if spec.inject_violation:
                _inject_conflicting_commit(vc, checker, res)
            res.report = checker.report()
            res.violations = _normalized_violations(checker.violations)
            res.info["netsim_totals"] = sim.totals()
            # evidence the drawn posture actually landed on every node
            # (a spec that said fast_path=False while the cluster ran
            # MAC'd sessions would soak the wrong wire)
            res.info["fast_path_postures"] = {
                "spec": spec.fast_path,
                "replicas": sorted({bool(r.fast_path) for r in vc.replicas}),
                "clients": sorted({bool(c.fast_path) for c in clients}),
            }
            res.info["verifier"] = _verifier_stats(verifier, vc.replicas)
    finally:
        transport.RTT_FLOOR_S = prev_floor
    res.steps.append(
        "final: invariants ok"
        if not res.violations
        else f"final: {len(res.violations)} violations"
    )


def _verifier_stats(verifier: str, replicas) -> Dict:
    """The posture and, for the shared card verifier, its batch counters
    (non-canonical: batch boundaries depend on the clock)."""
    out: Dict = {"posture": verifier}
    shared = {id(r.verifier): r.verifier for r in replicas if r.verifier is not None}
    if verifier == "cuda":
        out["instances"] = len(shared)
        for v in shared.values():
            for name in ("batches_flushed", "items_verified", "fallback_batches"):
                out[name] = out.get(name, 0) + int(getattr(v, name, 0))
            out["crossover_batches"] = out.get("crossover_batches", 0) + int(v.backend.crossover_batches)
    return out


async def _drive_process(spec: ScenarioSpec, res: ScenarioResult, verifier: str = "cuda") -> None:
    """SIGKILL family on real OS processes: durable WAL is the only
    survivor, recovery is verified replay, and the verdict is the acked-
    durability re-read (the in-process store invariants have no cross-
    process view)."""
    from ..client.txn import TransactionBuilder
    from ..obs import trace as obs_trace
    from .process_cluster import ProcessCluster

    fault = spec.faults[0]
    res.steps.append(
        f"topology: n={spec.n_servers} rf={spec.rf} f={spec.f} "
        f"durable=True engine={spec.engine} "
        f"fast_path={spec.fast_path} backend=process"
    )
    res.steps.append(f"L0: sigkill {json.dumps(fault, sort_keys=True)}")
    async with ProcessCluster(
        spec.n_servers,
        rf=spec.rf,
        n_processes=spec.n_servers,
        storage_dir=True,
        wal_fsync=spec.wal_fsync,
        storage_engine=spec.engine,
        verifier=verifier,
        # the children resolve their posture from the env (no --fast-path
        # flag): pin it so the replay never depends on the runner's env
        env={"MOCHI_FAST_PATH": "1" if spec.fast_path else "0"},
    ) as pc:
        client = pc.client(
            timeout_s=spec.timeout_s,
            client_id=f"scn-{spec.seed}-c0",
            rng_seed=spec.seed * 1000,
            fast_path=spec.fast_path,
        )
        await _burst([client], None, "warm", spec, res)
        victims = [f"server-{i}" for i in range(int(fault.get("victims", 1)))]
        for sid in victims:
            pc.kill_replica(sid)
        for sid in victims:
            proc = pc.process_for(sid).proc
            if proc is not None:
                await proc.wait()  # reaped before restart_replica relaunches
        res.steps.append(f"L0: sigkill {','.join(victims)}")
        for sid in victims:
            await pc.restart_replica(sid)
        res.steps.append(f"L0: restarted {','.join(victims)}")
        await client.close()
        reader = pc.client(
            timeout_s=spec.timeout_s,
            client_id=f"scn-{spec.seed}-r0",
            rng_seed=spec.seed * 1000 + 1,
        )
        for key, value in sorted(res.acked.items()):
            out = await reader.execute_read_transaction(
                TransactionBuilder().read(key).build()
            )
            got = out.operations[0].value
            if (bytes(got) if got is not None else None) != value.encode():
                res.violations.append(
                    f"acked write {key!r} lost across SIGKILL: read "
                    f"{got!r}, acked {value!r}"
                )
        pc.check_alive()
    res.report = {
        **({"run": obs_trace.run_stamp()} if obs_trace.run_stamp() else {}),
        "ok": not res.violations,
        "backend": "process",
        "verifier": verifier,
        "acked_writes": len(res.acked),
        "violations": list(res.violations),
    }
    res.steps.append(
        "final: invariants ok"
        if not res.violations
        else f"final: {len(res.violations)} violations"
    )


def run_scenario(
    spec_or_seed,
    profile: str = "soak",
    flight_dir: Optional[str] = None,
    timeout_s: Optional[float] = None,
    verifier: str = "cuda",
) -> ScenarioResult:
    """Run one scenario on a fresh seeded ExplorerLoop; returns the
    ScenarioResult whose ``canonical_bytes()`` is the determinism surface.

    Accepts a seed (drawn via :func:`draw_spec`) or an explicit
    :class:`ScenarioSpec`.  ``flight_dir`` arms full-rate tracing and the
    conviction flight recorder for the run (the ``repro`` CLI posture).
    ``verifier`` is the posture (module docstring): ``"cuda"`` raises
    without a card."""
    from . import schedule

    _require_verifier(verifier)

    spec = (
        spec_or_seed
        if isinstance(spec_or_seed, ScenarioSpec)
        else draw_spec(int(spec_or_seed), profile)
    )
    res = ScenarioResult(spec=spec)
    res.info["hiccups"] = []
    budget = timeout_s if timeout_s is not None else (
        90.0 + 45.0 * len(spec.faults) + (90.0 if spec.backend == "process" else 0.0)
    )

    storage_tmp: Optional[str] = None
    if spec.backend == "virtual" and spec.durable:
        storage_tmp = tempfile.mkdtemp(prefix=f"mochi-scn-{spec.seed}-")

    async def case() -> None:
        if spec.backend == "process":
            await _drive_process(spec, res, verifier)
        else:
            await _drive_virtual(spec, res, storage_tmp, verifier)

    t0 = time.perf_counter()
    try:
        with _scenario_env(spec, flight_dir):
            sched = schedule.run_case(case, seed=spec.seed, timeout_s=budget)
    finally:
        if storage_tmp is not None:
            import shutil

            shutil.rmtree(storage_tmp, ignore_errors=True)
    res.info["wall_s"] = round(time.perf_counter() - t0, 2)
    res.info["loop_trace_len"] = len(sched.trace)
    if flight_dir:
        try:
            res.info["flight_dumps"] = sorted(
                fn for fn in os.listdir(flight_dir) if fn.startswith("flight-")
            )
        except OSError:
            res.info["flight_dumps"] = []
    if sched.error is not None:
        res.error = sched.error
    return res


# ---------------------------------------------------------------------------
# Minimizer
# ---------------------------------------------------------------------------


def _violation_kind(msg: str) -> str:
    """The class of a violation message, stable across key names/hashes:
    the prefix up to the first quoted operand."""
    return msg.split("'")[0].strip()


@dataclass
class MinimizeResult:
    spec: ScenarioSpec
    runs: int
    trail: List[str]
    violation_kind: str

    def reproducer(self) -> Dict:
        """The committable JSON reproducer the CLI writes."""
        return {
            "generator_version": self.spec.generator_version,
            "spec": self.spec.to_obj(),
            "spec_hash": self.spec.spec_hash(),
            "violation_kind": self.violation_kind,
            "minimizer_runs": self.runs,
        }


def minimize(
    spec: ScenarioSpec,
    reproduces: Optional[Callable[[ScenarioResult], bool]] = None,
    max_runs: int = 48,
    log: Optional[Callable[[str], None]] = None,
    verifier: str = "cuda",
) -> MinimizeResult:
    """Greedy scenario shrinker: drop faults, shorten the workload, shrink
    the topology, strip the conditioning — keeping each shrink only while
    the violation still reproduces.  Returns a strictly-smaller spec (by
    :meth:`ScenarioSpec.weight`) whenever any transform was adopted."""
    base = run_scenario(spec, verifier=verifier)
    runs = 1
    if base.ok:
        raise ScenarioHarnessError(
            "minimize() needs a failing scenario; the given spec passed"
        )
    if base.violations:
        kind = _violation_kind(base.violations[0])
        if reproduces is None:
            def reproduces(r: ScenarioResult) -> bool:
                return any(_violation_kind(v) == kind for v in r.violations)
    else:
        # harness-error class (e.g. "ScenarioHarnessError: ..."): match on
        # the exception type — a violations-only predicate could never
        # reproduce it and every shrink would burn a full run then revert
        kind = (base.error or "error").split(":")[0]
        if reproduces is None:
            def reproduces(r: ScenarioResult) -> bool:
                return bool(r.error) and r.error.split(":")[0] == kind

    trail: List[str] = []
    current = spec

    def attempt(candidate: ScenarioSpec, what: str) -> bool:
        nonlocal current, runs
        if runs >= max_runs:
            return False
        if candidate.weight() >= current.weight():
            return False
        result = run_scenario(candidate, verifier=verifier)
        runs += 1
        if reproduces(result):
            current = candidate
            trail.append(f"kept: {what} (weight {candidate.weight()})")
            if log:
                log(f"minimize: kept {what}")
            return True
        trail.append(f"reverted: {what}")
        return False

    # 1. drop faults, rightmost first, to fixed point
    changed = True
    while changed and runs < max_runs:
        changed = False
        for i in reversed(range(len(current.faults))):
            faults = current.faults[:i] + current.faults[i + 1 :]
            if attempt(
                dataclasses.replace(current, faults=faults),
                f"drop fault {i} ({current.faults[i]['family']})",
            ):
                changed = True
                break
    # 2. shorten the workload
    for fld in ("sweeps", "keys_per_client", "n_clients"):
        if getattr(current, fld) > 1:
            attempt(dataclasses.replace(current, **{fld: 1}), f"{fld}=1")
    # 3. shrink the topology to the smallest quorum-complete shape —
    # remapping fault victims that name servers outside the shrunk
    # membership (server-0 stays honest, so remap into 1..n-1); the
    # reproduction re-check decides whether the remapped fault still
    # carries the failure
    if current.n_servers > current.rf:
        new_n = current.rf

        def remap(fl: Dict) -> Dict:
            out = dict(fl)
            for field_name in ("victim", "sid"):
                sid = out.get(field_name)
                if sid is not None:
                    idx = int(str(sid).rsplit("-", 1)[1])
                    if idx >= new_n:
                        out[field_name] = f"server-{1 + (idx % (new_n - 1))}"
            return out

        attempt(
            dataclasses.replace(
                current,
                n_servers=new_n,
                faults=tuple(remap(fl) for fl in current.faults),
            ),
            f"n_servers={new_n}",
        )
    # 4. strip the storage/conditioning riders
    if current.engine != "wal":
        # shrink the engine before durability: a paged-engine violation
        # that also reproduces on the WAL engine isn't a paging bug
        attempt(dataclasses.replace(current, engine="wal"), "engine=wal")
    if current.durable:
        attempt(
            dataclasses.replace(current, durable=False, engine="wal"),
            "durable=False",
        )
    if current.rtt_ms > 0 or current.drop > 0:
        attempt(
            dataclasses.replace(
                current, rtt_ms=0.0, jitter_ms=0.0, drop=0.0
            ),
            "clean mesh",
        )
    return MinimizeResult(spec=current, runs=runs, trail=trail, violation_kind=kind)


# ---------------------------------------------------------------------------
# Soak
# ---------------------------------------------------------------------------


def _soak_one(args: Tuple[int, str, str]) -> Dict:
    """Worker entry (top-level for pickling): one seed, small verdict."""
    seed, profile, verifier = args
    t0 = time.perf_counter()
    # draw first (pure + cheap): the coverage counters must reflect what
    # was ATTEMPTED even when the run itself raises — an errored seed
    # reported with families={} would under-count the soak's per-family
    # draw evidence
    try:
        spec = draw_spec(seed, profile)
        families, backend = spec.fault_families(), spec.backend
    except Exception:
        families, backend = {}, "?"
    try:
        result = run_scenario(seed, profile=profile, verifier=verifier)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as exc:
        return {
            "seed": seed,
            "ok": False,
            "error": f"{type(exc).__name__}: {exc}",
            "violations": [],
            "families": families,
            "backend": backend,
            "acked": 0,
            "wall_s": round(time.perf_counter() - t0, 2),
        }
    return {
        "seed": seed,
        "ok": result.ok,
        "error": result.error,
        "violations": list(result.violations),
        "families": result.spec.fault_families(),
        "backend": result.spec.backend,
        "acked": len(result.acked),
        "wall_s": round(time.perf_counter() - t0, 2),
    }


def soak(
    seeds: Iterable[int],
    profile: str = "soak",
    workers: int = 1,
    log: Optional[Callable[[str], None]] = None,
    verifier: str = "cuda",
) -> Dict:
    """Run many seeds; aggregate verdicts + per-family draw coverage.
    ``workers > 1`` fans seeds across spawned processes (each scenario is
    its own event loop + cluster; the spawn context keeps workers clean of
    the parent's loop and CUDA state: a CUDA context does not survive a
    fork)."""
    _require_verifier(verifier)
    seed_list = list(seeds)
    t0 = time.perf_counter()
    rows: List[Dict] = []
    if workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            for row in pool.map(
                _soak_one, [(s, profile, verifier) for s in seed_list], chunksize=1
            ):
                rows.append(row)
                if log and len(rows) % 25 == 0:
                    log(f"soak: {len(rows)}/{len(seed_list)} seeds")
    else:
        for s in seed_list:
            rows.append(_soak_one((s, profile, verifier)))
            if log and len(rows) % 25 == 0:
                log(f"soak: {len(rows)}/{len(seed_list)} seeds")
    families: Dict[str, int] = {fam: 0 for fam in FAMILIES}
    backends: Dict[str, int] = {}
    failures = [r for r in rows if not r["ok"]]
    for r in rows:
        for fam, n in r["families"].items():
            families[fam] = families.get(fam, 0) + n
        backends[r["backend"]] = backends.get(r["backend"], 0) + 1
    wall = time.perf_counter() - t0
    return {
        "generator_version": GENERATOR_VERSION,
        "profile": profile,
        "verifier": verifier,
        "seeds_run": len(rows),
        "seed_range": [min(seed_list), max(seed_list)] if seed_list else [],
        "violations": sum(len(r["violations"]) for r in rows),
        "harness_errors": sum(1 for r in rows if r["error"]),
        "failing_seeds": [
            {
                "seed": r["seed"],
                "error": r["error"],
                "violations": r["violations"][:4],
            }
            for r in failures[:16]
        ],
        "fault_family_draws": families,
        "backends": backends,
        "acked_writes": sum(r["acked"] for r in rows),
        "wall_s": round(wall, 1),
        "per_seed_wall_s_mean": round(
            sum(r["wall_s"] for r in rows) / max(1, len(rows)), 2
        ),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _print_result(result: ScenarioResult, verbose: bool = False) -> None:
    doc = result.canonical()
    if verbose:
        doc["info"] = result.info
        doc["report"] = result.report
    print(json.dumps(doc, indent=2, sort_keys=True))


def _add_verifier(p: argparse.ArgumentParser) -> None:
    p.add_argument("--verifier", choices=VERIFIERS, default="cuda",
                   help="cuda (default): every replica verifies on the card; "
                        "cpu: the host verifier")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mochi_tpu_torch.testing.scenario",
        description=(
            "Deterministic whole-cluster scenario engine: one seed draws "
            "topology, faults and workload; any violation replays from "
            "the seed alone."
        ),
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_spec = sub.add_parser("spec", help="print the spec a seed draws")
    p_spec.add_argument("--seed", type=int, required=True)
    p_spec.add_argument("--profile", choices=PROFILES, default="soak")

    p_run = sub.add_parser("run", help="draw + run one seed")
    p_run.add_argument("--seed", type=int, required=True)
    p_run.add_argument("--profile", choices=PROFILES, default="soak")
    p_run.add_argument("--inject", action="store_true",
                       help="inject a store-level conflicting commit "
                            "(violation-path probe)")
    p_run.add_argument("--verbose", action="store_true")
    _add_verifier(p_run)

    p_soak = sub.add_parser("soak", help="run a seed range")
    p_soak.add_argument("--count", type=int, default=soak_seed_count(100))
    p_soak.add_argument("--start", type=int, default=0)
    p_soak.add_argument("--profile", choices=PROFILES, default="soak")
    p_soak.add_argument("--workers", type=int, default=1)
    p_soak.add_argument("--out", help="write the summary JSON here")
    _add_verifier(p_soak)

    p_repro = sub.add_parser(
        "repro",
        help="reproduce from the seed alone: re-draw, verify the spec "
             "hash, re-run with the flight recorder armed",
    )
    p_repro.add_argument("--seed", type=int)
    p_repro.add_argument("--profile", choices=PROFILES, default="soak")
    p_repro.add_argument("--inject", action="store_true")
    p_repro.add_argument("--dump", help="a flight-recorder JSON: take seed/"
                                        "profile/hash from its run stamp")
    p_repro.add_argument("--expect-hash", help="fail unless the re-drawn "
                                               "spec hashes to this")
    p_repro.add_argument("--flight-dir", default=None)
    p_repro.add_argument("--minimize", metavar="OUT_JSON",
                         help="greedily shrink the failing spec and write "
                              "the minimal reproducer here")
    p_repro.add_argument("--verbose", action="store_true")
    _add_verifier(p_repro)

    args = parser.parse_args(argv)
    if args.cmd != "spec":
        try:
            _require_verifier(args.verifier)
        except RuntimeError as exc:
            print(f"scenario: {exc}", file=sys.stderr)
            return 2

    if args.cmd == "spec":
        spec = draw_spec(args.seed, args.profile)
        print(json.dumps(
            {"spec": spec.to_obj(), "spec_hash": spec.spec_hash()},
            indent=2, sort_keys=True,
        ))
        return 0

    if args.cmd == "run":
        spec = draw_spec(args.seed, args.profile)
        if args.inject:
            spec = dataclasses.replace(spec, inject_violation=True)
        result = run_scenario(spec, verifier=args.verifier)
        _print_result(result, verbose=args.verbose)
        return 0 if result.ok else 1

    if args.cmd == "soak":
        summary = soak(
            range(args.start, args.start + args.count),
            profile=args.profile,
            workers=args.workers,
            log=lambda msg: print(msg, file=sys.stderr),
            verifier=args.verifier,
        )
        text = json.dumps(summary, indent=2, sort_keys=True)
        print(text)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
        return 0 if summary["violations"] == 0 and summary["harness_errors"] == 0 else 1

    if args.cmd == "repro":
        profile, seed, inject = args.profile, args.seed, args.inject
        expect = args.expect_hash
        if args.dump:
            with open(args.dump, encoding="utf-8") as fh:
                stamp = json.load(fh).get("run", {})
            if "scenario_seed" not in stamp:
                print("dump carries no scenario run stamp", file=sys.stderr)
                return 2
            seed = int(stamp["scenario_seed"])
            profile = stamp.get("profile", profile)
            inject = bool(stamp.get("injected", False))
            expect = expect or stamp.get("spec_hash")
        if seed is None:
            print("need --seed or --dump", file=sys.stderr)
            return 2
        spec = draw_spec(seed, profile)
        if inject:
            spec = dataclasses.replace(spec, inject_violation=True)
        if expect and spec.spec_hash() != expect:
            print(
                f"spec hash mismatch: drew {spec.spec_hash()}, artifact "
                f"says {expect} (generator version drift? see "
                f"GENERATOR_VERSION)",
                file=sys.stderr,
            )
            return 3
        flight = args.flight_dir
        if flight is None:
            flight = tempfile.mkdtemp(prefix=f"mochi-scn-flight-{seed}-")
        result = run_scenario(spec, flight_dir=flight, verifier=args.verifier)
        _print_result(result, verbose=args.verbose)
        print(f"flight recorder: {flight}", file=sys.stderr)
        if result.ok:
            print("scenario passed (nothing to minimize)", file=sys.stderr)
            return 0
        if args.minimize:
            mini = minimize(
                spec, log=lambda msg: print(msg, file=sys.stderr),
                verifier=args.verifier,
            )
            with open(args.minimize, "w", encoding="utf-8") as fh:
                json.dump(mini.reproducer(), fh, indent=2, sort_keys=True)
                fh.write("\n")
            print(
                f"minimal reproducer ({mini.runs} runs, weight "
                f"{spec.weight()} -> {mini.spec.weight()}) -> {args.minimize}",
                file=sys.stderr,
            )
        return 1
    return 2


if __name__ == "__main__":
    sys.exit(main())
