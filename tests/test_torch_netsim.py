"""The port's network conditioning (``mochi_tpu_torch/netsim``) on the CPU.

Ported from the JAX package's ``tests/test_netsim.py``: the deterministic
core (``LinkPolicy.plan``: same seed, identical per-link fate and delay
sequences; independent per-link streams), ordering, bandwidth queueing, spec
resolution, schedules and partitions, the passthrough leg, and a conditioned
``VirtualCluster`` end to end with its admin surfaces.  Added: the same spec
and seed give the same per-link decisions in both packages over a fixed
frame sequence, and a schedule of link events leaves the same links down in
both.
"""

import asyncio
import json
import urllib.request

import pytest

from mochi_tpu.netsim import LinkEvent as JLinkEvent
from mochi_tpu.netsim import LinkSpec as JLinkSpec
from mochi_tpu.netsim import NetSim as JNetSim
from mochi_tpu_torch.netsim import LinkEvent, LinkSpec, NetSim


def _plans(sim: NetSim, src: str, dst: str, n: int = 64, size: int = 512):
    pol = sim.policy(src, dst)
    return [pol.plan(size, now=float(i)) for i in range(n)]


# ------------------------------------------------------------- determinism


def test_same_seed_identical_delay_sequence():
    spec = dict(rtt_ms=13.0, jitter_ms=2.0, drop=0.1, reorder=0.05)
    a = _plans(NetSim.mesh(seed=8, **spec), "client-0", "server-1")
    b = _plans(NetSim.mesh(seed=8, **spec), "client-0", "server-1")
    assert a == b
    assert any(fate == "drop" for fate, _ in a)  # the stream exercises drop
    assert any(d > 0 for _, d in a)


def test_different_seed_differs():
    spec = dict(rtt_ms=13.0, jitter_ms=2.0)
    a = _plans(NetSim.mesh(seed=8, **spec), "a", "b")
    b = _plans(NetSim.mesh(seed=9, **spec), "a", "b")
    assert a != b


def test_per_link_streams_independent():
    """Traffic on one link must not perturb another link's stream: the
    a->b sequence is identical whether or not c->d drew frames first."""
    spec = dict(rtt_ms=13.0, jitter_ms=2.0, drop=0.2)
    quiet = NetSim.mesh(seed=8, **spec)
    noisy = NetSim.mesh(seed=8, **spec)
    _plans(noisy, "c", "d", n=37)  # unrelated traffic first
    assert _plans(quiet, "a", "b") == _plans(noisy, "a", "b")
    # and the two directions of one pair are distinct streams
    assert _plans(quiet, "a", "b") != _plans(quiet, "b", "a")


# ---------------------------------------------------------------- ordering


def test_fifo_preserved_without_reorder():
    sim = NetSim.mesh(seed=8, rtt_ms=13.0, jitter_ms=6.0)
    pol = sim.policy("a", "b")
    arrivals = []
    now = 0.0
    for _ in range(200):
        fate, delay = pol.plan(256, now=now)
        assert fate == "deliver"
        arrivals.append(now + delay)
        now += 0.001  # frames sent 1 ms apart; jitter spans ±3 ms one-way
    assert arrivals == sorted(arrivals)


def test_reorder_drawn_and_counted():
    sim = NetSim.mesh(seed=8, rtt_ms=10.0, reorder=1.0)
    pol = sim.policy("a", "b")
    fate, delay = pol.plan(256, now=0.0)
    assert fate == "reorder"
    # held back at least one extra propagation delay vs the base one-way
    assert delay > 5.0 / 1e3


def test_bandwidth_serialization_queues():
    # 8 kbit/s link, 1000-byte frames: 1 s serialization each, queuing
    # behind one another when sent back-to-back.
    sim = NetSim(seed=8, default=LinkSpec(bandwidth_bps=8000.0))
    pol = sim.policy("a", "b")
    _, d1 = pol.plan(1000, now=0.0)
    _, d2 = pol.plan(1000, now=0.0)
    assert abs(d1 - 1.0) < 1e-6
    assert abs(d2 - 2.0) < 1e-6


# ------------------------------------------------------------- spec lookup


def test_spec_resolution_precedence():
    default = LinkSpec(delay_ms=1.0)
    exact = LinkSpec(delay_ms=2.0)
    to_b = LinkSpec(delay_ms=3.0)
    from_a = LinkSpec(delay_ms=4.0)
    sim = NetSim(
        seed=0,
        default=default,
        links={("a", "b"): exact, ("*", "b"): to_b, ("a", "*"): from_a},
    )
    assert sim.policy("a", "b").spec is exact
    assert sim.policy("c", "b").spec is to_b
    assert sim.policy("a", "c").spec is from_a
    assert sim.policy("c", "d").spec is default


# ----------------------------------------------------- schedules/partitions


def test_partition_blocks_exactly_the_scheduled_links():
    sim = NetSim.mesh(seed=8, rtt_ms=13.0)
    ab = sim.policy("a", "b")
    ba = sim.policy("b", "a")
    ac = sim.policy("a", "c")
    for ev in NetSim.partition("b", at_s=0.0):
        sim.apply_event(ev)
    assert ab.down and ba.down and not ac.down
    assert ab.plan(64, now=0.0) == ("drop", 0.0)
    assert ac.plan(64, now=0.0)[0] == "deliver"
    # heal restores both directions
    for ev in (LinkEvent(0.0, "up", "b", "*"), LinkEvent(0.0, "up", "*", "b")):
        sim.apply_event(ev)
    assert not ab.down and not ba.down
    assert ab.plan(64, now=100.0)[0] == "deliver"


def test_wildcard_up_heals_specific_downs():
    """An `up` clears every down pattern it covers: heal-all ("*", "*")
    must heal a node partition recorded as specific patterns, and a node
    heal must clear that node's per-link downs."""
    sim = NetSim.mesh(seed=8, rtt_ms=13.0)
    ab = sim.policy("a", "b")
    ba = sim.policy("b", "a")
    for ev in NetSim.partition("b", at_s=0.0):
        sim.apply_event(ev)
    assert ab.down and ba.down
    sim.apply_event(LinkEvent(0.0, "up", "*", "*"))  # heal-all
    assert not ab.down and not ba.down
    # node heal covers a per-link down of that node
    sim.apply_event(LinkEvent(0.0, "down", "b", "a"))
    assert ba.down
    sim.apply_event(LinkEvent(0.0, "up", "b", "*"))
    assert not ba.down


def test_late_created_link_inherits_fired_events():
    """Links materialize lazily on first connection — a partition that
    fired before the link existed must still block it."""
    sim = NetSim.mesh(seed=8, rtt_ms=13.0)
    for ev in NetSim.partition("b", at_s=0.0):
        sim.apply_event(ev)
    assert sim.policy("z", "b").down  # created after the event
    assert not sim.policy("z", "c").down


def test_degrade_uplink_set_and_reset():
    slow = LinkSpec(delay_ms=100.0, drop=0.5)
    sim = NetSim.mesh(seed=8, rtt_ms=13.0)
    pol = sim.policy("server-2", "client-0")
    base = pol.spec
    sim.apply_event(LinkEvent(0.0, "set", "server-2", "*", slow))
    assert pol.spec is slow
    sim.apply_event(LinkEvent(0.0, "reset", "server-2", "*"))
    assert pol.spec is base


def test_schedule_arms_lazily_and_rearms_after_close():
    """Standalone postures (client-only netsim against live servers)
    never call ensure_started — the first on-loop link_pair must arm the
    schedule; close() resets link state so a reused sim re-arms from a
    fresh t=0 instead of silently running with a dead schedule."""

    async def main():
        sim = NetSim.mesh(
            seed=1, rtt_ms=1.0,
            schedule=NetSim.partition("b", at_s=0.05),
        )
        assert sim.link_pair("a", "b") is not None  # arms the schedule
        await asyncio.sleep(0.15)
        assert sim.policy("a", "b").down and sim.policy("b", "a").down
        sim.close()
        assert not sim.policy("a", "b").down  # close resets link state
        # second use: schedule re-arms relative to a new t=0
        sim.link_pair("a", "b")
        assert not sim.policy("a", "b").down
        await asyncio.sleep(0.15)
        assert sim.policy("a", "b").down
        sim.close()

    asyncio.run(asyncio.wait_for(main(), timeout=30))


def test_undeliverable_frame_counts_lost_not_delivered():
    """Egress to a transport that closed while the frame was in flight
    reports False; the link must count it `lost` — `delivered == frames`
    is the evidence records' lossless observable and must not lie."""

    async def main():
        sim = NetSim.mesh(seed=1, rtt_ms=2.0)
        pol = sim.policy("a", "b")
        got = []
        pol.send(lambda f: got.append(f) or True, b"ok")
        pol.send(lambda f: False, b"gone")  # closed-transport analog
        await asyncio.sleep(0.01)
        sim.close()
        s = pol.stats()
        assert got == [b"ok"]
        assert s["frames"] == 2 and s["delivered"] == 1 and s["lost"] == 1

    asyncio.run(asyncio.wait_for(main(), timeout=30))


# ------------------------------------------------------------- passthrough


def test_disabled_netsim_hands_out_no_policies():
    sim = NetSim.mesh(seed=8, rtt_ms=13.0, enabled=False)
    assert sim.policy("a", "b") is None
    assert sim.link_pair("a", "b") is None
    assert sim.stats()["links"] == {}


def test_disabled_cluster_transport_takes_null_path():
    """With netsim attached-but-disabled, protocols carry no link policies
    (the `link is None` fast path — the passthrough leg of the config-7
    overhead A/B)."""

    async def main():
        from mochi_tpu_torch.admin import AdminServer
        from mochi_tpu_torch.client.txn import TransactionBuilder
        from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

        sim = NetSim.mesh(seed=8, rtt_ms=13.0, enabled=False)
        async with VirtualCluster(4, rf=4, netsim=sim) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("pt", b"v").build()
            )
            conns = list(client.pool._connections.values())
            assert conns and all(c.links is None for c in conns)
            for conn in conns:
                assert conn._proto.egress_link is None
                assert conn._proto.ingress_link is None
            # admin surfaces of the disabled leg must be indistinguishable
            # from a replica with no netsim at all
            admin = AdminServer(vc.replicas[0], port=0)
            await admin.start()
            try:
                loop = asyncio.get_running_loop()
                _, body = await loop.run_in_executor(
                    None, _get, admin.bound_port, "/status"
                )
                assert "netsim" not in json.loads(body)
                _, prom = await loop.run_in_executor(
                    None, _get, admin.bound_port, "/metrics.prom"
                )
                assert "mochi_netsim" not in prom
            finally:
                await admin.close()
        assert sim.totals()["frames"] == 0

    asyncio.run(asyncio.wait_for(main(), timeout=120))


# ------------------------------------------------------------- integration


def _get(port: int, path: str):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.status, resp.read().decode()


def test_conditioned_cluster_end_to_end_with_admin_surfaces():
    async def main():
        from mochi_tpu_torch.admin import AdminServer
        from mochi_tpu_torch.client.txn import TransactionBuilder
        from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

        import time

        sim = NetSim.mesh(seed=8, rtt_ms=6.0, jitter_ms=0.5)
        async with VirtualCluster(5, rf=4, netsim=sim) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("wan", b"v").build()
            )
            t0 = time.perf_counter()
            res = await client.execute_read_transaction(
                TransactionBuilder().read("wan").build()
            )
            read_s = time.perf_counter() - t0
            assert res.operations[0].value == b"v"
            # one conditioned round trip is the latency floor
            assert read_s >= 0.005, read_s
            totals = sim.totals()
            assert totals["delayed"] > 0 and totals["dropped"] == 0

            admin = AdminServer(vc.replicas[0], port=0)
            await admin.start()
            try:
                loop = asyncio.get_running_loop()
                _, body = await loop.run_in_executor(
                    None, _get, admin.bound_port, "/status"
                )
                doc = json.loads(body)
                assert doc["netsim"]["seed"] == 8
                links = doc["netsim"]["links"]
                assert any(v["delivered"] > 0 for v in links.values())
                _, prom = await loop.run_in_executor(
                    None, _get, admin.bound_port, "/metrics.prom"
                )
                assert 'mochi_netsim{link="' in prom
                assert 'stat="delivered"' in prom
            finally:
                await admin.close()

    asyncio.run(asyncio.wait_for(main(), timeout=120))


# ------------------------------------------------ against the reference


_SPECS = {
    "wan": dict(rtt_ms=13.0, jitter_ms=2.0, drop=0.1, reorder=0.05),
    "lossy": dict(rtt_ms=4.0, jitter_ms=0.5, drop=0.3, reorder=0.2),
    "bandwidth": dict(rtt_ms=2.0, bandwidth_bps=1e6),
}


def _frames(seed: int, n: int = 200):
    """A fixed frame sequence: (send time, size) pairs, made from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(0.002, n))
    sizes = rng.integers(64, 4096, n)
    return [(float(t), int(z)) for t, z in zip(times, sizes)]


@pytest.mark.parametrize("seed", [0, 8, 2**31 - 1])
@pytest.mark.parametrize("spec", sorted(_SPECS))
def test_link_decisions_equal_the_reference(spec, seed):
    """The same spec and seed: every directed link of a small mesh makes
    the same (fate, delay) decision for every frame in both packages, with
    the links' streams drawn in an interleaved order."""
    kwargs = {k: v for k, v in _SPECS[spec].items() if k in ("rtt_ms", "jitter_ms", "drop", "reorder")}
    if "bandwidth_bps" in _SPECS[spec]:
        mine = NetSim(seed=seed, default=LinkSpec(bandwidth_bps=_SPECS[spec]["bandwidth_bps"], delay_ms=1.0))
        ref = JNetSim(seed=seed, default=JLinkSpec(bandwidth_bps=_SPECS[spec]["bandwidth_bps"], delay_ms=1.0))
    else:
        mine, ref = NetSim.mesh(seed=seed, **kwargs), JNetSim.mesh(seed=seed, **kwargs)
    links = [("client-0", "server-1"), ("server-1", "client-0"), ("server-2", "server-3"), ("a", "b")]
    frames = _frames(seed)
    got, want = [], []
    for i, (now, size) in enumerate(frames):
        src, dst = links[i % len(links)]
        got.append((src, dst, mine.policy(src, dst).plan(size, now=now)))
        want.append((src, dst, ref.policy(src, dst).plan(size, now=now)))
    assert got == want
    fates = {fate for _, _, (fate, _) in got}
    assert "deliver" in fates
    if _SPECS[spec].get("drop"):
        assert "drop" in fates


def test_link_events_leave_the_same_links_down_as_the_reference():
    """A partition, a per-link down, a degrade and the heals: after each
    event both packages' links agree on down and on the spec's delay."""
    mine, ref = NetSim.mesh(seed=3, rtt_ms=5.0), JNetSim.mesh(seed=3, rtt_ms=5.0)
    nodes = ["a", "b", "c"]
    slow_m, slow_r = LinkSpec(delay_ms=100.0), JLinkSpec(delay_ms=100.0)
    events = [
        (NetSim.partition("b", at_s=0.0), JNetSim.partition("b", at_s=0.0)),
        ([LinkEvent(0.0, "set", "c", "*", slow_m)], [JLinkEvent(0.0, "set", "c", "*", slow_r)]),
        ([LinkEvent(0.0, "up", "*", "*")], [JLinkEvent(0.0, "up", "*", "*")]),
        ([LinkEvent(0.0, "down", "a", "c")], [JLinkEvent(0.0, "down", "a", "c")]),
        ([LinkEvent(0.0, "reset", "c", "*")], [JLinkEvent(0.0, "reset", "c", "*")]),
    ]
    for mine_evs, ref_evs in events:
        for ev in mine_evs:
            mine.apply_event(ev)
        for ev in ref_evs:
            ref.apply_event(ev)
        for src in nodes:
            for dst in nodes:
                if src != dst:
                    pm, pr = mine.policy(src, dst), ref.policy(src, dst)
                    assert (pm.down, pm.spec.delay_ms) == (pr.down, pr.spec.delay_ms), (src, dst)
