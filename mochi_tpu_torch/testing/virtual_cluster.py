"""In-process virtual cluster: N real replicas on loopback TCP + real clients.

Re-creates the reference's test framework
(``testingframework/MochiVirtualCluster.java:27-77``): every replica is a full
server (real sockets, real dispatch, real datastore) sharing one generated
cluster config; clients are the production SDK.  Extensions over the
reference: per-replica Ed25519 keypairs are generated and published in the
config, and a pluggable ``verifier_factory`` lets tests run the same cluster
over the CPU or CUDA verification path.  ``verifier_factory`` is called once
per replica; a factory that returns the same instance every time shares one
card-owning verifier among all replicas, and the cluster then closes that
instance once.

With ``storage_dir=`` every replica gets a durable engine under
``<storage_dir>/<server_id>`` (``storage_engine``: ``wal`` or ``paged``), and
:meth:`VirtualCluster.restart_replica` recovers it from disk.

``netsim=`` (a :class:`~mochi_tpu_torch.netsim.NetSim`) conditions every
replica's peer links and every ``vc.client()``'s links.  ``byzantine=``
boots the mapped replicas as live adversaries (``testing/byzantine.py``),
and :meth:`VirtualCluster.byzantine_client` wraps an SDK client in a hostile
coordinator (``testing/byzantine_client.py``).

The external-cluster escape hatch (``MochiVirtualCluster.java:45-49``) is
preserved via ``MOCHI_CLUSTER_CONFIG`` pointing at a properties/JSON file.
"""

from __future__ import annotations

import asyncio
import os
from typing import Callable, Dict, List, Optional

from ..client.client import MochiDBClient
from ..cluster.config import ClusterConfig
from ..crypto.keys import KeyPair, generate_keypair
from ..server.replica import MochiReplica
from ..verifier.spi import SignatureVerifier

EXTERNAL_CONFIG_ENV = "MOCHI_CLUSTER_CONFIG"


class VirtualCluster:
    """``async with VirtualCluster(5, rf=4) as vc: client = vc.client()``."""

    def __init__(
        self,
        n_servers: int = 5,
        rf: int = 4,
        verifier_factory: Optional[Callable[[], SignatureVerifier]] = None,
        require_client_auth: bool = False,
        host: str = "127.0.0.1",
        # Admission control defaults ON — including in-process.  The earlier
        # wall-clock loop-lag signal had to be disabled here (kernel
        # builds and pure-Python crypto stall the shared loop, and the
        # lag monitor shed Write1s in response to the HARNESS); the
        # replacement signal (server/admission.py) counts only queued
        # work, which a stall cannot inflate beyond what clients actually
        # sent, so the flake mode is gone.  ``admission=False`` opts a
        # cluster out; ``shed_lag_ms`` is the retired knob kept as an
        # on/off alias (0 = off) for older call sites.
        admission: Optional[bool] = None,
        shed_lag_ms: Optional[float] = None,
        uds_dir: Optional[str] = None,
        # Network conditioning (mochi_tpu_torch.netsim.NetSim): a topology
        # spec — e.g. NetSim.mesh(seed=8, rtt_ms=13, jitter_ms=1) for "full
        # mesh, 13 ms ± 1 ms RTT" — threaded into every replica's peer pool
        # and every vc.client() SDK instance, with the event schedule armed
        # at cluster start.  None (default): unconditioned loopback.
        netsim=None,
        # Byzantine fault injection (testing/byzantine.py): {server_id:
        # strategy} where strategy is a catalog name ("equivocate",
        # "forge-cert", "stale-replay", "silent", "storm",
        # "session-attack") or an AttackStrategy instance.  Mapped replicas
        # boot as ByzantineReplica — the honest runtime with the strategy
        # spliced into its batch seams — and KEEP the strategy across
        # restart_replica (an adversary does not reform on reboot).
        byzantine: Optional[Dict[str, object]] = None,
        # Durable storage: every replica gets a durable engine rooted at
        # <storage_dir>/<server_id> (WAL + snapshots + verified recovery),
        # and restart_replica then recovers REAL state from disk instead of
        # booting empty.  None (default): in-memory, the reference's
        # posture.
        storage_dir: Optional[str] = None,
        # Which durable engine a storage_dir gets: "wal" (default) or
        # "paged" — None defers to MOCHI_STORAGE_ENGINE.
        storage_engine: Optional[str] = None,
        # Session MAC fast path posture, threaded into every
        # replica AND every vc.client() SDK instance so one knob pins the
        # whole cluster.  None (default) defers to MOCHI_FAST_PATH.
        fast_path: Optional[bool] = None,
    ):
        self.netsim = netsim
        self.byzantine: Dict[str, object] = dict(byzantine or {})
        self.storage_dir = storage_dir
        self.storage_engine = storage_engine
        self.n_servers = n_servers
        self.rf = rf
        self.verifier_factory = verifier_factory
        self.require_client_auth = require_client_auth
        self.host = host
        if admission is None:
            admission = shed_lag_ms is None or shed_lag_ms > 0
        self.admission = admission
        self.fast_path = fast_path
        # Unix-domain sockets instead of loopback TCP (per-replica socket
        # files under this dir): skips the TCP/IP stack on the kernel send
        # path, the measured cost floor for single-host clusters
        # (BASELINE.md).  MOCHI_UDS=1 turns it on for any test/bench.
        self._owns_uds_dir = False
        if uds_dir is None and os.environ.get("MOCHI_UDS") == "1":
            import tempfile

            uds_dir = tempfile.mkdtemp(prefix="mochi-uds-")
            self._owns_uds_dir = True  # close() removes what WE created
        self.uds_dir = uds_dir
        self.replicas: List[MochiReplica] = []
        self.keypairs: Dict[str, KeyPair] = {}
        self.config: Optional[ClusterConfig] = None
        self.client_keys: Dict[str, bytes] = {}
        self._clients: List[MochiDBClient] = []
        self._external = EXTERNAL_CONFIG_ENV in os.environ

    async def start(self) -> "VirtualCluster":
        if self._external:
            path = os.environ[EXTERNAL_CONFIG_ENV]

            def _read() -> str:
                with open(path) as fh:
                    return fh.read()

            text = await asyncio.get_running_loop().run_in_executor(None, _read)
            self.config = (
                ClusterConfig.from_json(text)
                if text.lstrip().startswith("{")
                else ClusterConfig.from_properties(text)
            )
            return self

        if self.netsim is not None:
            self.netsim.ensure_started()  # arm the link-event schedule at t=0

        server_ids = [f"server-{i}" for i in range(self.n_servers)]
        if self.byzantine:
            from .byzantine import check_byzantine_map

            check_byzantine_map(self.byzantine, server_ids)
        self.keypairs = {sid: generate_keypair() for sid in server_ids}

        def host_for(sid: str) -> str:
            if self.uds_dir is not None:
                return f"unix:{os.path.join(self.uds_dir, sid + '.sock')}"
            return self.host

        # Start replicas on ephemeral ports first, then freeze the config with
        # the real ports (replicas share one config object, as the reference's
        # per-server clones share one generated properties set).
        placeholder = ClusterConfig.build(
            {sid: f"{host_for(sid)}:1" for sid in server_ids},
            rf=self.rf,
            public_keys={sid: kp.public_key for sid, kp in self.keypairs.items()},
        )
        for sid in server_ids:
            replica = self._new_replica(
                sid, placeholder, host_for(sid), 0, admission=self.admission
            )
            await replica.start()
            self.replicas.append(replica)
        self.config = ClusterConfig.build(
            {r.server_id: f"{host_for(r.server_id)}:{r.bound_port}" for r in self.replicas},
            rf=self.rf,
            public_keys={sid: kp.public_key for sid, kp in self.keypairs.items()},
        )
        for replica in self.replicas:
            replica.config = self.config
            replica.store.config = self.config
        return self

    def _new_replica(
        self, sid: str, config: ClusterConfig, host: str, port: int, **kwargs
    ) -> MochiReplica:
        """Construct one replica — honest, or a ByzantineReplica when the
        ``byzantine`` map names this server (seeded per server id so each
        adversary's decisions are deterministic run over run)."""
        common = dict(
            server_id=sid,
            config=config,
            keypair=self.keypairs[sid],
            verifier=self.verifier_factory() if self.verifier_factory else None,
            client_public_keys=self.client_keys,
            require_client_auth=self.require_client_auth,
            host=host,
            port=port,
            netsim=self.netsim,
            fast_path=self.fast_path,
            storage_dir=self.storage_dir,
            storage_engine=self.storage_engine,
            **kwargs,
        )
        strategy = self.byzantine.get(sid)
        if strategy is None:
            return MochiReplica(**common)
        from .byzantine import ByzantineReplica

        return ByzantineReplica(
            strategy=strategy,
            strategy_seed=sum(sid.encode()),
            **common,
        )

    def honest_replicas(self) -> List[MochiReplica]:
        """The replicas the safety invariants constrain (testing/invariants)."""
        return [r for r in self.replicas if r.server_id not in self.byzantine]

    def client(self, **kwargs) -> MochiDBClient:
        assert self.config is not None, "cluster not started"
        if self.fast_path is not None:
            kwargs.setdefault("fast_path", self.fast_path)
        if self.netsim is not None and "netsim" not in kwargs:
            kwargs["netsim"] = self.netsim
        if kwargs.get("netsim") is not None:
            # Stable sequential labels (client-0, client-1, ...), not the
            # per-run uuid client_id: link RNG streams are seeded from the
            # (seed, src, dst) triple, and determinism requires the labels
            # to be identical run over run — also for callers passing
            # their own netsim= explicitly.
            kwargs.setdefault("netsim_label", f"client-{len(self._clients)}")
        client = MochiDBClient(config=self.config, **kwargs)
        self.client_keys[client.client_id] = client.keypair.public_key
        self._clients.append(client)
        return client

    def byzantine_client(self, strategy: str = "withhold", seed: int = 0, **kwargs):
        """A Byzantine CLIENT (testing/byzantine_client.py) wrapping a real
        SDK instance from :meth:`client` — real keypair, real sessions,
        registered like any client — so its hostile traffic is validly
        authenticated.  Composable with the ``byzantine={...}`` replica
        adversaries in the same cluster."""
        from .byzantine_client import ByzantineClient

        return ByzantineClient(self.client(**kwargs), strategy=strategy, seed=seed)

    def replica(self, server_id: str) -> MochiReplica:
        return next(r for r in self.replicas if r.server_id == server_id)

    async def restart_replica(
        self, server_id: str, resync: bool = False, before_boot=None
    ) -> MochiReplica:
        """Kill a replica and boot a fresh one on the same port.  Without
        ``storage_dir`` the fresh replica starts EMPTY (in-memory, as in
        the reference) — the scenario the resync protocol exists for; with
        it, boot recovers the replica's committed state from its WAL and
        snapshot (or pages), re-verifying every stored grant signature
        through the replica's verifier, and ``resync=True`` then only
        ships the DELTA written since the crash.

        ``before_boot`` (sync or async callable, given ``server_id``) runs
        in the window after the old replica is down and before the fresh
        one boots: the seam where crash tests tamper with or restore
        on-disk storage state, and where delta-resync tests commit the
        writes the victim must catch up on.  A verifier that other
        replicas share stays open."""
        old = self.replica(server_id)
        port = old.bound_port
        if old.verifier is not None and not any(
            r is not old and r.verifier is old.verifier for r in self.replicas
        ):
            await old.verifier.close()
        await old.close()
        if before_boot is not None:
            import inspect

            result = before_boot(server_id)
            if inspect.isawaitable(result):
                await result
        # same endpoint the config advertises (UDS path or TCP host); a
        # byzantine-mapped server comes back byzantine (fresh strategy state)
        fresh = self._new_replica(
            server_id,
            self.config,
            self.config.servers[server_id].host,
            port,
            # keep the cluster's admission-control posture across restarts
            # (the earlier restart path silently flipped restarted
            # replicas to MochiReplica's default)
            admission=self.admission,
        )
        await fresh.start()
        if old in self.replicas:
            self.replicas[self.replicas.index(old)] = fresh
        else:
            # a close() or another restart of server_id ran during the awaits
            # above and retired ``old``: the fresh replica has no slot
            await fresh.close()
            raise RuntimeError(f"{server_id} was retired while it restarted")
        if resync:
            await fresh.resync()
        return fresh

    async def close(self) -> None:
        # pop-until-empty on both lists: client()/restart_replica() racing a
        # close() would mutate them mid-iteration (the awaits in the body
        # suspend the loop) — late registrations get closed, not leaked
        while self._clients:
            await self._clients.pop().close()
        verifiers: List[SignatureVerifier] = []
        while self.replicas:
            replica = self.replicas.pop()
            if replica.verifier is not None and not any(
                v is replica.verifier for v in verifiers
            ):
                verifiers.append(replica.verifier)
            await replica.close()
        # each distinct verifier once: a factory may share one instance (the
        # card-owning CudaBatchVerifier) among every replica
        for verifier in verifiers:
            await verifier.close()
        if self.netsim is not None:
            self.netsim.close()  # cancel schedule timers + in-flight frames
        if self._owns_uds_dir and self.uds_dir is not None:
            import functools
            import shutil

            await asyncio.get_running_loop().run_in_executor(
                None, functools.partial(shutil.rmtree, self.uds_dir, ignore_errors=True)
            )
            self.uds_dir = None

    async def __aenter__(self) -> "VirtualCluster":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()
