"""Process-per-replica cluster: N real OS processes, same API as VirtualCluster.

``VirtualCluster`` time-slices every replica over ONE event loop — one core,
whatever the host has.  This twin spreads the cluster's replicas over
``n_processes`` real ``python -m mochi_tpu_torch.server`` processes (each
hosting ``n_servers / n_processes`` replicas on its own event loop), so
aggregate throughput scales with cores instead of saturating one:

* ``n_processes=1``   — the single-process baseline (all replicas share one
  child process's loop; the client drives from the parent);
* ``n_processes=n_servers`` — process-per-replica, one process per core on
  a large host: the shard-per-core posture.

API parity with ``VirtualCluster`` where it can exist across a process
boundary: ``async with ProcessCluster(...) as pc``, ``pc.client()``,
``pc.config``, ``close()``.  What cannot carry over: in-process
``MochiReplica`` objects (use the admin shell / ``kill_replica`` instead)
and ``netsim`` (the sim conditions frames inside one process's transport).

The verifier posture (``verifier``, passed to every child as ``--verifier``):

* ``"cuda"`` (the default, the server's own) — each child builds ONE
  ``CudaBatchVerifier`` on the card, shared by its hosted replicas, with the
  cluster's replica identities registered for the comb kernel.  A child
  without a card exits at boot, and ``start()`` raises with its log tail;
  nothing verifies on the CPU instead.
* ``"cpu"`` — the inline host verifier in every replica (no torch import).
* ``"service"`` — ALSO spawn one ``python -m mochi_tpu_torch.verifier.service``
  sidecar (``--backend service_backend``: ``cuda`` by default, or
  ``cuda-sharded`` / ``cpu``) that owns the card, with the replica
  identities as its known signers, and point every replica at it
  (``remote:127.0.0.1:<port>``).  Its cache collapses the rf duplicate
  grant checks of one certificate into one verification cluster-wide.

Lifecycle contract with ``server/__main__.py``:

* readiness — each replica prints ``READY <sid> <port>`` on stdout; start()
  blocks until every hosted replica of every process reported (crash during
  boot surfaces the child's log tail, not a hang); ``ready_seconds`` keeps
  each process's seconds from spawn to its last READY, for the first boot
  and for every restart;
* drain — ``close()`` SIGTERMs the children, which stop accepting, finish
  admitted work, flush coalesced writes, snapshot (if configured) and exit
  0; non-zero exits are collected in ``returncodes`` for tests to assert;
* crash detection — ``check_alive()`` raises if any child exited early,
  and ``kill_replica(sid)`` SIGKILLs the process hosting ``sid`` for
  fault-injection tests (with process-per-replica, exactly one replica).

With ``admin_base_port`` every child serves the admin shell: process ``pi``'s
``j``-th hosted replica on ``admin_base_port + pi * n_servers + j``
(:meth:`admin_port`), and the sidecar on ``admin_base_port + n_processes *
n_servers`` (:attr:`service_admin_port`).

``byzantine=`` ({server id: strategy name}) hosts the mapped replicas as
live adversaries (``--byzantine sid=strategy`` in the hosting child), and
:meth:`byzantine_client` wraps an SDK client in a hostile coordinator —
the cross-process twins of ``VirtualCluster``'s.
"""

from __future__ import annotations

import asyncio
import os
import signal
import socket
import sys
import tempfile
import time
from typing import Dict, List, Optional

from ..client.client import MochiDBClient
from ..cluster.config import ClusterConfig
from ..crypto.keys import KeyPair, generate_keypair

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SERVICE_BACKENDS = ("cuda", "cuda-sharded", "cpu")


def _free_tcp_ports(n: int) -> List[int]:
    """Pre-pick n distinct free TCP ports (bind-then-close; the usual small
    race window is why UDS is the default on posix)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _ServerProcess:
    """One child ``python -m mochi_tpu_torch.server`` hosting >= 1 replicas."""

    def __init__(self, index: int, server_ids: List[str], log_path: str):
        self.index = index
        self.server_ids = server_ids
        self.log_path = log_path
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.returncode: Optional[int] = None
        self._pump_task: Optional[asyncio.Task] = None
        # full spawn argv, kept so restart_replica can re-launch this exact
        # posture (same ids, same --storage-dir, same knobs) after a kill
        self.argv: List[str] = []
        self.spawned_at = 0.0

    @property
    def name(self) -> str:
        return "verifier-service" if self.index < 0 else f"proc-{self.index}"

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def cpu_seconds(self) -> Optional[float]:
        """utime+stime of the live child from /proc (None once reaped)."""
        if self.proc is None or self.proc.returncode is not None:
            return None
        try:
            with open(f"/proc/{self.proc.pid}/stat", "rb") as f:
                fields = f.read().rsplit(b")", 1)[1].split()
            return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            return None

    def log_tail(self, n: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return f.read()[-n:].decode(errors="replace")
        except OSError:
            return "<no log>"


class ProcessCluster:
    """``async with ProcessCluster(6, rf=4, n_processes=2, verifier="cpu") as pc: ...``"""

    def __init__(
        self,
        n_servers: int = 5,
        rf: int = 4,
        n_processes: Optional[int] = None,
        uds: bool = True,
        # "cuda" | "cpu" | "service" (module docstring); any other value is
        # passed to the children's --verifier as it is (remote:<host>:<port>)
        verifier: str = "cuda",
        # the sidecar's --backend in the "service" posture
        service_backend: str = "cuda",
        # Admission control (deterministic load signal, server/admission.py)
        # defaults ON in every posture — the queued-work signal cannot be
        # tripped by replicas sharing a child's loop the way the retired
        # wall-clock lag signal was.
        admission: bool = True,
        admin_base_port: Optional[int] = None,
        data_dir: Optional[str] = None,
        ready_timeout_s: float = 60.0,
        drain_timeout_s: float = 5.0,
        env: Optional[Dict[str, str]] = None,
        # Pin server process i to core i % cpu_count (the shard-per-core
        # deployment discipline: one replica process per core, no migration
        # thrash).  The client process is left unpinned so the
        # scheduler can fill the remaining capacity.
        pin_cores: bool = False,
        # Byzantine fault injection across a REAL process boundary:
        # {server_id: strategy name} forwarded to the hosting child as
        # ``--byzantine sid=strategy`` (testing/byzantine.py catalog) —
        # the cross-process twin of VirtualCluster(byzantine=...).
        byzantine: Optional[Dict[str, str]] = None,
        # Durable storage across the REAL process boundary: True roots a
        # per-replica WAL+snapshot engine inside the cluster tmpdir (lives
        # exactly as long as the cluster — the kill/restart window this
        # exists for); a string roots it at that path.  ``kill_replica`` +
        # ``restart_replica`` preserve it, so SIGKILL-mid-load -> restart ->
        # recover-from-disk runs against real processes.  ``wal_fsync``
        # forwards --wal-fsync.
        storage_dir=None,
        wal_fsync: Optional[str] = None,
        # forwards --storage-engine ("wal"/"paged"); None defers to the
        # child's MOCHI_STORAGE_ENGINE (or "wal")
        storage_engine: Optional[str] = None,
    ):
        if n_processes is None:
            n_processes = min(n_servers, os.cpu_count() or 1)
        if not 1 <= n_processes <= n_servers:
            raise ValueError(
                f"n_processes={n_processes} outside [1, n_servers={n_servers}]"
            )
        if service_backend not in SERVICE_BACKENDS:
            raise ValueError(
                f"service_backend={service_backend!r}: use one of {SERVICE_BACKENDS}"
            )
        self.n_servers = n_servers
        self.rf = rf
        self.n_processes = n_processes
        self.uds = uds and os.name == "posix"
        self.verifier = verifier
        self.service_backend = service_backend
        self.admission = admission
        self.admin_base_port = admin_base_port
        self.data_dir = data_dir
        self.ready_timeout_s = ready_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.pin_cores = pin_cores
        self.storage_dir = storage_dir
        self.wal_fsync = wal_fsync
        self.storage_engine = storage_engine
        self.byzantine: Dict[str, str] = dict(byzantine or {})
        # resolved at start(): True -> <tmpdir>/storage, str -> that path
        self.storage_root: Optional[str] = None
        self._extra_env = dict(env or {})
        self._spawn_env: Optional[Dict[str, str]] = None
        self.config: Optional[ClusterConfig] = None
        self.keypairs: Dict[str, KeyPair] = {}
        self.processes: List[_ServerProcess] = []
        self.service_process: Optional[_ServerProcess] = None
        # sid -> the _ServerProcess hosting it (kill_replica's map)
        self.host_process: Dict[str, _ServerProcess] = {}
        self.returncodes: Dict[int, int] = {}  # process index -> exit code
        # process name -> seconds from each spawn to its last READY line
        self.ready_seconds: Dict[str, List[float]] = {}
        self._clients: List[MochiDBClient] = []
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> "ProcessCluster":
        self._tmpdir = tempfile.TemporaryDirectory(prefix="mochi-pc-")
        out = self._tmpdir.name
        server_ids = [f"server-{i}" for i in range(self.n_servers)]
        if self.byzantine:
            # in the parent: spares a spawn-and-crash cycle
            from .byzantine import check_byzantine_map

            check_byzantine_map(self.byzantine, server_ids)
        self.keypairs = {sid: generate_keypair() for sid in server_ids}
        if self.uds:
            paths = {sid: os.path.join(out, sid + ".sock") for sid in server_ids}
            too_long = [p for p in paths.values() if len(p) > 100]
            if too_long:
                raise RuntimeError(
                    f"tmpdir too deep for AF_UNIX paths (>100 chars): {too_long[0]}"
                )
            urls = {sid: f"unix:{p}:0" for sid, p in paths.items()}
        else:
            ports = _free_tcp_ports(self.n_servers)
            urls = {
                sid: f"127.0.0.1:{port}" for sid, port in zip(server_ids, ports)
            }
        self.config = ClusterConfig.build(
            urls,
            rf=self.rf,
            public_keys={sid: kp.public_key for sid, kp in self.keypairs.items()},
        )
        cfg_path = os.path.join(out, "cluster_config.json")
        signers_path = os.path.join(out, "signers.txt")
        loop = asyncio.get_running_loop()

        def _write_boot_files() -> None:
            with open(cfg_path, "w") as fh:
                fh.write(self.config.to_json())
            for sid, kp in self.keypairs.items():
                with open(os.path.join(out, f"{sid}.seed"), "w") as fh:
                    fh.write(kp.private_seed.hex())
            with open(signers_path, "w") as fh:
                fh.write("".join(kp.public_key.hex() + "\n" for kp in self.keypairs.values()))

        await loop.run_in_executor(None, _write_boot_files)

        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        env.update(self._extra_env)
        self._spawn_env = env
        if self.storage_dir:
            self.storage_root = (
                self.storage_dir
                if isinstance(self.storage_dir, str)
                else os.path.join(out, "storage")
            )

        # Round-robin replica -> process assignment: any transaction's
        # replica set (a contiguous ring window) spans processes, so the
        # cluster runs real cross-process quorums at every packing.
        groups: List[List[str]] = [[] for _ in range(self.n_processes)]
        for i, sid in enumerate(server_ids):
            groups[i % self.n_processes].append(sid)
        replica_verifier = self.verifier
        try:
            if self.verifier == "service":
                vport = _free_tcp_ports(1)[0]
                sp = _ServerProcess(
                    -1, ["verifier-service"], os.path.join(out, "verifier.log")
                )
                # the replica identities are the service's known signers:
                # their grant signatures take the comb kernel
                sp.argv = [
                    sys.executable, "-m", "mochi_tpu_torch.verifier.service",
                    "--port", str(vport), "--backend", self.service_backend,
                    "--signers-file", signers_path,
                ]
                if self.service_admin_port is not None:
                    sp.argv += ["--admin-port", str(self.service_admin_port)]
                await self._spawn(sp)
                self.service_process = sp
                replica_verifier = f"remote:127.0.0.1:{vport}"
            for pi, group in enumerate(groups):
                sp = _ServerProcess(pi, group, os.path.join(out, f"proc-{pi}.log"))
                argv = [sys.executable, "-m", "mochi_tpu_torch.server", "--config", cfg_path]
                for sid in group:
                    argv += ["--server-id", sid]
                    argv += ["--seed-file", os.path.join(out, f"{sid}.seed")]
                for sid in group:
                    if sid in self.byzantine:
                        argv += ["--byzantine", f"{sid}={self.byzantine[sid]}"]
                argv += [
                    "--verifier", replica_verifier,
                    "--admission", "on" if self.admission else "off",
                    "--drain-timeout", str(self.drain_timeout_s),
                ]
                if self.admin_base_port is not None:
                    # process pi's replica j serves base + pi*n_servers + j
                    argv += ["--admin-port", str(self.admin_base_port + pi * self.n_servers)]
                if self.data_dir:
                    argv += ["--data-dir", self.data_dir]
                if self.storage_root:
                    argv += ["--storage-dir", self.storage_root]
                    if self.wal_fsync:
                        argv += ["--wal-fsync", self.wal_fsync]
                    if self.storage_engine:
                        argv += ["--storage-engine", self.storage_engine]
                sp.argv = argv
                await self._spawn(sp)
                self.processes.append(sp)
                for sid in group:
                    self.host_process[sid] = sp
            waiters = [self._wait_ready(sp) for sp in self.processes]
            if self.service_process is not None:
                waiters.append(self._wait_ready(self.service_process))
            await asyncio.wait_for(
                asyncio.gather(*waiters), timeout=self.ready_timeout_s
            )
        except BaseException:
            await self.close()
            raise
        return self

    async def _spawn(self, sp: _ServerProcess) -> None:
        """Start ``sp.argv`` with stdout piped (READY lines) and stderr to
        the process's log; pin it to a core under ``pin_cores``."""
        loop = asyncio.get_running_loop()
        log = await loop.run_in_executor(None, open, sp.log_path, "ab")
        try:
            sp.spawned_at = time.perf_counter()
            sp.proc = await asyncio.create_subprocess_exec(
                *sp.argv, env=self._spawn_env,
                stdout=asyncio.subprocess.PIPE, stderr=log,
            )
        finally:
            log.close()  # child holds its own descriptor now
        sp.returncode = None
        if self.pin_cores and sp.index >= 0 and hasattr(os, "sched_setaffinity"):
            try:
                os.sched_setaffinity(sp.proc.pid, {sp.index % (os.cpu_count() or 1)})
            except OSError:
                pass  # affinity is an optimization, never a failure

    async def _wait_ready(self, sp: _ServerProcess) -> None:
        """Block until every replica hosted by ``sp`` printed READY; a child
        that exits (or closes stdout) first fails with its log tail."""
        assert sp.proc is not None and sp.proc.stdout is not None
        waiting = set(sp.server_ids)
        while waiting:
            line = await sp.proc.stdout.readline()
            if not line:
                rc = await sp.proc.wait()
                raise RuntimeError(
                    f"{sp.name} (hosting {sp.server_ids}) died before READY "
                    f"(rc={rc}): {sp.log_tail()}"
                )
            parts = line.decode(errors="replace").split()
            if len(parts) >= 2 and parts[0] == "READY":
                waiting.discard(parts[1])
        self.ready_seconds.setdefault(sp.name, []).append(time.perf_counter() - sp.spawned_at)
        # Keep draining stdout so the child can never block on a full pipe.
        sp._pump_task = asyncio.ensure_future(self._pump(sp))

    @staticmethod
    async def _pump(sp: _ServerProcess) -> None:
        assert sp.proc is not None and sp.proc.stdout is not None
        while True:
            line = await sp.proc.stdout.readline()
            if not line:
                return

    # ------------------------------------------------------------------ API

    def client(self, **kwargs) -> MochiDBClient:
        assert self.config is not None, "cluster not started"
        client = MochiDBClient(config=self.config, **kwargs)
        self._clients.append(client)
        return client

    def byzantine_client(self, strategy: str = "withhold", seed: int = 0, **kwargs):
        """Byzantine CLIENT over the real process boundary: same wrapper as
        ``VirtualCluster.byzantine_client`` — the children see validly
        signed hostile traffic arriving over real sockets."""
        from .byzantine_client import ByzantineClient

        return ByzantineClient(self.client(**kwargs), strategy=strategy, seed=seed)

    def admin_port(self, server_id: str) -> int:
        """The admin shell port of ``server_id`` (needs ``admin_base_port``)."""
        assert self.admin_base_port is not None, "no admin_base_port"
        sp = self.host_process[server_id]
        return self.admin_base_port + sp.index * self.n_servers + sp.server_ids.index(server_id)

    @property
    def service_admin_port(self) -> Optional[int]:
        """The sidecar's admin port ("service" posture with ``admin_base_port``)."""
        if self.verifier != "service" or self.admin_base_port is None:
            return None
        return self.admin_base_port + self.n_processes * self.n_servers

    def check_alive(self) -> None:
        """Raise if any child exited (crash detection between test phases)."""
        for sp in self.processes + [p for p in (self.service_process,) if p is not None]:
            if sp.proc is not None and sp.proc.returncode is not None:
                raise RuntimeError(
                    f"{sp.name} (hosting {sp.server_ids}) exited "
                    f"rc={sp.proc.returncode}: {sp.log_tail()}"
                )

    def process_for(self, server_id: str) -> _ServerProcess:
        return self.host_process[server_id]

    def kill_replica(self, server_id: str, sig: int = signal.SIGKILL) -> int:
        """Signal the process hosting ``server_id`` (SIGKILL by default: the
        crash-fault injection for f=1 tests).  With process-per-replica this
        takes down exactly that replica; with packed processes it takes its
        whole group — the caller picks the packing to match the fault model.
        Returns the pid signalled."""
        sp = self.host_process[server_id]
        assert sp.proc is not None
        sp.proc.send_signal(sig)
        return sp.proc.pid

    async def restart_replica(self, server_id: str) -> None:
        """Re-launch the (killed or exited) process hosting ``server_id``
        with its EXACT original argv — same ids, same ``--storage-dir``,
        same knobs — and block until every hosted replica reprints READY.
        With a durable ``storage_dir`` the child recovers its committed
        state from its own WAL + snapshot before READY (verified replay,
        every stored grant re-checked by its verifier); without one it
        boots empty, the posture the resync protocol covers.  The
        cross-process twin of ``VirtualCluster.restart_replica``."""
        sp = self.host_process[server_id]
        assert sp.proc is not None and sp.argv, "cluster not started"
        if sp.proc.returncode is None:
            raise RuntimeError(
                f"{sp.name} (hosting {sp.server_ids}) is still alive; "
                "kill_replica() first"
            )
        await self._reap([sp])  # collect the corpse + stop its pump
        # mochi-lint: disable=await-races -- sp is identity-stable: host_process is written once in start() and cleared only in close(); the reap cannot remap which process hosts server_id
        await self._spawn(sp)
        await asyncio.wait_for(self._wait_ready(sp), timeout=self.ready_timeout_s)

    def cpu_seconds(self) -> Dict[str, float]:
        """Per-process CPU (utime+stime) of the live children, keyed
        ``proc-<i>`` (+ ``verifier-service`` in the sidecar posture)."""
        out = {}
        for sp in self.processes + [p for p in (self.service_process,) if p is not None]:
            cpu = sp.cpu_seconds()
            if cpu is not None:
                out[sp.name] = cpu
        return out

    async def close(self) -> None:
        # pop-until-empty: a client registered concurrently with close()
        # is closed too instead of tripping "changed size during iteration"
        while self._clients:
            await self._clients.pop().close()
        # TERM the replicas first (drains run concurrently) and collect
        # them; the verifier sidecar is signalled ONLY after every replica
        # has exited — a draining replica's admitted Write2 work still
        # RPCs certificate checks to the service, so stopping the service
        # concurrently would abort the drained tail of acknowledged work.
        for sp in self.processes:
            if sp.proc is not None and sp.proc.returncode is None:
                try:
                    sp.proc.terminate()
                except ProcessLookupError:
                    pass
        await self._reap(self.processes)
        if self.service_process is not None:
            sp = self.service_process
            self.service_process = None
            if sp.proc is not None and sp.proc.returncode is None:
                try:
                    # SIGINT: the service entrypoint's clean-exit path
                    sp.proc.send_signal(signal.SIGINT)
                except ProcessLookupError:
                    pass
            await self._reap([sp])
        self.processes.clear()
        self.host_process.clear()
        if self._tmpdir is not None:
            try:
                self._tmpdir.cleanup()
            except OSError:
                pass
            self._tmpdir = None

    async def _reap(self, procs: List[_ServerProcess]) -> None:
        for sp in procs:
            if sp.proc is None:
                continue
            try:
                rc = await asyncio.wait_for(
                    sp.proc.wait(), timeout=self.drain_timeout_s + 10.0
                )
            except asyncio.TimeoutError:
                sp.proc.kill()
                rc = await sp.proc.wait()
            sp.returncode = rc
            self.returncodes[sp.index] = rc
            if sp._pump_task is not None:
                sp._pump_task.cancel()
                try:
                    await sp._pump_task
                except asyncio.CancelledError:
                    pass  # the cancellation we just requested
                except Exception:
                    pass  # pump death must not mask the child's exit status
                sp._pump_task = None

    async def __aenter__(self) -> "ProcessCluster":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()
