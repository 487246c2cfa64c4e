"""Cluster configuration: token-ring sharding, replica sets, BFT quorum math.

Capability parity with the reference's ``server/ClusterConfiguration.java``
(token ring of 1024 fixed tokens over a hash space, properties-file schema,
RF/f/quorum arithmetic, round-robin bootstrap token assignment), with two
deliberate behavioral fixes documented in SURVEY.md §2.6:

* the replica-set ring walk starts at the key's token and walks *forward*
  collecting distinct owners — the reference looks up token ``i`` instead of
  the i-th ring position (``ClusterConfiguration.java:215``), collapsing every
  key onto one replica set;
* ``f`` is derived as ``(rf - 1) // 3`` (BFT requires n >= 3f + 1), where the
  reference computes ``f = rf / 3`` (``ClusterConfiguration.java:260-267``),
  which overstates f for rf in {6, 9, ...}.  For the shipped rf=4 both give
  f=1, quorum=3.

Also supports the reference's Java-properties config format
(``_CONFIG_SERVERS`` / ``_CONFIG_BFT_REPLICATION`` /
``_CONFIG_SERVER_<id>_TOKENS`` / ``_CONFIG_SERVER_<id>_URL``, see
``config/sample_config``) so existing cluster files carry over, plus a native
JSON format.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Sequence

SHARD_TOKENS = 1024  # ref: ClusterConfiguration.java:26

PROPERTY_SERVERS = "_CONFIG_SERVERS"
PROPERTY_BFT_REPLICATION = "_CONFIG_BFT_REPLICATION"
PROPERTY_SERVER_TOKENS = "_CONFIG_SERVER_{}_TOKENS"
PROPERTY_SERVER_URL = "_CONFIG_SERVER_{}_URL"
CONFIG_KEY_PREFIX = "_CONFIG_"  # keys routed to the config keyspace (ref: InMemoryDataStore.java:44)
# The cluster-membership document itself, stored in the config keyspace and
# committed through the normal 2-phase write protocol (paper's "Configuration
# changes", mochiDB.tex:184-199 — declared, never implemented in the
# reference).  Writing a higher-configstamp config here IS the reconfiguration.
CONFIG_CLUSTER_KEY = CONFIG_KEY_PREFIX + "CLUSTER"
# Immutable archive of configs by stamp ("_CONFIG_CLUSTER_CS_<stamp>",
# zero-padded so string sort == numeric sort), written by the
# reconfiguration transaction itself.  Two roles: (a) certificates formed
# under configstamp N are validated against config N; (b) the FORWARD
# catch-up chain — the reconfig i->i+1 transaction archives doc(i+1) under
# a certificate stamped i, so a replica that knows config i can validate
# and install i+1, then i+2, ... in one sorted sweep (a laggard that missed
# several reconfigurations is never wedged).
CONFIG_ARCHIVE_PREFIX = CONFIG_CLUSTER_KEY + "_CS_"


def config_archive_key(configstamp: int) -> str:
    return f"{CONFIG_ARCHIVE_PREFIX}{configstamp:010d}"


# Durable client key registry ("_CONFIG_CLIENT_<client_id>" -> 32-byte
# Ed25519 pubkey), committed through the normal write path and — like the
# membership document — admin-gated when config.admin_keys is set.  This is
# what makes --require-client-auth deployable: replicas resolve unknown
# senders against the registry.
CONFIG_CLIENT_PREFIX = CONFIG_KEY_PREFIX + "CLIENT_"


def config_client_key(client_id: str) -> str:
    return f"{CONFIG_CLIENT_PREFIX}{client_id}"


@dataclass(frozen=True)
class ServerInfo:
    """Addressable replica endpoint (ref: ``server/messaging/Server.java``)."""

    server_id: str
    host: str
    port: int

    @classmethod
    def from_url(cls, server_id: str, url: str) -> "ServerInfo":
        """``host:port``, or ``unix:<path>:0`` for a Unix-domain socket
        (local clusters: skips the loopback TCP/IP stack — the kernel
        send-path is the measured cost floor on single-host deployments).
        rpartition: a UDS path contains ':' after the scheme."""
        host, _, port = url.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad server url (want host:port, or unix:<path>:0): {url!r}"
            )
        return cls(server_id=server_id, host=host, port=int(port))

    @property
    def is_unix(self) -> bool:
        return self.host.startswith("unix:")

    @property
    def unix_path(self) -> str:
        assert self.is_unix
        return self.host[len("unix:"):]

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"


def stable_key_hash(key: str) -> int:
    """Stable 64-bit hash of a key, uniform over the hash space.

    The reference hashes into an unsigned-int space via Java's string hash
    (``ClusterConfiguration.java:227-243``); we use SHA-512-prefix for a
    process-independent, well-distributed hash (the reference already uses
    SHA-512 as its only digest, ``Utils.java:135-148``).
    """
    digest = hashlib.sha512(key.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def round_robin_token_assignment(server_ids: Sequence[str]) -> Dict[str, List[int]]:
    """Deal the 1024 ring tokens round-robin across servers.

    Bootstrap-time equivalent of ``putTokensAroundRingProps``
    (ref: ``ClusterConfiguration.java:85-116``).
    """
    assignment: Dict[str, List[int]] = {sid: [] for sid in server_ids}
    n = len(server_ids)
    for token in range(SHARD_TOKENS):
        assignment[server_ids[token % n]].append(token)
    return assignment


@dataclass
class ClusterConfig:
    """Immutable-ish view of cluster membership, sharding and quorum shape."""

    servers: Dict[str, ServerInfo]
    token_owners: List[str]  # token index -> server_id, len == SHARD_TOKENS
    rf: int  # BFT replication factor (ref: _CONFIG_BFT_REPLICATION)
    configstamp: int = 1  # ref: ClusterConfiguration.java:41 (reconfiguration epoch)
    public_keys: Dict[str, bytes] = field(default_factory=dict)  # server_id -> Ed25519 pubkey (32B)
    # Ed25519 public keys allowed to commit _CONFIG_CLUSTER* writes (the
    # paper's "client with admin privilege", mochiDB.tex:191).  Empty = open
    # (dev/test posture, matching the reference's total lack of auth).
    admin_keys: List[bytes] = field(default_factory=list)
    # token -> replica set memo: the ring walk is O(SHARD_TOKENS) and sits on
    # every request's hot path (client targeting + server owns()/coalesce).
    # Invalidated implicitly by constructing a new config (reconfiguration
    # bumps configstamp and rebuilds the object; token_owners is never
    # mutated in place).
    _replica_set_cache: Dict[int, List[str]] = field(
        default_factory=dict, repr=False, compare=False
    )
    # key -> token memo: token_for_key is called for EVERY operation of
    # every request on both sides (client routing, replica owns(), quorum
    # tallies — ~200 calls per 32-op transaction, r10 profile) and each
    # miss pays a SHA-512.  Bounded: cleared wholesale at capacity — a
    # working set larger than the bound just degrades to the old
    # hash-every-time behavior for one generation.
    _token_cache: Dict[str, int] = field(
        default_factory=dict, repr=False, compare=False
    )

    # ---------------------------------------------------------------- quorums

    @property
    def n_servers(self) -> int:
        return len(self.servers)

    @property
    def f(self) -> int:
        """Max tolerated Byzantine faults: n >= 3f+1 within a replica set."""
        return (self.rf - 1) // 3

    @property
    def quorum(self) -> int:
        """Write/read quorum 2f+1 (ref: ``ClusterConfiguration.java:264-267``;
        the implementation uses 2f+1 for reads too, stricter than the paper's
        f+1 — ``MochiDBClient.java:171-175``)."""
        return 2 * self.f + 1

    # --------------------------------------------------------------- sharding

    _TOKEN_CACHE_MAX = 65536

    def token_for_key(self, key: str) -> int:
        token = self._token_cache.get(key)
        if token is None:
            if key.startswith(CONFIG_KEY_PREFIX):
                # Config-space keys are owned everywhere
                # (ref: InMemoryDataStore.java:64-73)
                token = 0
            else:
                token = (stable_key_hash(key) * SHARD_TOKENS) >> 64
            if len(self._token_cache) >= self._TOKEN_CACHE_MAX:
                self._token_cache.clear()
            self._token_cache[key] = token
        return token

    def replica_set_for_token(self, token: int) -> List[str]:
        """Walk the ring forward from ``token`` collecting RF distinct owners.

        This is the *intended* semantic of ``getServersForObject``
        (ref: ``ClusterConfiguration.java:207-226``, intended per
        ``mochiDB.tex:173-183``; the shipped code's lookup bug is fixed here).
        """
        cached = self._replica_set_cache.get(token)
        if cached is not None:
            return cached
        owners: List[str] = []
        seen = set()
        for i in range(SHARD_TOKENS):
            owner = self.token_owners[(token + i) % SHARD_TOKENS]
            if owner not in seen:
                seen.add(owner)
                owners.append(owner)
                if len(owners) == self.rf:
                    self._replica_set_cache[token] = owners
                    return owners
        raise ValueError(
            f"ring has only {len(owners)} distinct owners < rf={self.rf}"
        )

    def replica_set_for_key(self, key: str) -> List[str]:
        if key.startswith(CONFIG_KEY_PREFIX):
            return sorted(self.servers)
        return self.replica_set_for_token(self.token_for_key(key))

    def servers_for_key(self, key: str) -> List[ServerInfo]:
        return [self.servers[sid] for sid in self.replica_set_for_key(key)]

    def owns_key(self, server_id: str, key: str) -> bool:
        """Shard-ownership check (ref: ``objectBelongsToCurrentShardServer``,
        ``InMemoryDataStore.java:64-73``)."""
        return key.startswith(CONFIG_KEY_PREFIX) or server_id in self.replica_set_for_key(key)

    # ------------------------------------------------------------- validation

    def validate(self) -> None:
        """Full-coverage + RF checks (ref: ``ClusterConfiguration.java:167-186``)."""
        if len(self.token_owners) != SHARD_TOKENS:
            raise ValueError(
                f"token ring must have exactly {SHARD_TOKENS} tokens, got {len(self.token_owners)}"
            )
        unknown = {s for s in self.token_owners if s not in self.servers}
        if unknown:
            raise ValueError(f"tokens assigned to unknown servers: {sorted(unknown)}")
        if self.rf < 4:
            raise ValueError(f"BFT replication factor must be >= 4 (3f+1, f>=1), got {self.rf}")
        if self.rf > self.n_servers:
            raise ValueError(f"rf={self.rf} exceeds cluster size {self.n_servers}")

    # ------------------------------------------------------------ constructors

    @classmethod
    def build(
        cls,
        servers: Mapping[str, str],
        rf: int,
        public_keys: Mapping[str, bytes] | None = None,
    ) -> "ClusterConfig":
        """Build a config from {server_id: "host:port"} with round-robin tokens
        (deterministic over sorted ids, as the test framework does —
        ref: ``MochiVirtualCluster.java:95-101``)."""
        ids = sorted(servers)
        assignment = round_robin_token_assignment(ids)
        token_owners = [""] * SHARD_TOKENS
        for sid, tokens in assignment.items():
            for t in tokens:
                token_owners[t] = sid
        cfg = cls(
            servers={sid: ServerInfo.from_url(sid, url) for sid, url in servers.items()},
            token_owners=token_owners,
            rf=rf,
            public_keys=dict(public_keys or {}),
        )
        cfg.validate()
        return cfg

    def evolve(
        self,
        servers: Mapping[str, str],
        public_keys: Mapping[str, bytes] | None = None,
        rf: int | None = None,
    ) -> "ClusterConfig":
        """Next-configstamp config with the given membership.

        Token movement is MINIMAL — the property the consistent-hash ring
        exists for: surviving servers keep their tokens; only tokens of
        removed servers are reassigned, and added servers steal an even
        share (~1024/n) from the most-loaded members.  A full round-robin
        re-deal would move ~(n-1)/n of all keys and trigger an O(n^2 *
        store) resync storm.  Public keys of surviving members carry over;
        new members must be supplied.
        """
        merged = {
            sid: pk for sid, pk in self.public_keys.items() if sid in servers
        }
        merged.update(public_keys or {})
        new_ids = sorted(servers)
        owners = list(self.token_owners)
        load: Dict[str, List[int]] = {sid: [] for sid in new_ids}
        orphans: List[int] = []
        for t, sid in enumerate(owners):
            if sid in load:
                load[sid].append(t)
            else:
                orphans.append(t)  # removed server's token
        target = SHARD_TOKENS // len(new_ids)
        # new/underloaded servers absorb orphans first, then steal from the
        # most-loaded until everyone is within one of the target
        for sid in new_ids:
            while len(load[sid]) < target:
                if orphans:
                    t = orphans.pop()
                else:
                    donor = max(load, key=lambda s: len(load[s]))
                    if len(load[donor]) <= target:
                        break
                    t = load[donor].pop()
                owners[t] = sid
                load[sid].append(t)
        for t in orphans:  # leftovers (rounding) go to the least-loaded
            sid = min(load, key=lambda s: len(load[s]))
            owners[t] = sid
            load[sid].append(t)
        cfg = ClusterConfig(
            servers={sid: ServerInfo.from_url(sid, url) for sid, url in servers.items()},
            token_owners=owners,
            rf=rf if rf is not None else self.rf,
            public_keys=merged,
        )
        cfg.validate()
        cfg.configstamp = self.configstamp + 1
        cfg.admin_keys = list(self.admin_keys)
        return cfg

    @classmethod
    def from_properties(cls, text: str) -> "ClusterConfig":
        """Parse the reference's Java-properties cluster file format
        (ref: ``ClusterConfiguration.java:138-187``, ``config/sample_config``)."""
        props: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            key, sep, value = line.partition("=")
            if not sep:
                raise ValueError(f"malformed properties line: {line!r}")
            props[key.strip()] = value.strip()
        server_ids = [s for s in props[PROPERTY_SERVERS].split(",") if s]
        rf = int(props[PROPERTY_BFT_REPLICATION])
        servers: Dict[str, ServerInfo] = {}
        token_owners = [""] * SHARD_TOKENS
        for sid in server_ids:
            url = props[PROPERTY_SERVER_URL.format(sid)]
            servers[sid] = ServerInfo.from_url(sid, url)
            for tok in props[PROPERTY_SERVER_TOKENS.format(sid)].split(","):
                token = int(tok)
                if not 0 <= token < SHARD_TOKENS:
                    raise ValueError(f"token {token} outside [0, {SHARD_TOKENS})")
                if token_owners[token]:
                    raise ValueError(f"token {token} assigned twice")
                token_owners[token] = sid
        pubkeys = {
            sid: bytes.fromhex(props[f"_CONFIG_SERVER_{sid}_PUBKEY"])
            for sid in server_ids
            if f"_CONFIG_SERVER_{sid}_PUBKEY" in props
        }
        admin_keys = [
            bytes.fromhex(h)
            for h in props.get("_CONFIG_ADMIN_KEYS", "").split(",")
            if h
        ]
        cfg = cls(
            servers=servers,
            token_owners=token_owners,
            rf=rf,
            public_keys=pubkeys,
            admin_keys=admin_keys,
        )
        cfg.validate()
        return cfg

    def to_properties(self) -> str:
        """Serialize to the reference-compatible properties format."""
        lines = [
            f"{PROPERTY_SERVERS}={','.join(sorted(self.servers))}",
            f"{PROPERTY_BFT_REPLICATION}={self.rf}",
        ]
        tokens_by_server: Dict[str, List[int]] = {sid: [] for sid in self.servers}
        for token, sid in enumerate(self.token_owners):
            tokens_by_server[sid].append(token)
        for sid in sorted(self.servers):
            lines.append(f"{PROPERTY_SERVER_URL.format(sid)}={self.servers[sid].url}")
            lines.append(
                f"{PROPERTY_SERVER_TOKENS.format(sid)}="
                + ",".join(str(t) for t in tokens_by_server[sid])
            )
            if sid in self.public_keys:
                lines.append(f"_CONFIG_SERVER_{sid}_PUBKEY={self.public_keys[sid].hex()}")
        if self.admin_keys:
            lines.append(
                "_CONFIG_ADMIN_KEYS=" + ",".join(pk.hex() for pk in self.admin_keys)
            )
        return "\n".join(lines) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ClusterConfig":
        doc = json.loads(text)
        servers = {
            sid: ServerInfo.from_url(sid, url) for sid, url in doc["servers"].items()
        }
        token_owners = doc.get("token_owners")
        if token_owners is None:
            assignment = round_robin_token_assignment(sorted(servers))
            token_owners = [""] * SHARD_TOKENS
            for sid, tokens in assignment.items():
                for t in tokens:
                    token_owners[t] = sid
        pubkeys = {sid: bytes.fromhex(h) for sid, h in doc.get("public_keys", {}).items()}
        cfg = cls(
            servers=servers,
            token_owners=list(token_owners),
            rf=int(doc["rf"]),
            configstamp=int(doc.get("configstamp", 1)),
            public_keys=pubkeys,
            admin_keys=[bytes.fromhex(h) for h in doc.get("admin_keys", [])],
        )
        cfg.validate()
        return cfg

    def to_json(self) -> str:
        return json.dumps(
            {
                "servers": {sid: s.url for sid, s in self.servers.items()},
                "rf": self.rf,
                "configstamp": self.configstamp,
                "token_owners": self.token_owners,
                "public_keys": {sid: pk.hex() for sid, pk in self.public_keys.items()},
                "admin_keys": [pk.hex() for pk in self.admin_keys],
            }
        )
