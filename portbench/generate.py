"""The one traffic generator: YCSB-A operations turned into the signed lanes
that a replica's quorum step verifies and tallies.

A configuration (``configs/<name>.json``) fixes the cluster (replicas, f,
the quorum) and the YCSB workload (record count, read and update shares,
zipfian constant, key format), and under ``assumed`` what neither fixes:
the adversarial shares, the message patterns, the nonce pool.  A traffic
mix (``traffic/<name>.json``) fixes the operations a step and how many
distinct batches the pool holds.  Everything is drawn from the seed, and
every seed gives the same sizes: the same lanes a batch, the same number of
forged certificates and of non-canonical lanes, in other places.

Per batch of ``ops_per_step`` operations, in a shuffled order: an update
adds ``quorum`` grant lanes from that many distinct replicas and one slot;
a read adds one response lane from one replica and one slot of its own.
A share of the updates carries 1 to f grants whose signature covers other
bytes (that certificate must not commit); a share of all lanes carries
S + L in place of S, a valid but non-canonical signature that RFC 8032's
S < L rule rejects.  Signatures are RFC 8032 signatures with the nonce
drawn from a seeded pool rather than derived from the message: the verify
is the same work and the same check, and signing costs a hash and a
multiply instead of a scalar multiplication.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import ed25519 as E

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


@dataclass
class Batch:
    """One step's input, raw: lane i is (pubs[i], msgs[i], sigs[i]) and
    votes for slot ``group_ids[i]``."""

    pubs: List[bytes]
    msgs: List[bytes]
    sigs: List[bytes]
    group_ids: np.ndarray  # (lanes,) int32
    n_ops: int
    n_updates: int
    n_canonical: int  # lanes whose S is below L

    @property
    def lanes(self) -> int:
        return len(self.pubs)


def fnv64(v: int) -> int:
    """YCSB's ``Utils.fnvhash64``: FNV-1a over the 8 low bytes, as a
    non-negative Java long."""
    h = _FNV_OFFSET
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * _FNV_PRIME) & _MASK64
    if h >= 1 << 63:
        h = (1 << 64) - h  # Math.abs of the signed value
    return h & ((1 << 63) - 1)


def zipf_ranks(rng: np.random.Generator, n_items: int, theta: float, count: int) -> np.ndarray:
    """YCSB's ``ZipfianGenerator`` (Gray et al.): ranks in [0, n_items),
    rank 0 the most popular."""
    zetan = float(np.sum(1.0 / np.arange(1, n_items + 1) ** theta))
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / n_items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(count)
    uz = u * zetan
    ranks = (n_items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ranks = np.where(uz < 1.0 + 0.5 ** theta, 1, ranks)
    ranks = np.where(uz < 1.0, 0, ranks)
    return np.minimum(ranks, n_items - 1)


def ycsb_keys(rng: np.random.Generator, config: dict, count: int) -> List[bytes]:
    """``count`` request keys: zipfian ranks scrambled over the record count
    (YCSB's ``ScrambledZipfianGenerator``), named as YCSB's hashed inserts
    name them, the number zero-padded to a fixed width."""
    n = int(config["recordcount"])
    ranks = zipf_ranks(rng, n, float(config["zipfian_constant"]), count)
    width = int(config["assumed"]["key_digits"])
    prefix = config["key_prefix"]
    return [("%s%0*d" % (prefix, width, fnv64(fnv64(int(r)) % n))).encode() for r in ranks]


def _seed_sequence(seed: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(int(seed) % (1 << 128))


def make_pool(config: dict, traffic: dict, seed: int) -> List[Batch]:
    """The traffic mix's pool of distinct batches for this seed."""
    rng = np.random.default_rng(_seed_sequence(seed))
    assumed = config["assumed"]
    n, f, quorum = int(config["replicas"]), int(config["f"]), int(config["quorum"])
    if not (n >= 3 * f + 1 and quorum == 2 * f + 1 and quorum <= n):
        raise ValueError(f"replicas {n}, f {f}, quorum {quorum}: not a BFT quorum system")
    replicas = [E.keypair(rng.bytes(32)) for _ in range(n)]
    nonces = []
    for _ in range(int(assumed["nonce_pool"])):
        r = int.from_bytes(rng.bytes(64), "little") % E.L
        nonces.append((r, E.compress(E.base_mul(r))))

    ops = int(traffic["ops_per_step"])
    n_updates = int(round(ops * float(config["updateproportion"])))
    lanes = n_updates * quorum + (ops - n_updates)
    n_forged = int(round(n_updates * float(assumed["forged_certificate_share"])))
    n_noncanon = int(round(lanes * float(assumed["noncanonical_lane_share"])))
    grant_fmt = assumed["grant_message"].encode()
    read_fmt = assumed["read_message"].encode()
    forged_fmt = assumed["forged_message"].encode()

    pool = []
    op_no = 0
    for _ in range(int(traffic["pool_batches"])):
        is_update = np.zeros(ops, dtype=bool)
        is_update[rng.permutation(ops)[:n_updates]] = True
        forged_updates = set(rng.permutation(n_updates)[:n_forged].tolist())
        keys = ycsb_keys(rng, config, ops)
        nonce_of = rng.integers(0, len(nonces), size=lanes)
        pubs: List[bytes] = []
        msgs: List[bytes] = []
        sigs: List[bytes] = []
        gids: List[int] = []
        u = 0
        for slot in range(ops):
            if is_update[slot]:
                msg = grant_fmt.replace(b"<key>", keys[slot]).replace(b"<i>", b"%d" % op_no)
                signers = rng.permutation(n)[:quorum]
                forged = np.zeros(quorum, dtype=bool)
                if u in forged_updates:
                    forged[rng.permutation(quorum)[: int(rng.integers(1, f + 1))]] = True
                u += 1
                lane_msgs = [forged_fmt.replace(b"<msg>", msg) if bad else msg for bad in forged]
                lane_signers = signers.tolist()
            else:
                msg = read_fmt.replace(b"<key>", keys[slot]).replace(b"<i>", b"%d" % op_no)
                lane_msgs = [msg]
                lane_signers = [int(rng.integers(0, n))]
            for s, signed in zip(lane_signers, lane_msgs):
                a, _prefix, pub = replicas[s]
                r, r_bytes = nonces[nonce_of[len(pubs)]]
                pubs.append(pub)
                msgs.append(msg)
                sigs.append(E.sign_with_nonce(a, pub, r, r_bytes, signed))
                gids.append(slot)
            op_no += 1
        for i in rng.permutation(lanes)[:n_noncanon].tolist():
            s = int.from_bytes(sigs[i][32:], "little") + E.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        pool.append(Batch(pubs, msgs, sigs, np.asarray(gids, dtype=np.int32), ops, n_updates,
                          lanes - n_noncanon))
    return pool
