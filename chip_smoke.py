#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mochi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed N] [--out F]``

Phases (any failure exits non-zero and prints no result line):

1. Device — the card's name, ``nvidia-smi`` name and power limit, compute
   capability, SM count, maximum SM clock, and the host's Ed25519 engine.
   No CUDA device: exit 2.
2. Build — compile every kernel, ``mochi_tpu_torch/csrc/verify.cu``,
   ``verify_mxu.cu``, ``comb.cu``, ``comb_mxu.cu``, ``comb_tree.cu``,
   ``comb_tree_mxu.cu`` and ``tally.cu``, one nvcc each, started together;
   report ptxas's registers, spills and shared bytes and each kernel's
   attributes (both passes of ``comb_tree_mxu.cu``; for every Ed25519
   kernel also the lanes a signature, threads a block and dynamic shared
   bytes, and from each of those six libraries' ``cuobjdump -sass`` listing
   the instructions, IMAD, tensor-core MMAs and local stores and loads).
3. Kernel vs plain — an 8192-item corpus made from ``--seed``: valid
   signatures from 64 signers, forgeries, and adversarial encodings
   (low-order and mixed-order points, non-points, x = 0 with the sign bit,
   S >= L, y >= p, truncated lengths).  The kernel's bitmap must equal the
   plain PyTorch version's on the card and the expected verdicts; a random
   sample of 256 lanes is also checked against the port's ``keys.verify``.
   The same holds on the first wave of the service traffic, 64 x 43 = 2,752
   lanes (a partial last block), on a slice of the traffic at every lane
   count of phase 4's sweep up to 65536, and, after phase 5, at every other
   lane count the service launched.
4. Times — CUDA events, median over repeats after a warm-up: the kernel at
   8192 and 65536 lanes and at one launch of each of 1, 8, 64, 256, 512,
   then 1024 to 262,144 lanes, the plain version at 8192, host prepare per
   item, and the bound (integer multiply-adds over the card's IMAD rate)
   beside the multiply-adds the kernel's team issues.  Host prepare at 8192
   items, with the native ``h_batch`` (``native/hbatch.c``) and with the
   pure-Python hash, µs per item, the two held equal array for array,
   beside ``native_status()``; where this interpreter has ``Python.h`` the
   native build must have succeeded.
3m. The mxu kernel (``MOCHI_SKEW_IMPL=mxu``, ``verify_mxu.cu``, every
   field multiply's column reduction on the integer tensor cores, a team of
   four lanes a signature) on phase 3's corpus and on a partial last block:
   its bitmap must equal the plain version under the same switch on the
   card, ``verify.cu``'s bitmap lane for lane and the expected verdicts, and
   phase 3's 256 sampled lanes must equal ``keys.verify``.  Its multiply
   alone (``fe_mul_mxu``) on 65,536 random pairs, some with every limb at
   the limb maximum, must equal the plain ``_mul_mxu`` limb for limb.
4m. Its times — CUDA events, median over repeats: the kernel at 2,752,
   8192 and 65536 lanes, the plain version at 8192, the multiply at 65,536
   pairs, each beside its bound, and one launch of each lane count of phase
   4's sweep (1 to 262,144): at each count up to 8192 the bitmap must equal
   the plain version's, at each up to 65536 ``verify.cu``'s (phase 4's
   launches on the same lanes) and the expected verdicts.
5. Service — the main path: ``VerifierService(CudaBatchVerifier())`` on
   loopback with a shared secret, driven by 64 concurrent ``RemoteVerifier``
   clients (one per replica of an n=64, f=21 cluster), each sending
   certificate checks of 2f+1 = 43 grants, 66,048 distinct items in all.
   Every bitmap must equal the expected verdicts, the kernel must have been
   launched, every item must have been verified on the device, and no layer
   may have fallen back to the CPU.  Each launch is timed with CUDA events on
   its own stream (``cuda_verify.launch_log``); the union of those intervals
   over the drive's span is the card's kernel-busy share.
5m. The same traffic under ``MOCHI_SKEW_IMPL=mxu`` (``field.SKEW_IMPL =
   "mxu"``, restored after): every item must take the mxu kernel and none
   the general (``pad``) or a comb kernel, every bitmap must equal the
   expected verdicts, nothing may fall back; the idle share is recorded,
   and the mxu kernel is held against its plain version at every lane count
   it launched.
6. Comb vs plain — the comb kernel (registered signers): an 8192-lane corpus
   signed by the 64 registered signers (valid, forged, another registered
   signer's key, adversarial R — small order, non-point, x = 0 with the sign
   bit, y >= p — and S >= L), at 8192 lanes and at a partial last block.
   The kernel's bitmap must equal the plain version's on the card and the
   expected verdicts, 256 sampled lanes must equal ``keys.verify``, and the
   uploaded kernel-radix table must equal the 17 x 15 rows integer for
   integer; the chain is also held against the plain chain and the
   expected verdicts at every lane count of phase 7's sweep up to 65536
   (the corpus tiled).  The tree kernel (``MOCHI_COMB_IMPL=tree``, ``comb_tree.cu``)
   must equal the plain tree at both lane counts, the chain kernel's bitmap
   lane for lane, and ``keys.verify`` on the same 256 lanes.
7. Comb times — for the chain and the tree kernel: CUDA events at 8192 and
   65536 lanes (the tree also at 2,752), a launch-size sweep (phase 4's, 1
   ... 262144), the plain version at 8192, the bound (the function's, one
   for both: they compute the same bitmap), the tree's kernel time beside
   the chain's by ``torch.profiler``, and one lone 43-grant certificate
   through ``verify_batch`` with the registry (the tree's under its
   switch).  The tree's sweep is checked: at each count up to 8192 its
   bitmap must equal the plain tree's, at every count ``comb.cu``'s (on
   the same lanes) and the expected verdicts.
6m. The comb chain under ``MOCHI_SKEW_IMPL=mxu`` (``comb_mxu.cu``, the
   chain in the 17 x 15-bit field with every multiply's column reduction on
   the integer tensor cores, a team of four lanes a signature, reading the
   registry's rows as they are) on
   phase 6's corpus at 8192 lanes, a partial last block and the service's
   2,752: its bitmap must equal the plain chain under the same switch on
   the card, ``comb.cu``'s bitmap lane for lane and the expected verdicts,
   phase 6's 256 sampled lanes must equal ``keys.verify``, and the uploaded
   ``fe17`` table must equal the host rows integer for integer.
7m. Its times — CUDA events, median over repeats: the kernel at 2,752,
   8192 and 65536 lanes and the plain chain under ``mxu`` at 8192, beside
   the function's bound (the chain's, as phase 7's) and the int8
   tensor-core reckoning of its team calls (an estimate, not a bound), and
   one launch of each lane count of phase 7's sweep (1 to 262,144): at each
   count up to 8192 the bitmap must equal the plain chain's under ``mxu``,
   at every count ``comb.cu``'s (on the same lanes) and the expected
   verdicts.
6tm. The comb tree under ``MOCHI_SKEW_IMPL=mxu`` (``comb_tree_mxu.cu``, the
   tree's two passes in the 17 x 15-bit field with every multiply on the
   integer tensor cores, a team of four lanes a signature in the prepare
   pass and four teams of four lanes splitting one signature's 128 window
   points in the accumulate pass, reading the registry's rows as they are) on phase
   6's corpus at 8192 lanes, a partial last block and the service's 2,752:
   its bitmap must equal the plain tree under the same switch on the card,
   ``comb_tree.cu``'s and ``comb_mxu.cu``'s bitmaps lane for lane and the
   expected verdicts, and phase 6's 256 sampled lanes must equal
   ``keys.verify``.
7tm. Its times — CUDA events, median over repeats: the kernel at 2,752,
   8192 and 65536 lanes, its two passes apart by ``torch.profiler``, the
   plain tree under ``mxu`` at 8192, beside the function's bound (the
   comb's) and the int8 tensor-core reckoning of its own team calls (an
   estimate, not a bound), and one launch of each lane count of phase 7's
   sweep (1 to 262,144): at each count up to 8192 the bitmap must equal the
   plain tree's under ``mxu``, at every count ``comb_mxu.cu``'s (on the
   same lanes) and the expected verdicts.
8. Service with signers — phase 5's traffic through
   ``CudaBatchVerifier(signers=...)``: every item must take the comb kernel
   and every bitmap must equal the expected verdicts.
8t. The same under the tree switch (``comb.COMB_IMPL = "tree"``, restored
   after): every item must take the tree kernel and none the chain or the
   general kernel, every bitmap must equal the expected verdicts, nothing
   may fall back; the idle share is recorded, and the tree kernel is held
   against its plain version at every lane count it launched.
8m. Phase 8 under ``MOCHI_SKEW_IMPL=mxu`` (``field.SKEW_IMPL = "mxu"``,
   restored after): every item must take the chain under mxu and none
   ``comb.cu``, the tree or a general kernel, every bitmap must equal the
   expected verdicts, nothing may fall back, and ``verifier_stats`` must
   name the mxu multiply; the idle share is recorded, and the kernel is held
   against its plain version at every lane count it launched.
8tm. Phase 8 under both switches (``comb.COMB_IMPL = "tree"``,
   ``field.SKEW_IMPL = "mxu"``, restored after): every item must take the
   tree under mxu and none ``comb.cu``, ``comb_tree.cu``, ``comb_mxu.cu`` or
   a general kernel, every bitmap must equal the expected verdicts, nothing
   may fall back, and ``verifier_stats`` must name the tree and the mxu
   multiply; the idle share is recorded, and the kernel is held against its
   plain version at every lane count it launched.
9. Cluster — the main path of the system: ``VirtualCluster(64, rf=64)``
   (f = 21, quorum 43) with one ``CudaBatchVerifier(device="cuda")`` shared
   by all 64 replicas (the replicas register the cluster identities, so
   grant signatures take the comb kernel).  Concurrent SDK clients commit
   signed PUTs, then read each key back: every acked write must read back
   its value with a 43-grant certificate, the comb kernel must have carried
   the grants, and nothing may have fallen back to the CPU.  Each kernel is
   held against its plain version at every lane count it launched here.
9m. The cluster under ``MOCHI_SKEW_IMPL=mxu`` (restored after), at a cut
   depth (4 SDK clients x 4 signed PUTs, every key read back): every acked
   write must read back with a 43-grant certificate, every comb launch must
   be the chain under mxu and every general launch ``verify_mxu.cu`` (no
   ``pad`` launch of either), and each kernel must equal its plain version
   at every lane count it launched.
9tm. The cluster under both switches (restored after), at 9m's cut depth:
   every acked write must read back with a 43-grant certificate, every comb
   launch must be the tree under mxu and every general launch
   ``verify_mxu.cu`` (no ``pad`` launch of either), and each kernel must
   equal its plain version at every lane count it launched.

10. Sharded service — phase 8's traffic through
   ``VerifierService(ShardedCudaBatchVerifier(signers=...))`` over every
   visible card: every bitmap must equal the expected verdicts, every card
   must have run comb launches, and nothing may have fallen back or crossed
   over to the CPU; the idle share is recorded as in phases 5 and 8.  Then
   the single-card and sharded verifiers serve the same traffic in turns,
   for a comparison inside one run.
11. Quorum step — ``parallel.make_quorum_step`` on the card, on the mesh of
   every card and on two slices of one card: phase 3's certificate stream
   (1,536 certificates x 43 grants = 66,048 lanes, group = certificate,
   threshold 43, a seeded quarter of the certificates carrying 1-3 more
   forged grants) with the two lanes the host rejects but the device accepts
   appended (they must not be counted), and the north-star leg (4 slots x
   64 voters, 30 forged votes in slot 3: counts [64, 64, 64, 34]).  The
   counts must equal a numpy oracle of the reference's semantics.  On a
   mesh of one slice (every card of a one-card machine, card 0 alone on a
   larger one) the step takes the fused tally-and-commit kernel, elsewhere
   the tally, the add, ``all_reduce`` and the commit kernel; each must
   have launched.  The tally kernel and the fused one must equal their
   plain versions at every lane count the step ran, on ids that wrap and
   drop, with all 66,048 lanes in one slot, on views one byte into their
   storage and on no lane.  The tally, fused and commit kernels and their
   library calls (``index_add_``, ``torch.ge``) are timed on the card
   alone, as the replay of a CUDA graph of 200 calls (an eager call of
   these kernels is bound by the host's submission, which is kept as
   ``eager_ms``), beside their byte bounds, a graph node's floor (an empty
   PyTorch kernel) and the tally with no lane and no slot; the tally's and
   the fused kernel's device time by node (the memset, the kernel) by
   ``torch.profiler``; the whole step on the host clock.
12. Multi-process — ``python -m mochi_tpu_torch.parallel.multihost
   --backend nccl``, one process per visible card: each process's JSON line
   must equal the closed form for its world size.
13. Verified recovery, WAL engine — phase 9's cluster (n = 64, quorum 43,
   one shared ``CudaBatchVerifier``) with ``storage_dir`` and
   ``storage_engine="wal"``: 4 SDK clients x 8 signed PUTs, then three
   replicas restart in turn (``restart_replica``), each replaying its disk
   with every stored grant signature (32 x 43) re-verified through the
   card.  Before the third boots, one grant signature in its WAL is forged
   (a crash image, re-framed with correct CRCs).  Each recovery's span must
   hold comb launches; the first two convict nothing, the third exactly the
   planted entry; every restarted store holds every acked value (the third
   after a resync heals the convicted key from its peers), and every acked
   key reads back with a 43-grant certificate.  Recorded per recovery:
   seconds, grants re-verified per second, comb launches and lanes, the
   card's idle share.
13p. Verified recovery, paged engine — the same cluster on
   ``storage_engine="paged"``, 2 clients x 8 PUTs: one replica pages its
   store, a second generation of the same keys is committed and paged,
   ``compact()`` merges the pages (re-verifying every surviving entry's
   grants), and the replica restarts with ``MOCHI_PAGE_AUDIT=boot``, whose
   audit re-verifies every paged entry.  The compaction's span and the
   restart-and-audit span must hold comb launches, the compaction must
   re-verify at least one grant an entry, nothing may be convicted, and
   every second-generation value must be in the restarted store and read
   back with a 43-grant certificate.
14. A cluster of replica processes — phase 9's cluster (n = 64, rf = 64,
   quorum 43) as ``ProcessCluster(64, rf=64, n_processes=4,
   verifier="cuda", storage_dir=True, wal_fsync="group")``: four ``python
   -m mochi_tpu_torch.server`` children of 16 replicas each, each child's
   replicas sharing its own ``CudaBatchVerifier`` with the 64 identities
   registered, and every replica serving its admin shell.  4 SDK clients in
   this process commit signed PUTs under load; once 32 are acked every
   child is SIGKILLed (no drain, no snapshot) and restarted, its boot replay
   re-verifying every stored grant on the card before ``READY``.  Every
   acked write must read back with a 43-grant certificate; every replica's
   ``/status`` (over its admin port), before the kill and again after the
   restart, must show a ``CudaBatchVerifier`` with 64 registered signers
   and comb dispatches and routed items; every child must hold the card (a
   card's device node among its open files, and one ``nvidia-smi`` compute
   app a holder: inside a container ``nvidia-smi`` may not show this
   machine's pids, and then the rows are counted); and every child must be
   alive at the end.  Recorded: txn/s, write p50/p99, each child's CPU
   seconds, boot and restart-to-``READY`` seconds, comb dispatches and
   routed items, acked and lost counts, ``os.cpu_count()``.
14s. The same cluster with ``verifier="service"``: one ``python -m
   mochi_tpu_torch.verifier.service --backend cuda`` sidecar owns the card,
   with the identities as its signers and its own admin port; 4 SDK clients
   x 8 PUTs, every key read back with a 43-grant certificate.  The
   service's ``/status`` must show comb dispatches, every replica's a
   ``RemoteVerifier`` under the coalescer with no fallback batch, and the
   service alone (of the children) must hold the card.  Recorded as 14,
   with the service's requested items a second.

Phases 5, 5m, 8, 8t, 8m, 8tm, 9, 9m, 9tm, 10, 11, 13 and 13p drive the
main paths: each zeroes the launch counts just before it and reads them
just after (13 and 13p around each recovery, compaction and audit).
Phases 14 and 14s launch the kernels in other processes: their children's
admin shells count those launches, and the ``kernels`` line counts this
process's alone.  ``--only 14`` runs phases 1, 2, 14 and 14s and prints
their records instead of the result lines.
Every phase but 8t and 6tm-9tm runs the comb's default accumulation, the
chain, and every phase but 3m-5m, 6m-9m and 6tm-9tm the default multiply,
``pad``.  On a machine with several
cards, phases 10-12 use every card, phase 11 also runs the step on card 0
alone, and the idle share is recorded per card.  The last three lines of
standard output are the kernel table (JSON), the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": ...}``.

To make tens of thousands of distinct valid signatures without a
pure-Python base multiplication each, this script reuses a few nonces per
signer across messages (S = r + H(R||A||M) a is still a valid signature).
That shortcut belongs to this test corpus only; the port's signer is RFC 8032.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import sysconfig
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
NONCES_PER_SIGNER = 4
CORPUS = 8192  # items in the kernel-vs-plain corpus: the service's batch size
BIG = 65536  # lanes of the larger timed launch
CLIENTS, GRANTS, REQUESTS = 64, 43, 24  # n = 64 replicas, 2f + 1 grants, checks per client
# The cluster phase: 64 replicas (rf = 64, f = 21), SDK clients x signed
# PUTs each.  The host bounds it (the protocol's Python, 64 grant signatures
# per write); sized to take a minute or two.
CLUSTER_N, CLUSTER_CLIENTS, CLUSTER_WRITES = 64, 8, 16
# Phases 13 and 13p: the cluster on the durable engines, SDK clients x
# signed PUTs each (13p: two generations of them), cut in depth only.
RECOVERY_CLIENTS, RECOVERY_PAGED_CLIENTS, RECOVERY_WRITES = 4, 2, 8
# The cluster under MOCHI_SKEW_IMPL=mxu (phase 9m): the same cluster at a
# cut depth, its general kernel being ~4x slower.
CLUSTER_MXU_CLIENTS, CLUSTER_MXU_WRITES = 4, 4
# Phases 14 and 14s: the cluster of phase 9 in replica processes (16 replicas
# a process), SDK clients in this process; 14 SIGKILLs every process once
# this many writes are acked, 14s commits a fixed number of PUTs a client.
PROC_N, PROC_PROCESSES, PROC_CLIENTS, PROC_MIN_ACKED, PROC_SERVICE_WRITES = 64, 4, 4, 32, 8
PARTIAL = 37  # lanes short of a full last block in the partial-block check
NS_SLOTS, NS_VOTERS, NS_FORGED = 4, 64, 30  # the north-star quorum leg: slot 3 loses 30 votes
MULTIHOST_LANES = 8  # lanes per process of the multi-process leg
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate
REPEATS = 20  # timed kernel launches at CORPUS lanes
# lane counts of phase 4's launch-size sweep (each up to BIG also held
# against the plain version)
SWEEP = (1, 8, 64, 256, 512, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144)
IMAD_PER_SM_PER_CLOCK = 64  # 32-bit integer multiply-add, compute capability 9.0
INT8_OPS_PER_S = 1.979e15  # the H100 SXM's dense int8 tensor-core rate

# Small-order encodings (order divides 8) and their sign-bit variants.
ID_ENC = (1).to_bytes(32, "little")  # identity, y = 1
ORDER2_ENC = (P - 1).to_bytes(32, "little")  # y = -1
ORDER4_ENC = (0).to_bytes(32, "little")  # y = 0
ORDER8_ENC = bytes.fromhex("c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac03fa")
ORDER8C_ENC = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def _with_sign_bit(enc: bytes) -> bytes:
    return enc[:31] + bytes([enc[31] | 0x80])


# ------------------------------------------------------------------- corpus


@dataclass
class Signer:
    a: int  # clamped secret scalar
    pub: bytes
    nonces: List[Tuple[int, bytes]]  # (r, encoding of [r]B)
    mixed_pub: bytes  # A + T8: the public key with a small-order component


def make_signers(rng: np.random.Generator, n: int) -> List[Signer]:
    from mochi_tpu_torch.crypto import hostfallback as hf

    t8 = hf._decompress(ORDER8_ENC)
    out = []
    for _ in range(n):
        a, _prefix, pub = hf._expand_seed(rng.bytes(32))
        nonces = []
        for _ in range(NONCES_PER_SIGNER):
            r = int.from_bytes(rng.bytes(40), "little") % (L - 1) + 1
            nonces.append((r, hf._compress(hf._mul_base(r))))
        mixed = hf._compress(hf._pt_add(hf._decompress(pub), t8))
        out.append(Signer(a, pub, nonces, mixed))
    return out


def _below(rng: np.random.Generator, n: int) -> int:
    return int(rng.integers(n))


def sign_with(signer: Signer, k: int, msg: bytes, pub: Optional[bytes] = None) -> bytes:
    """S = r + H(R||A||M) a with the signer's k-th nonce (A = ``pub``)."""
    r, r_enc = signer.nonces[k]
    pub = signer.pub if pub is None else pub
    h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    return r_enc + ((r + h * signer.a) % L).to_bytes(32, "little")


def reference_verdict(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 prechecks, then the cofactorless check on Python integers."""
    from mochi_tpu_torch.crypto import hostfallback as hf

    if len(pub) != 32 or len(sig) != 64:
        return False
    mask = (1 << 255) - 1
    if int.from_bytes(pub, "little") & mask >= P or int.from_bytes(sig[:32], "little") & mask >= P:
        return False
    if int.from_bytes(sig[32:], "little") >= L:
        return False
    return hf.verify(pub, msg, sig)


def _non_point(rng: np.random.Generator) -> bytes:
    from mochi_tpu_torch.crypto import hostfallback as hf

    while True:
        enc = rng.bytes(32)
        y = int.from_bytes(enc, "little") & ((1 << 255) - 1)
        if y < P and hf._decompress(enc) is None:
            return enc


def _adversarial(rng: np.random.Generator, signers: List[Signer]):
    """One round of adversarial cases: (kind, pub, msg, sig, expected);
    expected None means "ask the reference"."""
    s = signers[_below(rng, len(signers))]
    msg = rng.bytes(_below(rng, 96))
    honest = sign_with(s, _below(rng, NONCES_PER_SIGNER), msg)
    r, r_enc = s.nonces[_below(rng, NONCES_PER_SIGNER)]
    s_eq_r = r_enc + r.to_bytes(32, "little")  # [S]B == R
    big_s = int.from_bytes(honest[32:], "little") + L
    return [
        ("identity A, S=r", ID_ENC, msg, s_eq_r, None),
        ("order-2 A, S=r", ORDER2_ENC, msg, s_eq_r, None),
        ("identity A and R, S=0", ID_ENC, msg, ID_ENC + bytes(32), None),
        ("order-4 A", ORDER4_ENC, msg, honest, None),
        ("order-8 A", ORDER8_ENC, msg, honest, None),
        ("order-8 A (conjugate)", ORDER8C_ENC, msg, honest, None),
        ("order-8 R", s.pub, msg, ORDER8_ENC + honest[32:], None),
        ("identity R", s.pub, msg, ID_ENC + honest[32:], None),
        ("mixed-order A", s.mixed_pub, msg, sign_with(s, 0, msg, s.mixed_pub), None),
        ("non-point A", _non_point(rng), msg, honest, None),
        ("non-point R", s.pub, msg, _non_point(rng) + honest[32:], None),
        ("x=0 sign=1 A", _with_sign_bit(ID_ENC), msg, s_eq_r, False),
        ("x=0 sign=1 A (y=-1)", _with_sign_bit(ORDER2_ENC), msg, s_eq_r, False),
        ("x=0 sign=1 R", s.pub, msg, _with_sign_bit(ID_ENC) + honest[32:], False),
        ("x=0 sign=1 R, identity A, S=0", ID_ENC, msg, _with_sign_bit(ID_ENC) + bytes(32), False),
        ("S >= L (S + L)", s.pub, msg, honest[:32] + big_s.to_bytes(32, "little"), False),
        ("S = 2^256 - 1", s.pub, msg, honest[:32] + b"\xff" * 32, False),
        ("A y = p", P.to_bytes(32, "little"), msg, honest, False),
        ("A y = 2^255 - 1", b"\xff" * 32, msg, honest, False),
        ("R y = p + 1", s.pub, msg, (P + 1).to_bytes(32, "little") + honest[32:], False),
        ("31-byte key", s.pub[:31], msg, honest, False),
        ("63-byte signature", s.pub, msg, honest[:63], False),
        ("65-byte signature", s.pub, msg, honest + b"\x00", False),
        ("empty key", b"", msg, honest, False),
    ]


def make_corpus(seed: int, n: int, signers: List[Signer]):
    """n items: about 70% valid, 15% forged, 15% adversarial, shuffled.
    Returns (items, expected, kinds)."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = np.random.default_rng(seed)
    rows = []
    n_adv = int(n * 0.15)
    while len(rows) < n_adv:
        for kind, pub, msg, sig, want in _adversarial(rng, signers):
            rows.append((kind, pub, msg, sig, reference_verdict(pub, msg, sig) if want is None else want))
    rows = rows[:n_adv]
    forge_kinds = ("wrong message", "flipped R bit", "flipped S bit", "wrong key")
    n_forged = int(n * 0.15)
    while len(rows) < n:
        s = signers[_below(rng, len(signers))]
        msg = rng.bytes(_below(rng, 200))
        sig = sign_with(s, _below(rng, NONCES_PER_SIGNER), msg)
        if len(rows) < n_adv + n_forged:
            kind = forge_kinds[len(rows) % 4]
            pub = s.pub
            if kind == "wrong message":
                msg = msg + b"!"
            elif kind == "flipped R bit":
                b = _below(rng, 255)  # the sign bit (255) is its own adversarial case
                sig = bytearray(sig)
                sig[b // 8] ^= 1 << (b % 8)
                sig = bytes(sig)
            elif kind == "flipped S bit":
                b = _below(rng, 252)
                sig = bytearray(sig)
                sig[32 + b // 8] ^= 1 << (b % 8)
                sig = bytes(sig)
            else:
                others = [t for t in signers if t is not s]
                pub = others[_below(rng, len(others))].pub
            rows.append((kind, pub, msg, sig, False))
        else:
            rows.append(("valid", s.pub, msg, sig, True))
    rows = [rows[i] for i in rng.permutation(len(rows))]
    items = [VerifyItem(pub, msg, sig) for _, pub, msg, sig, _ in rows]
    return items, [w for *_, w in rows], [k for k, *_ in rows]


def _r_adversarial(rng: np.random.Generator, s: Signer, msg: bytes):
    """Adversarial R and S cases for a registered signer's key:
    (kind, sig, expected); expected None means "ask the reference"."""
    honest = sign_with(s, _below(rng, NONCES_PER_SIGNER), msg)

    def s_eq_ha(r_enc: bytes) -> bytes:
        # S = h a with R = r_enc: [S]B - [h]A is the identity
        h = int.from_bytes(hashlib.sha512(r_enc + s.pub + msg).digest(), "little") % L
        return r_enc + (h * s.a % L).to_bytes(32, "little")

    big_s = int.from_bytes(honest[32:], "little") + L
    return [
        ("identity R, S=ha", s_eq_ha(ID_ENC), None),
        ("identity R", ID_ENC + honest[32:], None),
        ("order-2 R", ORDER2_ENC + honest[32:], None),
        ("order-4 R", ORDER4_ENC + honest[32:], None),
        ("order-8 R", ORDER8_ENC + honest[32:], None),
        ("non-point R", _non_point(rng) + honest[32:], False),
        ("x=0 sign=1 R", _with_sign_bit(ID_ENC) + honest[32:], False),
        ("x=0 sign=1 R, S=ha", s_eq_ha(_with_sign_bit(ID_ENC)), False),
        ("R y = p", P.to_bytes(32, "little") + honest[32:], False),
        ("R y = p + 1", (P + 1).to_bytes(32, "little") + honest[32:], False),
        ("S >= L (S + L)", honest[:32] + big_s.to_bytes(32, "little"), False),
        ("S = 2^256 - 1", honest[:32] + b"\xff" * 32, False),
    ]


def make_comb_corpus(seed: int, n: int, signers: List[Signer]):
    """n items, every one under a registered signer's key: about 70% valid,
    15% forged (wrong message, flipped R or S bit, the signature checked
    under another registered signer's key), 15% adversarial R and S.
    Returns (items, expected, kinds)."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = np.random.default_rng(seed)
    rows = []
    n_adv = int(n * 0.15)
    while len(rows) < n_adv:
        s = signers[_below(rng, len(signers))]
        msg = rng.bytes(_below(rng, 96))
        for kind, sig, want in _r_adversarial(rng, s, msg):
            rows.append((kind, s.pub, msg, sig, reference_verdict(s.pub, msg, sig) if want is None else want))
    rows = rows[:n_adv]
    forge_kinds = ("wrong message", "flipped R bit", "flipped S bit", "another signer's key")
    n_forged = int(n * 0.15)
    while len(rows) < n:
        s = signers[_below(rng, len(signers))]
        msg = rng.bytes(_below(rng, 200))
        sig = sign_with(s, _below(rng, NONCES_PER_SIGNER), msg)
        if len(rows) < n_adv + n_forged:
            kind = forge_kinds[len(rows) % 4]
            pub = s.pub
            if kind == "wrong message":
                msg = msg + b"!"
            elif kind in ("flipped R bit", "flipped S bit"):
                b = _below(rng, 255) if kind == "flipped R bit" else 256 + _below(rng, 252)
                sig = bytearray(sig)
                sig[b // 8] ^= 1 << (b % 8)
                sig = bytes(sig)
            else:
                others = [t for t in signers if t is not s]
                pub = others[_below(rng, len(others))].pub
            rows.append((kind, pub, msg, sig, False))
        else:
            rows.append(("valid", s.pub, msg, sig, True))
    rows = [rows[i] for i in rng.permutation(len(rows))]
    items = [VerifyItem(pub, msg, sig) for _, pub, msg, sig, _ in rows]
    return items, [w for *_, w in rows], [k for k, *_ in rows]


def traffic_waves(traffic):
    """The traffic flattened wave by wave (every client's k-th certificate
    check, then the (k+1)-th): (items, expected)."""
    items, want = [], []
    for k in range(len(traffic[0])):
        for reqs in traffic:
            items.extend(reqs[k][0])
            want.extend(reqs[k][1])
    return items, want


def make_traffic(seed: int, signers: List[Signer], clients: int, requests: int, grants: int,
                 forge_rate: float = 0.01):
    """Per client, ``requests`` certificate checks of ``grants`` distinct
    grants each (replica c's certificates carry the grants of signers c ..
    c+grants-1); about ``forge_rate`` of the grants carry a flipped S bit.
    Returns [[(items, expected), ...] per client]."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = np.random.default_rng(seed)
    out = []
    for c in range(clients):
        reqs = []
        for k in range(requests):
            items, want = [], []
            for j in range(grants):
                s = signers[(c + j) % len(signers)]
                msg = b"grant %d/%d/%d " % (c, k, j) + rng.bytes(24)
                sig = sign_with(s, _below(rng, NONCES_PER_SIGNER), msg)
                ok = rng.random() >= forge_rate
                if not ok:
                    sig = sig[:32] + bytes([sig[32] ^ (1 << _below(rng, 8))]) + sig[33:]
                items.append(VerifyItem(s.pub, msg, sig))
                want.append(ok)
            reqs.append((items, want))
        out.append(reqs)
    return out


B_ENC = bytes.fromhex("5866666666666666666666666666666666666666666666666666666666666666")  # the basepoint


def quorum_stream(traffic, seed: int, grants: int):
    """The certificate stream of the traffic, wave by wave, as quorum-step
    lanes: certificate c's grants are lanes c*grants .. c*grants+grants-1
    and vote for slot c.  A seeded quarter of the certificates get 1-3 more
    forged grants (a flipped bit in S of a grant that was valid).  Returns
    (items, expected verdicts, group ids, the certificates so forged)."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    items, want = traffic_waves(traffic)
    items, want = list(items), list(want)
    n_certs = len(items) // grants
    rng = np.random.default_rng(seed)
    forged = sorted(rng.choice(n_certs, n_certs // 4, replace=False).tolist())
    for c in forged:
        valid = [j for j in range(grants) if want[c * grants + j]]
        for j in rng.choice(valid, min(len(valid), 1 + _below(rng, 3)), replace=False):
            k = c * grants + int(j)
            it = items[k]
            sig = it.signature[:32] + bytes([it.signature[32] ^ (1 << _below(rng, 8))]) + it.signature[33:]
            items[k], want[k] = VerifyItem(it.public_key, it.message, sig), False
    return items, want, np.repeat(np.arange(n_certs, dtype=np.int32), grants), forged


def host_rejected_items(signer: Signer):
    """Two lanes the host prechecks reject while their device lanes accept
    (the host leaves h = 0 there, so the device checks only [S]B == R): A
    the non-canonical y = p + 1 with R = B and S = 1, and a valid A with
    R = B and S = L + 1."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    return [VerifyItem((P + 1).to_bytes(32, "little"), b"host-rejected 1", B_ENC + (1).to_bytes(32, "little")),
            VerifyItem(signer.pub, b"host-rejected 2", B_ENC + (L + 1).to_bytes(32, "little"))]


def north_star_votes(signers: List[Signer], slots: int = NS_SLOTS, voters: int = NS_VOTERS,
                     forged_votes: int = NS_FORGED):
    """The reference's north-star quorum leg: ``slots`` slots x ``voters``
    voters (voter v signs as signer v), the first ``forged_votes`` votes of
    the last slot signed over other bytes.  Returns (items, expected
    verdicts, group ids)."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    items, want, gids = [], [], []
    for g in range(slots):
        for v in range(voters):
            s = signers[v % len(signers)]
            msg = b"ns vote g%d v%d" % (g, v)
            sig = sign_with(s, (g + v) % NONCES_PER_SIGNER, msg)
            forged = g == slots - 1 and v < forged_votes
            items.append(VerifyItem(s.pub, b"ns FORGED g%d v%d" % (g, v) if forged else msg, sig))
            want.append(not forged)
            gids.append(g)
    return items, want, np.asarray(gids, dtype=np.int32)


def quorum_oracle(want, group_ids, n_groups: int) -> np.ndarray:
    """The reference's tally on the expected verdicts, in numpy: accepted
    lanes per slot (every id here lies in [0, n_groups))."""
    return np.bincount(np.asarray(group_ids)[np.asarray(want, dtype=bool)], minlength=n_groups)


def run_quorum_leg(mesh, prepared, group_ids, want, n_groups: int, threshold: int) -> dict:
    """One quorum step over ``mesh``: pad to the mesh, dead lanes to slot
    n_groups; raise unless the counts equal the oracle, the dead slot is
    empty, the commits follow the threshold and the verdicts equal
    ``want``.  Returns the counts and the step's wall-clock time."""
    from mochi_tpu_torch.parallel import make_quorum_step, pad_to_multiple

    n = len(group_ids)
    arrays, m = pad_to_multiple((*prepared, np.asarray(group_ids, dtype=np.int32)), n, mesh.size,
                                dead_group=n_groups)
    step = make_quorum_step(mesh, n_groups + 1)
    t0 = time.perf_counter()
    bitmap, counts, committed = step(*arrays, threshold)
    wall = time.perf_counter() - t0
    oracle = quorum_oracle(want, group_ids, n_groups)
    got = counts.numpy()
    if bitmap.shape != (m,) or counts.shape != (n_groups + 1,) or committed.shape != (n_groups + 1,):
        raise AssertionError(f"quorum step shapes {bitmap.shape} {counts.shape} {committed.shape}")
    if bitmap[:n].numpy().tolist() != [bool(w) for w in want] or bitmap[n:].any():
        raise AssertionError("quorum step verdicts differ from the expected ones")
    if got[:n_groups].tolist() != oracle.tolist() or got[n_groups] != 0:
        bad = np.flatnonzero(got[:n_groups] != oracle)[:5].tolist()
        raise AssertionError(f"quorum counts differ from the oracle at slots {bad}")
    if committed.numpy().tolist() != (got >= threshold).tolist():
        raise AssertionError("committed does not follow the threshold")
    return {"lanes": n, "padded_lanes": m, "slots": n_groups, "committed": int(committed[:n_groups].sum()),
            "step_s": wall, "counts": got[:n_groups]}


def check_tally_vs_plain(bitmap, pre_ok, group_ids, n_groups: int) -> int:
    """The tally kernel and its plain version on the same card tensors: the
    max abs difference of their counts (raises if not 0)."""
    import torch

    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel.sharded import segment_tally

    got = CT.quorum_tally(bitmap, pre_ok, group_ids, n_groups).to(torch.int64)
    plain = segment_tally(bitmap, pre_ok, group_ids, n_groups).to(torch.int64)
    err = int((got - plain).abs().max().item()) if n_groups else 0
    if err:
        raise AssertionError(f"tally kernel disagrees at {bitmap.shape[0]} lanes: max abs error {err}")
    return err


def check_fused_vs_plain(bitmap, pre_ok, group_ids, n_groups: int, threshold: int) -> int:
    """The fused tally-and-commit kernel and its plain version (the plain
    tally, then the plain commit) on the same card tensors: the max abs
    difference of their counts and commits (raises if not 0)."""
    import torch

    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel.sharded import commit, segment_tally

    counts, committed = CT.quorum_tally_commit(bitmap, pre_ok, group_ids, n_groups, threshold)
    plain = segment_tally(bitmap, pre_ok, group_ids, n_groups)
    err = 0
    if n_groups:
        err = max(int((counts.to(torch.int64) - plain.to(torch.int64)).abs().max().item()),
                  int((committed.to(torch.int64) - commit(plain, threshold).to(torch.int64)).abs().max().item()))
    if err or counts.shape != (n_groups,) or committed.shape != (n_groups,):
        raise AssertionError(f"fused tally-and-commit kernel disagrees at {bitmap.shape[0]} lanes: "
                             f"max abs error {err}, shapes {tuple(counts.shape)} {tuple(committed.shape)}")
    return err


def multihost_expected(lanes: int, world: int) -> List[int]:
    """The multi-process leg's counts in closed form: lane i of every process
    votes for slot i % 3, lanes with i % 4 == 3 are forged."""
    valid = [0, 0, 0]
    for i in range(lanes):
        if i % 4 != 3:
            valid[i % 3] += 1
    return [world * v for v in valid]


def run_multihost(backend: str, nprocs: int, lanes: int = MULTIHOST_LANES, timeout_s: float = 300.0) -> List[dict]:
    """Spawn ``python -m mochi_tpu_torch.parallel.multihost`` once per rank
    (from this checkout; a rendezvous on a free loopback port) and return
    each process's JSON line, in rank order.  Raises if any process fails;
    every process is stopped before this returns."""
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.parallel.multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(nprocs), "--process-id", str(i), "--lanes-per-process", str(lanes),
         "--backend", backend],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(nprocs)]
    try:
        outs = [p.communicate(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost process {i} exited {p.returncode}:\n{err[-3000:]}")
        recs.append(json.loads(out.strip().splitlines()[-1]))
    return recs


def check_multihost(recs: List[dict], backend: str, lanes: int = MULTIHOST_LANES) -> List[int]:
    """Every process of the multi-process leg must hold the closed-form
    tally of the whole group; returns the expected counts."""
    world = len(recs)
    want = multihost_expected(lanes, world)
    per_process = sum(1 for i in range(lanes) if i % 4 != 3)
    for i, rec in enumerate(recs):
        got = (rec["process_id"], rec["process_count"], rec["backend"], rec["counts"], rec["committed"],
               rec["local_valid"], rec["comb_local_valid"])
        if got != (i, world, backend, want, [c >= 3 for c in want], per_process, per_process):
            raise AssertionError(f"multihost process {i}: {rec}, expected counts {want}")
    return want


# ------------------------------------------------------------------ phases


def _nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0].strip()


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def sass_counts(sass: str) -> dict:
    """Static counts of a ``cuobjdump -sass`` listing: its instructions, the
    integer multiply-adds among them (IMAD of every width), the tensor-core
    MMAs (IMMA, HMMA) and the local stores and loads (STL, LDL of every
    width: spills and stack arrays)."""
    ops = _SASS_OP.findall(sass)
    return {"instructions": len(ops), "imad": sum(op.startswith("IMAD") for op in ops),
            "mma": sum(op.startswith(("IMMA", "HMMA")) for op in ops),
            "local_stores": ops.count("STL"), "local_loads": ops.count("LDL")}


def _ms_median(fn, warmup: int, repeats: int) -> float:
    """Median milliseconds of ``fn`` on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ms_per_call(fn, calls: int) -> float:
    """Milliseconds per call of ``fn`` over a run of ``calls`` eager calls
    back to back between two CUDA events (after one warm-up call): for a
    kernel far shorter than its launch, the rate at which the host submits
    it, not the card's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _graph_ms(fn, calls: int) -> float:
    """Milliseconds per call of ``fn`` on the card alone: ``calls`` calls
    captured in one CUDA graph (after an eager warm-up call, which loads the
    kernel), the graph's replay timed with CUDA events, median of 5 replays.
    The host's submission is out of the measurement."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_split_ms(fn, repeats: int = 10, names=("mochi",)) -> dict:
    """Device milliseconds per call of each of the port's kernels that
    ``fn`` launches (a kernel whose name holds "mochi", or any of
    ``names``: "Memset" also keeps the memset nodes), from
    ``torch.profiler``'s per-kernel sums over ``repeats`` calls after a
    warm-up call.  A profiler that traces no device time gives {}, one that
    cannot start says so; an error of ``fn`` raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:  # no device tracing (CUPTI) on this machine
        return {"not measured": repr(exc)}
    try:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us and any(name in ev.key for name in names):
            out[ev.key.split("(")[0]] = us / 1e3 / repeats
    return out


def check_kernel_vs_plain(tens, pre_ok, want) -> int:
    """Kernel and plain version on the same card tensors: the max abs
    difference of their bitmaps.  Raises if the kernel's verdicts (ANDed
    with ``pre_ok``) differ from ``want``."""
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.crypto import curve

    got = CV.verify_prepared_packed(*tens)
    plain = curve.verify_prepared_packed(*tens)
    got_np, plain_np = got.cpu().numpy(), plain.cpu().numpy()
    err = int(np.abs(got_np.astype(np.int64) - plain_np.astype(np.int64)).max())
    wrong = int(np.sum(np.logical_and(got_np, pre_ok) != np.asarray(want, dtype=bool)))
    if err or wrong:
        raise AssertionError(f"kernel disagrees at {len(want)} lanes: vs plain {err}, {wrong} wrong verdicts")
    return err


def mul_operands(seed: int, n: int):
    """Two (17, n) int32 operands of the mxu multiply: random limbs in [0,
    LOOSE], the first 64 columns of ``a`` and columns 32-95 of ``b`` with
    every limb at LOOSE (the limb maximum), column 96 zero."""
    from mochi_tpu_torch.crypto import field as F

    rng = np.random.default_rng(seed)
    a = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n)).astype(np.int32)
    b = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n)).astype(np.int32)
    a[:, :64] = F.LOOSE
    b[:, 32:96] = F.LOOSE
    a[:, 96] = 0
    return a, b


def mxu_service_problems(svc: dict, launched: bool = True) -> List[str]:
    """What phase 5m must not show: a bitmap off the expected verdicts, no
    mxu launch (when ``launched``, as on a card), a launch of the general
    (``pad``) or a comb kernel, an item that missed the device, a fallback."""
    problems = []
    if svc["mismatched_requests"]:
        problems.append(f"{svc['mismatched_requests']} bitmaps differ from the expected verdicts")
    if launched and svc["verify_mxu_launches"] <= 0:
        problems.append("the mxu kernel was never launched")
    if svc["verify_launches"] or any(svc["comb_launches"].values()):
        problems.append(f"service under mxu: general launches {svc['verify_launches']}, "
                        f"comb launches {svc['comb_launches']}")
    if svc["device_items"] != svc["items"]:
        problems.append(f"{svc['device_items']} items on the device, {svc['items']} sent")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks"):
        if svc[key]:
            problems.append(f"service under mxu: {key} = {svc[key]}")
    return problems


def comb_mxu_service_problems(svc: dict, launched: bool = True, kernel: str = "chain_mxu") -> List[str]:
    """What phase 8m (``kernel`` ``chain_mxu``) or 8tm (``tree_mxu``) must
    not show: a bitmap off the expected verdicts, no launch of ``kernel``
    (when ``launched``, as on a card), a launch of another comb kernel or a
    general kernel, an item routed off the comb path, a fallback, or stats
    that do not name ``kernel``'s accumulation and the mxu multiply."""
    impl = kernel.split("_")[0]
    problems = []
    if svc["mismatched_requests"]:
        problems.append(f"{svc['mismatched_requests']} bitmaps differ from the expected verdicts")
    if launched and svc["comb_launches"][kernel] <= 0:
        problems.append(f"the {impl} under mxu was never launched")
    if _other_comb_launches(svc, kernel) or svc["verify_launches"] or svc["verify_mxu_launches"]:
        problems.append(f"service with signers under mxu: comb launches {svc['comb_launches']}, general "
                        f"launches {svc['verify_launches']}, mxu general launches {svc['verify_mxu_launches']}")
    if svc["routing"]["comb_items"] != svc["items"]:
        problems.append(f"routing {svc['routing']} for {svc['items']} items")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks"):
        if svc[key]:
            problems.append(f"service with signers under mxu: {key} = {svc[key]}")
    if svc["stats_multiply"]["comb"] != "mxu" or svc["stats_comb_impl"] != impl:
        problems.append(f"verifier_stats names {svc['stats_multiply']}, comb impl {svc['stats_comb_impl']}")
    return problems


def cluster_mxu_problems(cl: dict, launched: bool = True, kernel: str = "chain_mxu") -> List[str]:
    """What phase 9m (``kernel`` ``chain_mxu``) or 9tm (``tree_mxu``) must
    not show: no launch of ``kernel`` (when ``launched``), a launch of
    another comb kernel or of ``verify.cu``, no grant on the comb path, a
    fallback.  (An acked write that does not read back raises in
    ``drive_cluster``.)"""
    problems = []
    if launched and cl["comb_launches"][kernel] <= 0:
        problems.append(f"the {kernel.split('_')[0]} under mxu carried nothing: {cl['comb_launches']}")
    if _other_comb_launches(cl, kernel) or cl["verify_launches"]:
        problems.append(f"cluster under mxu: comb launches {cl['comb_launches']}, pad general launches "
                        f"{cl['verify_launches']}")
    if cl["routing"]["comb_items"] <= 0:
        problems.append(f"no grant took the comb path: {cl['routing']}")
    for key in ("fallback_batches", "crossover_batches"):
        if cl[key]:
            problems.append(f"cluster under mxu: {key} = {cl[key]}")
    return problems


def sweep_vs(launch, ref_bits, pre_ok, want, counts, time_ms) -> tuple:
    """A launch-size sweep held against a reference: at each of ``counts``
    lanes, ``launch(n)``'s bitmap against ``ref_bits[:n]`` (another kernel's
    on the same lanes) and, ANDed with ``pre_ok``, against ``want``; then
    ``time_ms(n)``.  Returns ({n: {"ms", "sigs_per_s"}}, {n: lanes
    differing from the reference plus wrong verdicts})."""
    sweep, differing = {}, {}
    for n in counts:
        bits = np.asarray(launch(n).cpu().numpy(), dtype=bool)
        differing[n] = int(np.sum(bits != ref_bits[:n])) + int(np.sum(np.logical_and(bits, pre_ok[:n]) != want[:n]))
        ms = time_ms(n)
        sweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
    return sweep, differing


def check_comb_vs_plain(table, table15, lanes, pre_ok, want, impl: str = "chain") -> int:
    """The comb kernel of ``impl`` (``chain`` or ``tree``) under the
    multiply switch in effect, reading ``table`` (in its kernel's layout),
    and its plain version (reading the 17 x 15 rows ``table15``, its
    multiply following the same switch) on the same card tensors: the max
    abs difference of their bitmaps.  Raises if the kernel's verdicts
    (ANDed with ``pre_ok``) differ from ``want``."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    got = CC.verify_comb_prepared(table, *lanes, impl=impl)
    plain = comb.verify_comb_prepared(table15, *lanes, impl=impl)
    got_np, plain_np = got.cpu().numpy(), plain.cpu().numpy()
    err = int(np.abs(got_np.astype(np.int64) - plain_np.astype(np.int64)).max())
    wrong = int(np.sum(np.logical_and(got_np, pre_ok) != np.asarray(want, dtype=bool)))
    if err or wrong:
        raise AssertionError(f"comb {impl} kernel disagrees at {len(want)} lanes: vs plain {err}, "
                             f"{wrong} wrong verdicts")
    return err


def _words(limbs: np.ndarray, offsets, bits) -> np.ndarray:
    """Little-endian limbs (..., k) at bit ``offsets`` -> (..., 4) uint64
    words of the integer they hold (each limb must lie in [0, 2^bits))."""
    limbs = limbs.astype(np.int64)
    if limbs.min() < 0 or (limbs >= (1 << np.asarray(bits, dtype=np.int64))).any():
        raise AssertionError("limb out of range")
    words = np.zeros(limbs.shape[:-1] + (4,), dtype=np.uint64)
    for i, (o, b) in enumerate(zip(offsets, bits)):
        x = limbs[..., i].astype(np.uint64)
        words[..., o >> 6] |= x << np.uint64(o & 63)
        if (o & 63) + b > 64:
            words[..., (o >> 6) + 1] |= x >> np.uint64(64 - (o & 63))
    return words


def check_table_radix(table25, table15) -> int:
    """Entries of the uploaded kernel-radix table that do not hold the
    integer of the matching 17 x 15 row (0 expected)."""
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.crypto import field as F

    t25 = table25.cpu().numpy()
    t15 = table15.cpu().numpy().reshape(-1, 3, F.NLIMBS)
    w25 = _words(t25, CV._OFFS, CV._BITS)
    w15 = _words(t15, [F.RADIX * i for i in range(F.NLIMBS)], [F.RADIX] * F.NLIMBS)
    return int(np.any(w25 != w15, axis=-1).sum())


def device_busy(launch_log, ref0, ref1) -> dict:
    """Kernel-busy time on the card between events ``ref0`` and ``ref1``:
    the union of the logged launches' [start, end] intervals."""
    span = ref0.elapsed_time(ref1)
    spans = sorted((ref0.elapsed_time(s), ref0.elapsed_time(e)) for _, s, e in launch_log)
    busy, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    sizes: dict = {}
    for n, s, e in launch_log:
        sizes.setdefault(n, []).append(s.elapsed_time(e))
    return {
        "span_ms": span, "kernel_busy_ms": busy, "kernel_sum_ms": sum(b - a for a, b in spans),
        "idle_share": 1.0 - busy / span,
        "launch_ms_by_lanes": {n: {"launches": len(t), "median_ms": statistics.median(t)}
                               for n, t in sorted(sizes.items())},
    }


async def drive_service(traffic, device: str, secret: Optional[bytes], timeout_s: float = 300.0,
                        signers=(), make_verifier=None) -> dict:
    """Boot the verifier service on loopback over ``make_verifier()`` (by
    default ``CudaBatchVerifier(device)`` with ``signers`` as its known
    signers) and drive it from one RemoteVerifier per client, concurrently.
    Returns counts and times."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.service import RemoteVerifier, VerifierService
    from mochi_tpu_torch.verifier.spi import verifier_stats

    if make_verifier is None:
        verifier = CudaBatchVerifier(device=device, signers=list(signers))
    else:
        verifier = make_verifier()
    service = VerifierService(port=0, verifier=verifier, secret=secret)
    await service.start()
    remotes = [RemoteVerifier("127.0.0.1", service.bound_port, timeout_s=timeout_s, secret=secret)
               for _ in traffic]
    latencies: List[float] = []
    mismatched = 0

    async def client(rv, reqs):
        nonlocal mismatched
        for items, want in reqs:
            t0 = time.perf_counter()
            got = await rv.verify_batch(items)
            latencies.append(time.perf_counter() - t0)
            mismatched += got != want

    try:
        t0 = time.perf_counter()
        await asyncio.gather(*(client(rv, reqs) for rv, reqs in zip(remotes, traffic)))
        wall = time.perf_counter() - t0
        stats = verifier_stats(verifier)
    finally:
        for rv in remotes:
            await rv.close()
        await service.close()
    items = sum(len(it) for reqs in traffic for it, _ in reqs)
    lat = sorted(latencies)
    return {
        "requests": len(lat),
        "items": items,
        "mismatched_requests": mismatched,
        "wall_s": wall,
        "requests_per_s": len(lat) / wall,
        "items_per_s": items / wall,
        "p50_ms": 1e3 * lat[len(lat) // 2],
        "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "service_requests": service.requests,
        "batches_flushed": verifier.batches_flushed,
        "fallback_batches": verifier.fallback_batches,
        "crossover_batches": verifier.backend.crossover_batches,
        "remote_fallbacks": sum(rv.fallback_batches for rv in remotes),
        # the multiplies the verifier's stats name (MOCHI_SKEW_IMPL), and its
        # comb accumulation (MOCHI_COMB_IMPL)
        "stats_multiply": {"general": stats["general"]["multiply"], "comb": stats["comb"]["multiply"]},
        "stats_comb_impl": stats["comb"]["impl"],
    }


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


async def drive_cluster(device: str, n: int, clients: int, writes: int, timeout_s: float = 600.0) -> dict:
    """The system's main path: an n-replica ``VirtualCluster`` (rf = n)
    whose replicas share ONE ``CudaBatchVerifier(device)``; ``clients``
    concurrent SDK clients each commit ``writes`` signed single-key PUTs,
    then read every acked key back.  Returns counts and times; raises if a
    write fails or a read does not return its value with a 2f+1-grant
    certificate."""
    from mochi_tpu_torch.client import TransactionBuilder
    from mochi_tpu_torch.testing import VirtualCluster
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    verifier = CudaBatchVerifier(device=device)
    t0 = time.perf_counter()
    async with VirtualCluster(n, rf=n, verifier_factory=lambda: verifier) as vc:
        boot_s = time.perf_counter() - t0
        quorum = vc.config.quorum
        sdks = [vc.client() for _ in range(clients)]
        acked: dict = {}
        write_s: List[float] = []
        read_s: List[float] = []
        bad: List[str] = []

        async def writer(c, sdk):
            for k in range(writes):
                key, value = f"smoke-{c}-{k}", b"value %d/%d " % (c, k) + bytes(24)
                t = time.perf_counter()
                await sdk.execute_write_transaction(TransactionBuilder().write(key, value).build())
                write_s.append(time.perf_counter() - t)
                acked[key] = (sdk, value)

        async def reader(keys_):
            for key in keys_:
                sdk, value = acked[key]
                t = time.perf_counter()
                res = await sdk.execute_read_transaction(TransactionBuilder().read(key).build())
                read_s.append(time.perf_counter() - t)
                op = res.operations[0]
                cert = op.current_certificate
                if op.value != value or cert is None or len(cert.grants) != quorum:
                    bad.append(key)

        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*(writer(c, sdk) for c, sdk in enumerate(sdks))), timeout_s)
        wall = time.perf_counter() - t0
        keys_ = sorted(acked)
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*(reader(keys_[c::clients]) for c in range(clients))), timeout_s)
        read_wall = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"{len(bad)} acked writes did not read back with a {quorum}-grant certificate: {bad[:5]}")
    return {
        "replicas": n, "rf": n, "f": (n - 1) // 3, "quorum": quorum, "clients": clients,
        "writes": len(write_s), "acked": len(acked), "read_back": len(read_s), "boot_s": boot_s,
        "write_wall_s": wall, "txn_per_s": len(write_s) / wall,
        "write_p50_ms": 1e3 * _pct(write_s, 0.5), "write_p99_ms": 1e3 * _pct(write_s, 0.99),
        "read_wall_s": read_wall, "read_p50_ms": 1e3 * _pct(read_s, 0.5),
        "batches_flushed": verifier.batches_flushed, "items_verified": verifier.items_verified,
        "fallback_batches": verifier.fallback_batches,
        "crossover_batches": verifier.backend.crossover_batches,
        "registered_signers": len(verifier.backend.registry),
    }


async def _applied(replica, acked: dict, timeout_s: float = 120.0) -> None:
    """Wait until ``replica`` has applied every acked (key, value).  A write
    acks at 2f+1 grants, and with the SDK's early-quorum return a replica
    outside that quorum may apply it later: its disk is read only after."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while True:
        missing = [k for k, v in acked.items() if getattr(replica.store._get(k), "value", None) != v]
        if not missing:
            return
        if loop.time() > deadline:
            raise AssertionError(f"{replica.server_id} never applied {len(missing)} acked writes: {missing[:5]}")
        await asyncio.sleep(0.02)


async def _commit(sdks, writes: int, tag: str, acked: dict, timeout_s: float) -> float:
    """Each SDK client commits ``writes`` signed single-key PUTs at once
    (keys ``rec-<client>-<k>``, values tagged ``tag``); returns the wall
    seconds."""
    from mochi_tpu_torch.client import TransactionBuilder

    async def writer(c, sdk):
        for k in range(writes):
            key, value = f"rec-{c}-{k}", b"%s %d/%d " % (tag.encode(), c, k) + bytes(24)
            await sdk.execute_write_transaction(TransactionBuilder().write(key, value).build())
            acked[key] = value

    t0 = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(*(writer(c, sdk) for c, sdk in enumerate(sdks))), timeout_s)
    return time.perf_counter() - t0


async def _read_back(sdk, acked: dict, quorum: int, timeout_s: float) -> List[str]:
    """The acked keys that do not read back with their value and a
    ``quorum``-grant certificate."""
    from mochi_tpu_torch.client import TransactionBuilder

    bad = []
    for key, value in sorted(acked.items()):
        res = await asyncio.wait_for(sdk.execute_read_transaction(TransactionBuilder().read(key).build()), timeout_s)
        op = res.operations[0]
        if op.value != value or op.current_certificate is None or len(op.current_certificate.grants) != quorum:
            bad.append(key)
    return bad


def plant_forged_grant(directory: str, server_id: str):
    """Forge one grant signature of the newest data commit in a replica's
    newest WAL segment (a bit of S flipped), re-framing the records with
    correct CRCs as an adversary would; returns (seq, key) of the entry."""
    from mochi_tpu_torch.storage import wal

    _index, path = wal.list_segments(directory)[-1]
    with open(path, "rb") as fh:
        data = fh.read()
    start = wal.read_segment_header(data, server_id)
    records = [[r.seq, r.rtype, r.body] for r in wal.scan_segment(data, server_id).records]
    rec = next(r for r in reversed(records) if r[1] == wal.RT_COMMIT and r[2][0][0].startswith("rec-"))
    mg_obj = next(iter(rec[2][2].values()))  # certificate: {server id: grant}; grant[3] = signature
    sig = bytearray(mg_obj[3])
    sig[32] ^= 1
    mg_obj[3] = bytes(sig)
    with open(path, "wb") as fh:
        fh.write(data[:start] + b"".join(wal.encode_record(q, t, b) for q, t, b in records))
    return rec[0], rec[2][0][0]


class Spans:
    """Launch counts per span of a phase: ``begin()`` zeroes the counts just
    before a span and ``end(name)`` reads them just after, with the span's
    seconds, the comb lanes launched and, on the card, the kernels' busy
    share of it (``device``)."""

    def __init__(self, device: str):
        self.cuda = device != "cpu"
        self.out: dict = {}

    def begin(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
            self._ref0 = torch.cuda.Event(enable_timing=True)
            self._ref0.record()
        _zero_counts()
        self._t0 = time.perf_counter()

    def end(self, name: str) -> dict:
        out = {"seconds": time.perf_counter() - self._t0}
        vlogs, clogs = _read_counts(out)
        out["comb_lanes"] = {impl: sum(n for n, _, _ in log) for impl, log in clogs.items()}
        out["comb_lane_counts"] = sorted({n for n, _, _ in clogs["chain"]})
        if self.cuda:
            import torch

            torch.cuda.synchronize()
            ref1 = torch.cuda.Event(enable_timing=True)
            ref1.record()
            ref1.synchronize()
            out["device"] = device_busy(sum(vlogs.values(), []) + sum(clogs.values(), []), self._ref0, ref1)
        out["grants_per_s"] = out["device_items"] / out["seconds"]
        self.out[name] = out
        return out


async def drive_recovery(device: str, n: int, clients: int, writes: int, storage_dir: str, spans: Spans,
                         restarts: int = 3, timeout_s: float = 600.0) -> dict:
    """Phase 13: an n-replica ``VirtualCluster`` (rf = n) on the WAL engine
    under ``storage_dir``, its replicas sharing ONE ``CudaBatchVerifier``;
    ``clients`` SDK clients commit ``writes`` signed PUTs each, then
    ``restarts`` replicas restart in turn, each recovering from its disk
    with every stored grant signature re-verified through the verifier (one
    span each).  Before the last one boots, one grant signature in its WAL
    is forged: that entry alone must be convicted, and a resync then heals
    the key from its peers.  Every restarted store must hold every acked
    value, and every acked key must read back with a 2f+1-grant
    certificate."""
    from mochi_tpu_torch.storage import wal
    from mochi_tpu_torch.testing import VirtualCluster
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    verifier = CudaBatchVerifier(device=device)
    acked: dict = {}
    recoveries = []
    async with VirtualCluster(n, rf=n, verifier_factory=lambda: verifier, storage_dir=storage_dir,
                              storage_engine="wal") as vc:
        quorum = vc.config.quorum
        sdks = [vc.client() for _ in range(clients)]
        wall = await _commit(sdks, writes, "value", acked, timeout_s)
        for k in range(restarts):
            sid = f"server-{k + 1}"
            await _applied(vc.replica(sid), acked)
            planted, before_boot = None, None
            if k == restarts - 1:
                # the disk image of a crash now (a graceful restart would
                # snapshot and truncate the log), one grant forged in it
                victim = vc.replica(sid)
                await victim.storage.flush()
                src = os.path.join(storage_dir, sid)
                frozen = src + ".crash"
                async with victim.storage._snapshot_lock:  # no snapshot renames a file mid-copy
                    shutil.copytree(src, frozen)
                planted = plant_forged_grant(frozen, sid)

                def before_boot(_sid, src=src, frozen=frozen):
                    shutil.rmtree(src)
                    shutil.move(frozen, src)

            spans.begin()
            fresh = await vc.restart_replica(sid, before_boot=before_boot)
            rec = spans.end(f"recovery_{k + 1}")
            report = fresh.storage.replay_report()
            rec.update(server_id=sid, replay_entries=report["entries"], convicted=report["convicted"],
                       convictions=report["convictions"], replay_ms=report["ms"],
                       planted=None if planted is None else {"seq": planted[0], "key": planted[1]},
                       wal_segments=len(wal.list_segments(os.path.join(storage_dir, sid))))
            rec["missing"] = sorted(key for key, v in acked.items() if getattr(fresh.store._get(key), "value", None) != v)
            if planted is not None:
                t0 = time.perf_counter()
                rec["resync_advanced"] = await fresh.resync()
                rec["resync_s"] = time.perf_counter() - t0
                rec["missing_after_resync"] = sorted(
                    key for key, v in acked.items() if getattr(fresh.store._get(key), "value", None) != v)
            recoveries.append(rec)
        t0 = time.perf_counter()
        bad = await _read_back(sdks[0], acked, quorum, timeout_s)
        read_wall = time.perf_counter() - t0
    return {"replicas": n, "rf": n, "quorum": quorum, "engine": "wal", "clients": clients, "acked": len(acked),
            "write_wall_s": wall, "txn_per_s": len(acked) / wall, "recoveries": recoveries,
            "read_back_bad": bad, "read_wall_s": read_wall,
            "fallback_batches": verifier.fallback_batches,
            "reduced": f"depth: {clients} clients x {writes} PUTs, {restarts} restarts (widths uncut: n={n}, "
                       f"quorum {quorum})"}


def recovery_problems(rec: dict, launched: bool = True) -> List[str]:
    """What phase 13 must not show: a recovery without comb launches in its
    span (``launched``: on the card), a conviction on an honest disk, a
    conviction of anything but the planted entry (or none of it), a
    missing acked value, an acked key that does not read back, a fallback."""
    problems = []
    for r in rec["recoveries"]:
        name = r["server_id"]
        if launched and (r["comb_launches"].get("chain", 0) <= 0 or r["routing"]["comb_items"] <= 0):
            problems.append(f"{name}: no comb launch in the recovery's span ({r['comb_launches']})")
        planted = r["planted"]
        if planted is None:
            if r["convicted"] or r["missing"]:
                problems.append(f"{name}: {r['convicted']} convicted, missing {r['missing'][:5]}")
        else:
            others = [c for c in r["convictions"] if (c["seq"], c["key"]) != (planted["seq"], planted["key"])]
            signed = [c for c in r["convictions"] if "signature" in c["reason"]]
            if others or not signed:
                problems.append(f"{name}: convictions {r['convictions']} for the planted entry {planted}")
            if r["missing"] != [planted["key"]] or r["missing_after_resync"]:
                problems.append(f"{name}: missing {r['missing'][:5]}, after resync {r['missing_after_resync'][:5]}")
    if rec["read_back_bad"] or rec["fallback_batches"]:
        problems.append(f"read back wrong {rec['read_back_bad'][:5]}, fallbacks {rec['fallback_batches']}")
    return problems


async def drive_recovery_paged(device: str, n: int, clients: int, writes: int, storage_dir: str, spans: Spans,
                               timeout_s: float = 600.0) -> dict:
    """Phase 13p: the cluster of phase 13 on the paged engine.  One
    replica pages its store, a second generation of the same keys is
    committed and paged too, then ``compact()`` merges the pages (every
    surviving entry's grant signatures re-verified: one span), and the
    replica restarts with the boot audit on (``MOCHI_PAGE_AUDIT=boot``),
    which re-verifies every paged entry (the restart and its audit: one
    span).  The background compaction is left unarmed, so the explicit one
    is the one measured.  Every second-generation value must be in the
    restarted store and read back with a 2f+1-grant certificate."""
    from mochi_tpu_torch.testing import VirtualCluster
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    verifier = CudaBatchVerifier(device=device)
    env0 = {k: os.environ.get(k) for k in ("MOCHI_PAGE_AUDIT", "MOCHI_PAGE_COMPACT_DEBT")}
    os.environ.update(MOCHI_PAGE_AUDIT="boot", MOCHI_PAGE_COMPACT_DEBT="2")
    try:
        async with VirtualCluster(n, rf=n, verifier_factory=lambda: verifier, storage_dir=storage_dir,
                                  storage_engine="paged") as vc:
            quorum = vc.config.quorum
            sdks = [vc.client() for _ in range(clients)]
            victim = vc.replica("server-1")
            acked: dict = {}
            walls = []
            for tag in ("first", "second"):
                walls.append(await _commit(sdks, writes, tag, acked, timeout_s))
                await _applied(victim, acked)
                await victim.storage.flush()
                await victim.storage.snapshot(victim.store)
            before = victim.storage.stats()
            spans.begin()
            done = await victim.storage.compact()
            comp = spans.end("compaction")
            after = victim.storage.stats()
            comp.update(result=done, pages_before=before["pages"]["count"], pages_after=after["pages"]["count"],
                        debt_before=before["compaction"]["debt"], **after["compaction"],
                        pages_convicted=after["pages"]["convicted"])
            spans.begin()
            fresh = await vc.restart_replica("server-1")
            loop = asyncio.get_running_loop()
            deadline = loop.time() + timeout_s
            while fresh.storage.audits < 1:
                if loop.time() > deadline:
                    raise AssertionError("the boot audit never ran")
                await asyncio.sleep(0.005)
            audit = spans.end("restart_and_boot_audit")
            st = fresh.storage.stats()
            report = fresh.storage.replay_report()
            audit.update(audits=st["audits"], audited_entries=st["audited_entries"],
                         pages_convicted=st["pages"]["convicted"], convicted=report["convicted"],
                         replay_entries=report["entries"], replay_ms=report["ms"], pages=st["pages"]["count"])
            audit["missing"] = sorted(key for key, v in acked.items()
                                      if getattr(fresh.store._get(key), "value", None) != v)
            bad = await _read_back(sdks[0], acked, quorum, timeout_s)
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"replicas": n, "rf": n, "quorum": quorum, "engine": "paged", "clients": clients, "acked": len(acked),
            "write_wall_s": walls, "compaction": comp, "audit": audit, "read_back_bad": bad,
            "fallback_batches": verifier.fallback_batches,
            "reduced": f"depth: {clients} clients x {writes} PUTs, two generations, one replica paged "
                       f"(widths uncut: n={n}, quorum {quorum})"}


def recovery_paged_problems(rec: dict, launched: bool = True) -> List[str]:
    """What phase 13p must not show: no comb launch in the compaction's or
    the audit's span (``launched``: on the card), fewer than one
    re-verified grant an entry, a conviction, a missing second-generation
    value, a key that does not read back, a fallback."""
    problems = []
    comp, audit = rec["compaction"], rec["audit"]
    for name, span in (("compaction", comp), ("audit", audit)):
        if launched and (span["comb_launches"].get("chain", 0) <= 0 or span["routing"]["comb_items"] <= 0):
            problems.append(f"no comb launch in the {name}'s span ({span['comb_launches']})")
    if comp["reverified"] < rec["acked"] or comp["pages_convicted"] or comp["debt"]:
        problems.append(f"compaction: {comp}")
    if audit["audited_entries"] < rec["acked"] or audit["pages_convicted"] or audit["convicted"]:
        problems.append(f"audit: {audit}")
    if audit["missing"] or rec["read_back_bad"] or rec["fallback_batches"]:
        problems.append(f"missing {audit['missing'][:5]}, read back wrong {rec['read_back_bad'][:5]}, "
                        f"fallbacks {rec['fallback_batches']}")
    return problems


def free_port_range(n: int, lo: int = 20000, hi: int = 60000) -> int:
    """The first port of ``n`` consecutive TCP ports that all bind free on
    loopback now (the admin shells' range of a process cluster), searched
    from a random start so that concurrent callers rarely meet."""
    base = lo + int.from_bytes(os.urandom(4), "little") % (hi - lo - n)
    for _ in range(hi - lo):
        if base + n > hi:
            base = lo
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            base = port + 1
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports in [{lo}, {hi})")


def admin_status(port: int, timeout_s: float = 30.0) -> dict:
    """``GET /status`` of an admin shell on loopback, as JSON."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def compute_apps() -> List[List]:
    """``nvidia-smi --query-compute-apps=pid,used_memory``: [pid, used
    memory] of every process holding a compute context (none where there is
    no ``nvidia-smi``).  Inside a container's pid namespace the pids may not
    be this machine's: :func:`card_holders` then names the processes."""
    if shutil.which("nvidia-smi") is None:
        return []
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [[int(f[0]), f[1].strip()] for f in (ln.split(",") for ln in out.splitlines())
            if len(f) == 2 and f[0].strip().isdigit()]


def holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a card's device node (``/dev/nvidia<N>``,
    which a CUDA context opens) among its open files."""
    fd_dir = f"/proc/{pid}/fd"
    try:
        names = os.listdir(fd_dir)
    except OSError:
        return False
    for name in names:
        try:
            if re.fullmatch(r"/dev/nvidia\d+", os.readlink(os.path.join(fd_dir, name))):
                return True
        except OSError:
            continue
    return False


def card_view(pids: dict) -> dict:
    """Who holds the card now: ``nvidia-smi``'s compute apps, whether its
    pids are this machine's (this process's own is among them), and for
    this process and each of ``pids`` (name -> pid) :func:`holds_card`."""
    apps = compute_apps()
    return {"compute_apps": apps, "smi_pids_are_ours": os.getpid() in [a[0] for a in apps],
            "parent_holds_card": holds_card(os.getpid()),
            "holds_card": {name: holds_card(pid) for name, pid in pids.items()}}


def card_problems(view: dict, pids: dict, holders: List[str], phase: str) -> List[str]:
    """The card must be held by exactly ``holders`` of ``pids`` (and this
    process, where it does): each of them, and none of the others, with a
    card's device node open; ``nvidia-smi`` listing their pids where its
    pids are ours, else as many compute apps as there are holders."""
    problems = []
    wrong = {name: held for name, held in view["holds_card"].items() if held != (name in holders)}
    if wrong:
        problems.append(f"{phase}: card held {wrong}, expected by {holders} alone")
    smi = [a[0] for a in view["compute_apps"]]
    if view["smi_pids_are_ours"]:
        listed = {name for name, pid in pids.items() if pid in smi}
        if listed != set(holders):
            problems.append(f"{phase}: nvidia-smi lists {sorted(listed)} of {pids}, expected {holders}")
    elif len(smi) != len(holders) + view["parent_holds_card"]:
        problems.append(f"{phase}: nvidia-smi lists {len(smi)} compute apps, expected "
                        f"{len(holders) + view['parent_holds_card']} ({holders} and this process)")
    return problems


def verifier_view(st: dict) -> dict:
    """The verifier section of a replica's or the service's ``/status``,
    cut to what phase 14 checks: the composition's types from the top
    down, the comb registry's size and the comb counters (of the innermost
    verifier that has them) and the remote fallbacks."""
    v = st["verifier"]
    view = {"types": [], "registered_signers": None, "dispatches": 0, "comb_items": 0, "ladder_items": 0,
            "fallback_batches": 0}
    while v is not None:
        view["types"].append(v["type"])
        view["fallback_batches"] += v.get("fallback_batches", 0)
        if "comb" in v:
            view["registered_signers"] = v["comb"]["registered_signers"]
            view["dispatches"] = v["comb"]["device_dispatches_process_total"]
            view["comb_items"] = v["comb"]["items_comb_routed_process_total"]
            view["ladder_items"] = v["comb"]["items_ladder_routed_process_total"]
        v = v.get("inner")
    return view


async def process_statuses(pc) -> dict:
    """Every replica's ``/status`` over its admin port, cut by
    :func:`verifier_view` and grouped by the child that hosts it:
    ``{proc-i: {"pid": p, "replicas": {server id: view}}}``."""
    loop = asyncio.get_running_loop()
    views = await asyncio.gather(*(loop.run_in_executor(None, admin_status, pc.admin_port(sid))
                                   for sid in pc.config.servers))
    out: dict = {}
    for sid, st in zip(pc.config.servers, views):
        if st["server_id"] != sid:
            raise AssertionError(f"admin port of {sid} answered for {st['server_id']}")
        sp = pc.process_for(sid)
        out.setdefault(sp.name, {"pid": sp.pid, "replicas": {}})["replicas"][sid] = verifier_view(st)
    return out


async def _load(sdks, acked: dict, write_s: List[float], tag: str) -> None:
    """Each SDK client commits signed single-key PUTs until cancelled or a
    write fails (a write in flight at a crash is indeterminate: only the
    ones that returned are acked)."""
    from mochi_tpu_torch.client import TransactionBuilder

    async def writer(c, sdk):
        for k in range(1 << 30):
            key, value = f"{tag}-{c}-{k}", b"%s %d/%d " % (tag.encode(), c, k) + bytes(24)
            t = time.perf_counter()
            try:
                await sdk.execute_write_transaction(TransactionBuilder().write(key, value).build())
            except Exception:
                return
            write_s.append(time.perf_counter() - t)
            acked[key] = value

    await asyncio.gather(*(writer(c, sdk) for c, sdk in enumerate(sdks)))


async def drive_process_cluster(verifier: str, n: int, processes: int, clients: int, min_acked: int,
                                ready_timeout_s: float = 600.0, timeout_s: float = 600.0) -> dict:
    """Phase 14: ``ProcessCluster(n, rf=n, n_processes=processes,
    verifier=verifier)`` on the WAL engine (``wal_fsync="group"``) with the
    admin shells on; ``clients`` SDK clients in this process commit signed
    PUTs under load, and once ``min_acked`` are acked every child is
    SIGKILLed (no drain, no snapshot) and restarted, its boot replay
    re-verifying every stored grant before READY.  Every replica's
    ``/status`` is read before the kill and again after the restart, before
    any new write; then every acked key is read back."""
    from mochi_tpu_torch.testing import ProcessCluster

    base = free_port_range(n * processes)
    pc = ProcessCluster(n, rf=n, n_processes=processes, verifier=verifier, storage_dir=True, wal_fsync="group",
                        admin_base_port=base, ready_timeout_s=ready_timeout_s)
    t0 = time.perf_counter()
    async with pc:
        boot_s = time.perf_counter() - t0
        quorum = pc.config.quorum
        sdks = [pc.client(timeout_s=120.0) for _ in range(clients)]
        acked: dict = {}
        write_s: List[float] = []
        t0 = time.perf_counter()
        load = asyncio.ensure_future(_load(sdks, acked, write_s, "p14"))
        deadline = t0 + timeout_s
        while len(acked) < min_acked:
            if load.done() or time.perf_counter() > deadline:
                load.cancel()
                raise AssertionError(f"only {len(acked)} writes acked before the load stopped: "
                                     f"{[sp.log_tail(400) for sp in pc.processes]}")
            await asyncio.sleep(0.05)
        before = await process_statuses(pc)
        cpu_before = pc.cpu_seconds()
        pids_before = {sp.name: sp.pid for sp in pc.processes}
        card_before = card_view(pids_before)
        t_kill = time.perf_counter()
        n_acked, wall = len(acked), t_kill - t0
        for sp in pc.processes:
            pc.kill_replica(sp.server_ids[0])
        await asyncio.sleep(1.0)  # a write that returns now was acked before the kill: it stays acked
        load.cancel()
        try:
            await load
        except asyncio.CancelledError:
            pass
        for sdk in sdks:
            await sdk.close()
        acked_at_kill = dict(acked)
        t0 = time.perf_counter()
        await asyncio.gather(*(pc.restart_replica(sp.server_ids[0]) for sp in pc.processes))
        restart_s = time.perf_counter() - t0
        after = await process_statuses(pc)
        pids_after = {sp.name: sp.pid for sp in pc.processes}
        card_after = card_view(pids_after)
        reader = pc.client(timeout_s=120.0)
        t0 = time.perf_counter()
        lost = await _read_back(reader, acked_at_kill, quorum, timeout_s)
        read_wall = time.perf_counter() - t0
        pc.check_alive()
        cpu_end = pc.cpu_seconds()
        ready = {name: list(s) for name, s in pc.ready_seconds.items()}
    summary = {phase: {name: _child_summary(child) for name, child in st.items()}
               for phase, st in (("before_kill", before), ("after_restart", after))}
    return {
        "replicas": n, "rf": n, "f": (n - 1) // 3, "quorum": quorum, "processes": processes, "verifier": verifier,
        "clients": clients, "os_cpu_count": os.cpu_count(), "boot_s": boot_s,
        "ready_s_first_boot": {name: s[0] for name, s in ready.items()},
        "restart_to_ready_s": {name: s[-1] for name, s in ready.items()}, "restart_wall_s": restart_s,
        "acked_at_kill": n_acked, "acked": len(acked_at_kill), "lost": len(lost), "lost_keys": lost[:10],
        "read_back": len(acked_at_kill), "read_wall_s": read_wall,
        "write_wall_s": wall, "txn_per_s": n_acked / wall,
        "write_p50_ms": 1e3 * _pct(write_s, 0.5), "write_p99_ms": 1e3 * _pct(write_s, 0.99),
        "cpu_seconds_before_kill": cpu_before, "cpu_seconds_after_restart_and_read": cpu_end,
        "pids_before_kill": pids_before, "pids_after_restart": pids_after,
        "card_before_kill": card_before, "card_after_restart": card_after,
        "parent_pid": os.getpid(), "status": summary, "min_acked": min_acked,
        "reduced": f"depth: {clients} clients until {min_acked} PUTs acked, one SIGKILL of every process "
                   f"(widths uncut: n={n}, quorum {quorum}, {processes} processes of {n // processes} replicas)",
    }


def _child_summary(child: dict) -> dict:
    """One child's replicas' verifier views, summed up: the distinct types
    and registry sizes, the least comb counters and the total fallbacks."""
    views = list(child["replicas"].values())
    return {
        "pid": child["pid"], "replicas": len(views),
        "types": sorted({"/".join(v["types"]) for v in views}),
        "registered_signers": sorted({v["registered_signers"] for v in views}, key=str),
        "dispatches": min(v["dispatches"] for v in views), "comb_items": min(v["comb_items"] for v in views),
        "ladder_items": min(v["ladder_items"] for v in views),
        "fallback_batches": sum(v["fallback_batches"] for v in views),
    }


def process_problems(rec: dict, on_card: bool = True) -> List[str]:
    """What phase 14 must not show: fewer acked writes than asked for, an
    acked write that does not read back with a 2f+1-grant certificate, and
    (``on_card``) a child whose replicas do not all show a
    ``CudaBatchVerifier`` with every replica identity registered and comb
    dispatches and routed items, before the kill or after the restart, or
    a child that does not hold the card (:func:`card_problems`)."""
    problems = []
    if rec["acked"] < rec.get("min_acked", 1) or rec["lost"]:
        problems.append(f"{rec['acked']} acked, {rec['lost']} lost: {rec['lost_keys']}")
    if not on_card:
        return problems
    for phase, children in rec["status"].items():
        for name, ch in children.items():
            if (ch["types"] != ["CudaBatchVerifier"] or ch["registered_signers"] != [rec["replicas"]]
                    or ch["dispatches"] <= 0 or ch["comb_items"] <= 0):
                problems.append(f"{phase}, {name}: {ch}")
    for phase in ("before_kill", "after_restart"):
        pids = rec[f"pids_{phase}"]
        problems += card_problems(rec[f"card_{phase}"], pids, sorted(pids), phase)
    return problems


async def drive_process_service(service_backend: str, n: int, processes: int, clients: int, writes: int,
                                ready_timeout_s: float = 600.0, timeout_s: float = 600.0) -> dict:
    """Phase 14s: ``ProcessCluster(n, rf=n, n_processes=processes,
    verifier="service")``, the sidecar on ``--backend service_backend``
    with the replica identities as its signers and its own admin port;
    ``clients`` SDK clients x ``writes`` signed PUTs, every key read back.
    Every replica's ``/status`` and the service's are read after."""
    from mochi_tpu_torch.testing import ProcessCluster

    base = free_port_range(n * processes + 1)
    pc = ProcessCluster(n, rf=n, n_processes=processes, verifier="service", service_backend=service_backend,
                        admin_base_port=base, ready_timeout_s=ready_timeout_s)
    loop = asyncio.get_running_loop()
    t0 = time.perf_counter()
    async with pc:
        boot_s = time.perf_counter() - t0
        quorum = pc.config.quorum
        sdks = [pc.client(timeout_s=120.0) for _ in range(clients)]
        acked: dict = {}
        write_s: List[float] = []
        svc0 = await loop.run_in_executor(None, admin_status, pc.service_admin_port)
        t0 = time.perf_counter()

        async def writer(c, sdk):
            from mochi_tpu_torch.client import TransactionBuilder

            for k in range(writes):
                key, value = f"p14s-{c}-{k}", b"p14s %d/%d " % (c, k) + bytes(24)
                t = time.perf_counter()
                await sdk.execute_write_transaction(TransactionBuilder().write(key, value).build())
                write_s.append(time.perf_counter() - t)
                acked[key] = value

        await asyncio.wait_for(asyncio.gather(*(writer(c, sdk) for c, sdk in enumerate(sdks))), timeout_s)
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        bad = await _read_back(sdks[0], acked, quorum, timeout_s)
        read_wall = time.perf_counter() - t1
        svc1 = await loop.run_in_executor(None, admin_status, pc.service_admin_port)
        span = time.perf_counter() - t0
        statuses = await process_statuses(pc)
        pids = {sp.name: sp.pid for sp in pc.processes}
        service_pid = pc.service_process.pid
        card = card_view(dict(pids, **{"verifier-service": service_pid}))
        pc.check_alive()
        cpu = pc.cpu_seconds()
        ready = {name: s[0] for name, s in pc.ready_seconds.items()}
    svc = verifier_view(svc1)
    return {
        "replicas": n, "rf": n, "quorum": quorum, "processes": processes, "service_backend": service_backend,
        "clients": clients, "os_cpu_count": os.cpu_count(), "boot_s": boot_s, "ready_s": ready,
        "acked": len(acked), "read_back_bad": bad, "read_wall_s": read_wall,
        "write_wall_s": wall, "txn_per_s": len(acked) / wall,
        "write_p50_ms": 1e3 * _pct(write_s, 0.5), "write_p99_ms": 1e3 * _pct(write_s, 0.99),
        "service": dict(svc, requests=svc1["requests"] - svc0["requests"], items=svc1["items"] - svc0["items"],
                        items_per_s=(svc1["items"] - svc0["items"]) / span, span_s=span),
        "replica_status": {name: _child_summary(child) for name, child in statuses.items()},
        "cpu_seconds": cpu, "pids": pids, "service_pid": service_pid, "card": card,
        "parent_pid": os.getpid(),
        "reduced": f"depth: {clients} clients x {writes} PUTs (widths uncut: n={n}, quorum {quorum}, "
                   f"{processes} processes of {n // processes} replicas)",
    }


def process_service_problems(rec: dict, on_card: bool = True) -> List[str]:
    """What phase 14s must not show: an acked key that does not read back
    with a 2f+1-grant certificate, a replica whose verifier is not a
    ``RemoteVerifier`` under the coalescer or that fell back to local
    verification, and (``on_card``) a service without comb dispatches, or
    a card held by anything but the service (:func:`card_problems`)."""
    problems = []
    if rec["read_back_bad"]:
        problems.append(f"read back wrong: {rec['read_back_bad'][:5]}")
    for name, ch in rec["replica_status"].items():
        if ch["types"] != ["CoalescingVerifier/RemoteVerifier"] or ch["fallback_batches"]:
            problems.append(f"{name}: {ch}")
    if not on_card:
        return problems
    if rec["service"]["dispatches"] <= 0 or rec["service"]["comb_items"] <= 0:
        problems.append(f"service without comb dispatches: {rec['service']}")
    pids = dict(rec["pids"], **{"verifier-service": rec["service_pid"]})
    return problems + card_problems(rec["card"], pids, ["verifier-service"], "with the service")


def process_phases(res: dict) -> None:
    """Phases 14 and 14s on the card (see the module docstring); raises on
    what :func:`process_problems` or :func:`process_service_problems`
    finds."""
    smi = _nvidia_smi("name,power.limit")
    res["processes"] = rec = asyncio.run(drive_process_cluster(
        "cuda", PROC_N, PROC_PROCESSES, PROC_CLIENTS, PROC_MIN_ACKED))
    rec["nvidia_smi"] = smi
    print(f"[processes] {rec}", flush=True)
    problems = process_problems(rec)
    if problems:
        raise AssertionError("; ".join(problems))
    res["processes_service"] = rec = asyncio.run(drive_process_service(
        "cuda", PROC_N, PROC_PROCESSES, PROC_CLIENTS, PROC_SERVICE_WRITES))
    rec["nvidia_smi"] = smi
    print(f"[processes, service] {rec}", flush=True)
    problems = process_service_problems(rec)
    if problems:
        raise AssertionError("; ".join(problems))


def host_prepare_times(items, repeats: int = 5) -> dict:
    """Phase 4's host prepare of ``items`` with the native ``h_batch`` and
    with the pure-Python hash (median µs per item of ``repeats``), the two
    results held equal array for array, and ``native_status()``.  Where
    this interpreter has ``Python.h`` the native build must have
    succeeded."""
    from mochi_tpu_torch import native
    from mochi_tpu_torch.crypto import batch_verify as BV

    status = native.native_status()
    has_python_h = os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h"))
    out = {"items": len(items), "native_status": status, "python_h": has_python_h}
    if has_python_h and not status["_hbatch"]["built"]:
        raise AssertionError(f"Python.h is present but the native build failed: {status}")
    hook = BV._hbatch

    def timed():
        times, arrays = [], None
        for _ in range(repeats):
            t0 = time.perf_counter()
            arrays = BV.prepare_packed(items)
            times.append(1e6 * (time.perf_counter() - t0) / len(items))
        return statistics.median(times), arrays

    try:
        BV._hbatch = lambda: None
        out["pure_us_per_item"], pure = timed()
    finally:
        BV._hbatch = hook
    if status["_hbatch"]["built"]:
        out["native_us_per_item"], mine = timed()
        out["native_equals_pure"] = all(a.tobytes() == b.tobytes() for a, b in zip(mine, pure))
        if not out["native_equals_pure"]:
            raise AssertionError("the native prepare's arrays differ from the pure one's")
    else:
        out["native_us_per_item"] = None
        out["native_off_because"] = {k: v["error"] for k, v in status.items()}
    return out


def _zero_counts():
    """Launch counts and traces zeroed just before a main-path phase."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.parallel import cuda_tally as CT

    CT.launches = CT.fused_launches = CT.commit_launches = 0
    BV.reset_counts()
    for skew in CV.launches:
        CV.launches[skew], CV.launch_logs[skew] = 0, []
    for impl in CC.launches:
        CC.launches[impl], CC.launch_logs[impl] = 0, []


def _read_counts(out: dict):
    """Counts and traces read just after a main-path phase; returns the
    general kernels' launch logs (keyed by skew) and the comb kernels' (keyed
    by kernel: ``chain``, ``tree``, ``chain_mxu``, ``tree_mxu``) and turns
    tracing off.
    ``verify_launches`` counts the general kernel's (``pad``) launches,
    ``verify_mxu_launches`` the mxu kernel's, ``comb_launches`` is keyed by
    kernel; ``launches_by_card`` counts the verify kernels' launches on each
    card."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.parallel import cuda_tally as CT

    out["verify_launches"] = CV.launches["pad"]
    out["verify_mxu_launches"] = CV.launches["mxu"]
    out["comb_launches"] = dict(CC.launches)
    out["tally_launches"] = CT.launches
    out["fused_tally_launches"] = CT.fused_launches
    out["commit_launches"] = CT.commit_launches
    out["device_items"] = BV.device_item_count()
    out["device_dispatches"] = BV.device_dispatch_count()
    out["routing"] = BV.comb_routing_counts()
    vlogs, clogs = dict(CV.launch_logs), dict(CC.launch_logs)
    CV.launch_logs.update(dict.fromkeys(vlogs))
    CC.launch_logs.update(dict.fromkeys(clogs))
    by_card: dict = {}
    for _, start, _ in sum(vlogs.values(), []) + sum(clogs.values(), []):
        by_card[f"cuda:{start.device.index}"] = by_card.get(f"cuda:{start.device.index}", 0) + 1
    out["launches_by_card"] = by_card
    return vlogs, clogs


def _other_comb_launches(out: dict, kernel: Optional[str] = None) -> dict:
    """The comb launches a phase made of every kernel but ``kernel``."""
    return {k: n for k, n in out["comb_launches"].items() if k != kernel and n}


def _drive(coro_fn, out_key: str, res: dict):
    """Run one main-path phase between two events on every card, with the
    counts zeroed just before and read just after; a card's kernel-busy
    share is the union of the verify kernels' logged launches on it over the
    phase's span ("device" is card 0's; "by_card" each card's, when there
    are several)."""
    import torch

    cards = range(torch.cuda.device_count())
    refs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in cards]
    for i in cards:
        torch.cuda.synchronize(i)
    _zero_counts()
    for i in cards:
        refs[i][0].record(torch.cuda.current_stream(i))
    out = asyncio.run(coro_fn())
    logs = _read_counts(out)
    for i in cards:
        torch.cuda.synchronize(i)
        refs[i][1].record(torch.cuda.current_stream(i))
        refs[i][1].synchronize()

    def busy(log, card: int) -> dict:
        # events of different cards cannot be compared: one card at a time
        return device_busy([ln for ln in log if ln[1].device.index == card], *refs[card])

    vlogs, clogs = logs
    every = sum(vlogs.values(), []) + sum(clogs.values(), [])
    out["device"] = busy(every, 0)
    out["device"]["verify_kernel"] = busy(vlogs["pad"], 0)["launch_ms_by_lanes"]
    out["device"]["verify_mxu_kernel"] = busy(vlogs["mxu"], 0)["launch_ms_by_lanes"]
    out["device"]["comb_kernels"] = {impl: busy(log, 0)["launch_ms_by_lanes"] for impl, log in clogs.items()}
    if len(cards) > 1:
        out["device"]["by_card"] = {f"cuda:{i}": busy(every, i) for i in cards}
    res[out_key] = out
    print(f"[{out_key}] {out}", flush=True)
    return out, logs


def run(args) -> dict:
    import torch

    from mochi_tpu_torch import kernels
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.crypto import curve
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.parallel import cuda_tally as CT

    res: dict = {}
    dev = torch.device("cuda", 0)

    # 1. device
    props = torch.cuda.get_device_properties(0)
    smi = _nvidia_smi("name,power.limit")
    clk_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    res["device"] = {
        "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "capability": f"{props.major}.{props.minor}", "sms": props.multi_processor_count,
        "max_sm_clock_mhz": clk_mhz, "torch": torch.__version__, "cuda": torch.version.cuda,
        "host_crypto_engine": keys.host_crypto_engine(),
    }
    print(f"[device] {res['device']}", flush=True)
    rate = IMAD_PER_SM_PER_CLOCK * props.multi_processor_count * clk_mhz * 1e6

    # 2. build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    took = kernels.build_all()
    res["build_s"] = time.perf_counter() - t0
    res["build_s_by_kernel"] = took
    res["kernel_attributes"] = {"verify": CV.kernel_attributes(), "verify_mxu": CV.kernel_attributes("mxu"),
                                "comb": CC.kernel_attributes(), "comb_mxu": CC.kernel_attributes("chain_mxu"),
                                "comb_tree": CC.kernel_attributes("tree"),
                                "comb_tree_mxu": CC.kernel_attributes("tree_mxu"), "tally": CT.kernel_attributes(),
                                "tally_fused": CT.kernel_attributes(fused=True)}
    print(f"[build] {res['build_s']:.1f} s {took}; {res['kernel_attributes']}", flush=True)
    va = res["kernel_attributes"]["verify"]
    print(f"[build] verify.cu: a team of {va['team']} lanes a signature, {va['threads']} threads a block, "
          f"{va['shared_bytes']} static and {va['dynamic_shared_bytes']} dynamic shared bytes, "
          f"{va['registers']} registers, {va['local_bytes']} local bytes", flush=True)
    res["ptxas"] = {}
    for name in ("verify", "verify_mxu", "comb", "comb_mxu", "comb_tree", "comb_tree_mxu", "tally"):
        for ln in kernels.build_logs.get(name, "").splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                res["ptxas"].setdefault(name, []).append(ln.strip())
                print(f"[build] ptxas {name}: {ln.strip()}", flush=True)
    ma = res["kernel_attributes"]["verify_mxu"]["verify"]
    print(f"[build] verify_mxu.cu: a team of {ma['team']} lanes a signature, {ma['threads']} threads a block, "
          f"{ma['shared_bytes']} static and {ma['dynamic_shared_bytes']} dynamic shared bytes, "
          f"{ma['registers']} registers, {ma['local_bytes']} local bytes", flush=True)
    for name in ("comb", "comb_mxu", "comb_tree"):
        ca = res["kernel_attributes"][name]
        print(f"[build] {name}.cu: a team of {ca['team']} lanes a signature, {ca['threads']} threads a block, "
              f"{ca['shared_bytes']} static and {ca['dynamic_shared_bytes']} dynamic shared bytes, "
              f"{ca['registers']} registers, {ca['local_bytes']} local bytes", flush=True)
    for pas, ta in res["kernel_attributes"]["comb_tree_mxu"].items():
        print(f"[build] comb_tree_mxu.cu {pas} pass: {ta['team']} lanes a signature, {ta['threads']} threads a "
              f"block, {ta['shared_bytes']} static and {ta['dynamic_shared_bytes']} dynamic shared bytes, "
              f"{ta['registers']} registers, {ta['local_bytes']} local bytes", flush=True)
    for name in ("verify", "verify_mxu", "comb", "comb_mxu", "comb_tree", "comb_tree_mxu"):
        sass = subprocess.run([str(Path(kernels.nvcc_path()).parent / "cuobjdump"), "-sass",
                               str(kernels.library_path(name))], capture_output=True, text=True, timeout=120,
                              check=True)
        res[f"sass_{name}"] = sass_counts(sass.stdout)
        print(f"[build] sass {name}: {res[f'sass_{name}']}", flush=True)

    if args.only == "14":
        process_phases(res)
        return res

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    signers = make_signers(rng, CLIENTS)
    items, want, kinds = make_corpus(args.seed, CORPUS, signers)
    traffic = make_traffic(args.seed + 1, signers, clients=CLIENTS, requests=REQUESTS, grants=GRANTS)
    res["corpus_s"] = time.perf_counter() - t0
    secret = hashlib.sha256(b"chip smoke %d" % args.seed).digest()
    prepared = BV.prepare_packed(items)
    pre_ok = prepared[6]
    tens = CV.from_reference_prepared(prepared, dev)
    got = CV.verify_prepared_packed(*tens)
    plain = curve.verify_prepared_packed(*tens)
    torch.cuda.synchronize()
    got_np, plain_np = got.cpu().numpy(), plain.cpu().numpy()
    max_abs_err = int(np.abs(got_np.astype(np.int64) - plain_np.astype(np.int64)).max())
    final = np.logical_and(got_np, pre_ok)
    wrong = [k for k, g, w in zip(kinds, final, want) if bool(g) != w]
    # the service's own launch shape: one wave of certificate checks
    flat, flat_want = traffic_waves(traffic)
    flat, flat_want = flat[:BIG], flat_want[:BIG]
    t0 = time.perf_counter()
    big = BV.prepare_packed(flat)
    prep_us = 1e6 * (time.perf_counter() - t0) / len(flat)
    big_t = CV.from_reference_prepared(big, dev)
    wave = CLIENTS * GRANTS
    checked = {wave: check_kernel_vs_plain([t[:wave] for t in big_t], big[6][:wave], flat_want[:wave])}
    sample = np.random.default_rng(args.seed + 2).choice(len(items), 256, replace=False).tolist()
    sample_wrong = [j for j in sample if keys.verify(items[j].public_key, items[j].message,
                                                     items[j].signature) != bool(final[j])]
    res["corpus"] = {
        "items": len(items), "accepted": int(final.sum()), "kinds": len(set(kinds)),
        "kernel_vs_plain_max_abs_err": max_abs_err, "wrong_verdicts": len(wrong),
        "sample_vs_keys_verify_wrong": len(sample_wrong), "seconds_to_make": res["corpus_s"],
        "service_wave_lanes": wave, "service_wave_vs_plain_max_abs_err": checked[wave],
    }
    print(f"[kernel vs plain] {res['corpus']}", flush=True)
    if max_abs_err or wrong or sample_wrong:
        raise AssertionError(f"kernel disagrees: vs plain {max_abs_err}, wrong kinds "
                             f"{sorted(set(wrong))[:10]}, sample lanes {sample_wrong[:10]}")

    # 4. times
    ms_8k = _ms_median(lambda: CV.verify_prepared_packed(*tens), 3, REPEATS)
    ms_64k = _ms_median(lambda: CV.verify_prepared_packed(*big_t), 2, REPEATS // 2)
    plain_ms = _ms_median(lambda: curve.verify_prepared_packed(*tens), 1, 3)
    # one lone 43-grant certificate check through verify_batch, end to end
    cert = traffic[0][0][0]
    BV.verify_batch(cert, dev)
    l0, t0 = CV.launches["pad"], time.perf_counter()
    for _ in range(10):
        BV.verify_batch(cert, dev)
    cert_ms, cert_launches = 1e2 * (time.perf_counter() - t0), (CV.launches["pad"] - l0) / 10
    # launch size: one launch of n lanes, n from 1 to 4 x the large launch;
    # up to the large launch each also against the plain version (phase 3)
    tiled = [torch.cat([t] * 4) for t in big_t]
    sweep, pad_bits = {}, {}  # pad_bits: verify.cu's bitmap of the first n lanes, for phase 4m
    for n in SWEEP:
        if n <= tiled[0].shape[0]:
            part = [t[:n] for t in tiled]
            if n <= len(flat):
                if n not in checked:
                    checked[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
                pad_bits[n] = CV.verify_prepared_packed(*[t[:n] for t in big_t]).cpu().numpy()
            ms = _ms_median(lambda: CV.verify_prepared_packed(*part), 1, 5)
            sweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
    print(f"[kernel vs plain] equal at lane counts {sorted(checked)}", flush=True)
    per_sig_ops = CV.IMADS_PER_SIGNATURE
    issued = CV.IMADS_ISSUED_PER_SIGNATURE
    bytes_per_sig = 2 * 17 * 4 + 2 * 4 + 2 * 32 + 1
    bound = lambda n: 1e3 * max(n * per_sig_ops / rate, n * bytes_per_sig / 3.35e12)  # noqa: E731
    res["times"] = {
        "kernel_ms_8192": ms_8k, "kernel_ms_65536": ms_64k, "plain_ms_8192": plain_ms,
        "bound_ms_8192": bound(len(items)), "bound_ms_65536": bound(len(flat)),
        "sigs_per_s_8192": len(items) / (ms_8k / 1e3), "sigs_per_s_65536": len(flat) / (ms_64k / 1e3),
        "host_prepare_us_per_item": prep_us, "imads_per_signature": per_sig_ops,
        "imads_issued_per_signature": issued, "issued_bound_ms_8192": 1e3 * len(items) * issued / rate,
        "imad_rate_per_s": rate, "launch_size_sweep": sweep,
        "cert43_verify_batch_ms": cert_ms, "cert43_launches": cert_launches,
    }
    print(f"[times] {res['times']}", flush=True)
    res["host_prepare"] = host_prepare_times(flat[:CORPUS])
    print(f"[times] host prepare: {res['host_prepare']}", flush=True)

    # 5. service: the main path of the general kernel
    svc, (vlogs, _) = _drive(lambda: drive_service(traffic, "cuda", secret), "service", res)
    vlog = vlogs["pad"]
    svc["kernel_launches"] = svc["verify_launches"]
    svc["launches_per_request"] = svc["kernel_launches"] / svc["requests"]
    # kernel vs plain at every lane count the service launched
    for n in sorted({n for n, _, _ in vlog} - set(checked)):
        checked[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
    svc["lane_counts_checked_vs_plain"] = sorted(checked)
    print(f"[service] kernel equals plain at lane counts {sorted(checked)}", flush=True)
    max_abs_err = max([max_abs_err, *checked.values()])
    problems = []
    if svc["mismatched_requests"]:
        problems.append(f"{svc['mismatched_requests']} bitmaps differ from the expected verdicts")
    if svc["kernel_launches"] <= 0:
        problems.append("the kernel was never launched")
    if svc["device_items"] != svc["items"]:
        problems.append(f"{svc['device_items']} items on the device, {svc['items']} sent")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks"):
        if svc[key]:
            problems.append(f"service: {key} = {svc[key]}")
    if _other_comb_launches(svc) or svc["verify_mxu_launches"]:
        problems.append(f"service: comb launches {svc['comb_launches']}, mxu launches {svc['verify_mxu_launches']}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 3m-5m. the mxu kernel: on the corpus, its times, the service under it
    skew0 = F.SKEW_IMPL  # MOCHI_SKEW_IMPL, restored after
    try:
        F.SKEW_IMPL = "mxu"
        mgot = CV.verify_prepared_packed(*tens).cpu().numpy()
        mfinal = np.logical_and(mgot, pre_ok)
        mwrong = [k for k, g, w in zip(kinds, mfinal, want) if bool(g) != w]
        msample_wrong = [j for j in sample if keys.verify(items[j].public_key, items[j].message,
                                                          items[j].signature) != bool(mfinal[j])]
        part = len(items) - PARTIAL
        mcheck = {n: check_kernel_vs_plain([t[:n] for t in tens], pre_ok[:n], want[:n]) for n in (len(items), part)}
        mvs_pad = int(np.sum(mgot != got_np))  # verify.cu's bitmap, lane for lane
        mul_a, mul_b = mul_operands(args.seed + 7, BIG)
        mul_at, mul_bt = torch.from_numpy(mul_a).to(dev), torch.from_numpy(mul_b).to(dev)
        mul_err = int((CV.fe_mul_mxu(mul_at, mul_bt).to(F.DTYPE)
                       - F._mul_mxu(mul_at.to(F.DTYPE), mul_bt.to(F.DTYPE))).abs().max().item())
        res["mxu_corpus"] = {
            "items": len(items), "accepted": int(mfinal.sum()), "kernel_vs_plain_max_abs_err": max(mcheck.values()),
            "lane_counts_checked": sorted(mcheck), "lanes_differing_from_verify_cu": mvs_pad,
            "wrong_verdicts": len(mwrong), "sample_vs_keys_verify_wrong": len(msample_wrong),
            "mul_pairs": BIG, "mul_vs_plain_max_abs_err": mul_err,
        }
        print(f"[mxu vs plain] {res['mxu_corpus']}", flush=True)
        if mvs_pad or mwrong or msample_wrong or mul_err:
            raise AssertionError(f"mxu kernel disagrees: {mvs_pad} lanes with verify.cu, wrong kinds "
                                 f"{sorted(set(mwrong))[:10]}, sample lanes {msample_wrong[:10]}, multiply {mul_err}")
        mxu_8k = _ms_median(lambda: CV.verify_prepared_packed(*tens), 2, REPEATS)
        mxu_64k = _ms_median(lambda: CV.verify_prepared_packed(*big_t), 1, REPEATS // 4)
        mxu_plain = _ms_median(lambda: curve.verify_prepared_packed(*tens), 1, 3)
        mul_ms = _ms_median(lambda: CV.fe_mul_mxu(mul_at, mul_bt), 3, REPEATS)
        mxu_wave = _ms_median(lambda: CV.verify_prepared_packed(*[t[:wave] for t in big_t]), 2, REPEATS)
        # the launch-size sweep: each count up to the corpus against the plain
        # version, each up to BIG against verify.cu's bitmap and the verdicts
        msweep, mvs_pad_sweep = {}, {}
        for n in SWEEP:
            if n <= len(flat):
                if n <= len(items) and n not in mcheck:
                    mcheck[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
                mbits = CV.verify_prepared_packed(*[t[:n] for t in big_t]).cpu().numpy()
                mvs_pad_sweep[n] = int(np.sum(mbits != pad_bits[n])) + int(np.sum(
                    np.logical_and(mbits, big[6][:n]) != np.asarray(flat_want[:n], dtype=bool)))
            part = [t[:n] for t in tiled]
            ms = _ms_median(lambda: CV.verify_prepared_packed(*part), 1, 5)
            msweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
        print(f"[mxu sweep] equal to the plain version at {sorted(mcheck)}, lanes differing from verify.cu or "
              f"the verdicts {mvs_pad_sweep}", flush=True)
        if any(mvs_pad_sweep.values()):
            raise AssertionError(f"mxu kernel disagrees with verify.cu or the verdicts: {mvs_pad_sweep}")
        layout_est = {  # the layout's own work at 8192, an estimate, not a bound
            "products_and_splits": 1e3 * len(items) * CV.MULS_PER_SIGNATURE * CV.PRODUCTS_PER_MUL
            * CV.OPS_PER_PRODUCT / rate,
            "tensor_int8": 1e3 * len(items) * CV.MXU_CALLS_PER_SIGNATURE * 2 * CV.MMA_MACS_PER_MUL / INT8_OPS_PER_S,
        }
        mul_bounds = {
            "bytes": 1e3 * BIG * CV.BYTES_PER_MUL / HBM_BYTES_PER_S,
            "imad": 1e3 * BIG * CV.PRODUCTS_PER_MUL / rate,
            "tensor_int8": 1e3 * BIG * 2 * CV.MMA_MACS_PER_MUL / INT8_OPS_PER_S,
        }
        res["mxu_times"] = {
            "kernel_ms_8192": mxu_8k, "kernel_ms_65536": mxu_64k, "plain_ms_8192": mxu_plain,
            "bound_ms_8192": bound(len(items)), "bound_ms_65536": bound(len(flat)),
            "sigs_per_s_8192": len(items) / (mxu_8k / 1e3), "sigs_per_s_65536": len(flat) / (mxu_64k / 1e3),
            "over_verify_cu_ms_8192": mxu_8k / ms_8k,
            "mul_ms_65536": mul_ms, "mul_bounds_ms": mul_bounds,
            "mul_bound_by": max(mul_bounds, key=mul_bounds.get),
            "kernel_ms_2752": mxu_wave, "launch_size_sweep": msweep,
            "sweep_lanes_differing_from_verify_cu_or_verdicts": mvs_pad_sweep,
            "layout_estimate_ms_8192": layout_est,
            "attributes": res["kernel_attributes"]["verify_mxu"], "ptxas": res["ptxas"].get("verify_mxu", []),
            "sass": res["sass_verify_mxu"],
        }
        print(f"[mxu times] {res['mxu_times']}", flush=True)
        # 5m. the service under the switch: every item on the mxu kernel
        svc_m, (vlogs_m, _) = _drive(lambda: drive_service(traffic, "cuda", secret), "service_mxu", res)
        for n in sorted({n for n, _, _ in vlogs_m["mxu"]} - set(mcheck)):
            mcheck[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
        svc_m["mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in vlogs_m["mxu"]})
    finally:
        F.SKEW_IMPL = skew0
    print(f"[service, mxu] mxu kernel equals plain at lane counts {sorted(mcheck)}", flush=True)
    problems = mxu_service_problems(svc_m)
    if problems:
        raise AssertionError("; ".join(problems))

    # 6. comb vs plain on the card: registered signers
    t0 = time.perf_counter()
    reg = comb.SignerRegistry(dev)
    reg.register_all([s.pub for s in signers])
    table25 = reg.device_table(dev, layout="radix25")
    table15 = torch.from_numpy(reg.host_table()).to(dev)
    citems, cwant, ckinds = make_comb_corpus(args.seed + 3, CORPUS, signers)
    cprep = BV.prepare_packed(citems)
    kidx = np.asarray([reg.index_of(it.public_key) for it in citems], dtype=np.int32)
    lanes = CC.from_prepared(kidx, cprep, dev)
    res["comb_corpus_s"] = time.perf_counter() - t0
    table_mismatch = check_table_radix(table25, table15)
    cgot = CC.verify_comb_prepared(table25, *lanes).cpu().numpy()
    cfinal = np.logical_and(cgot, cprep[6])
    cwrong = [k for k, g, w in zip(ckinds, cfinal, cwant) if bool(g) != w]
    ccheck = {len(citems): check_comb_vs_plain(table25, table15, lanes, cprep[6], cwant)}
    part = len(citems) - PARTIAL
    ccheck[part] = check_comb_vs_plain(table25, table15, [t[:part] for t in lanes], cprep[6][:part], cwant[:part])
    # and at every lane count of the sweep up to the large launch
    big_lanes = [torch.cat([t] * (BIG // len(citems))) for t in lanes]
    for n in SWEEP:
        if n <= BIG and n not in ccheck:
            ccheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant)
    csample = np.random.default_rng(args.seed + 4).choice(len(citems), 256, replace=False).tolist()
    csample_wrong = [j for j in csample if keys.verify(citems[j].public_key, citems[j].message,
                                                       citems[j].signature) != bool(cfinal[j])]
    # the tree kernel: against the plain tree, the chain kernel's bitmap and
    # the same 256 lanes of keys.verify, at 8192 lanes and a partial block
    tgot = CC.verify_comb_prepared(table25, *lanes, impl="tree").cpu().numpy()
    tfinal = np.logical_and(tgot, cprep[6])
    tcheck = {len(citems): check_comb_vs_plain(table25, table15, lanes, cprep[6], cwant, "tree")}
    tcheck[part] = check_comb_vs_plain(table25, table15, [t[:part] for t in lanes], cprep[6][:part], cwant[:part],
                                       "tree")
    tree_vs_chain = int(np.sum(tgot != cgot))
    tsample_wrong = [j for j in csample if keys.verify(citems[j].public_key, citems[j].message,
                                                       citems[j].signature) != bool(tfinal[j])]
    res["comb_tree_corpus"] = {
        "items": len(citems), "accepted": int(tfinal.sum()), "kernel_vs_plain_max_abs_err": max(tcheck.values()),
        "lane_counts_checked": sorted(tcheck), "lanes_differing_from_the_chain_kernel": tree_vs_chain,
        "sample_vs_keys_verify_wrong": len(tsample_wrong),
    }
    print(f"[comb tree vs plain] {res['comb_tree_corpus']}", flush=True)
    if tree_vs_chain or tsample_wrong:
        raise AssertionError(f"comb tree kernel disagrees: {tree_vs_chain} lanes with the chain kernel, "
                             f"sample lanes {tsample_wrong[:10]}")
    res["comb_corpus"] = {
        "items": len(citems), "accepted": int(cfinal.sum()), "kinds": len(set(ckinds)),
        "registered_signers": len(reg), "table_rows": int(table25.shape[0]),
        "table_entries_not_equal_to_17x15_rows": table_mismatch,
        "kernel_vs_plain_max_abs_err": max(ccheck.values()), "lane_counts_checked": sorted(ccheck),
        "wrong_verdicts": len(cwrong), "sample_vs_keys_verify_wrong": len(csample_wrong),
        "seconds_to_make": res["comb_corpus_s"],
    }
    print(f"[comb vs plain] {res['comb_corpus']}", flush=True)
    if table_mismatch or cwrong or csample_wrong:
        raise AssertionError(f"comb kernel disagrees: table entries {table_mismatch}, wrong kinds "
                             f"{sorted(set(cwrong))[:10]}, sample lanes {csample_wrong[:10]}")

    # 7. comb times
    c8k = _ms_median(lambda: CC.verify_comb_prepared(table25, *lanes), 3, REPEATS)
    c64k = _ms_median(lambda: CC.verify_comb_prepared(table25, *big_lanes), 2, REPEATS // 2)
    cplain = _ms_median(lambda: comb.verify_comb_prepared(table15, *lanes), 1, 3)
    BV.verify_batch(cert, dev, registry=reg)
    l0, t0 = CC.launches["chain"], time.perf_counter()
    for _ in range(10):
        BV.verify_batch(cert, dev, registry=reg)
    ccert_ms, ccert_launches = 1e2 * (time.perf_counter() - t0), (CC.launches["chain"] - l0) / 10
    ctiled = [torch.cat([t] * 4) for t in big_lanes]
    reps = ctiled[0].shape[0] // len(citems)
    wave_lanes = [t[: CLIENTS * GRANTS] for t in lanes]
    csweep = {}
    for n in SWEEP:
        part_l = [t[:n] for t in ctiled]
        ms = _ms_median(lambda: CC.verify_comb_prepared(table25, *part_l), 1, 5)
        csweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
    # the bound: operations (IMADs) or bytes (each lane's inputs and verdict,
    # plus one read of the signer table and the basepoint comb)
    cbytes = lambda n: n * CC.BYTES_PER_SIGNATURE + (table25.shape[0] + 576) * CC.ENTRY_BYTES  # noqa: E731
    # the bound of the function, so of both kernels: the tree computes the same
    # bitmap from the same inputs, and its extra multiplies and its record
    # between the passes are the kernel's own cost, not the function's
    cbound = lambda n: 1e3 * max(n * CC.IMADS_PER_SIGNATURE / rate, cbytes(n) / 3.35e12)  # noqa: E731
    cbound_by = "operations" if len(citems) * CC.IMADS_PER_SIGNATURE / rate > cbytes(len(citems)) / 3.35e12 \
        else "bytes"
    t_wave = _ms_median(lambda: CC.verify_comb_prepared(table25, *wave_lanes, impl="tree"), 3, REPEATS)
    t8k = _ms_median(lambda: CC.verify_comb_prepared(table25, *lanes, impl="tree"), 3, REPEATS)
    t64k = _ms_median(lambda: CC.verify_comb_prepared(table25, *big_lanes, impl="tree"), 2, REPEATS // 2)
    tplain = _ms_median(lambda: comb.verify_comb_prepared(table15, *lanes, impl="tree"), 1, 3)
    # the launch-size sweep: each count up to the corpus against the plain
    # tree, each against comb.cu's bitmap on the same lanes and the verdicts
    for n in SWEEP:
        if n <= len(citems) and n not in tcheck:
            tcheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant, "tree")
    pad_tiled = CC.verify_comb_prepared(table25, *ctiled, multiply="pad").cpu().numpy()  # comb.cu's

    def tree_ms(n):  # the lanes sliced outside the timed calls, as the chain's sweep
        part_l = [t[:n] for t in ctiled]
        return _ms_median(lambda: CC.verify_comb_prepared(table25, *part_l, impl="tree"), 1, 5)

    tsweep, t_vs_sweep = sweep_vs(
        lambda n: CC.verify_comb_prepared(table25, *[t[:n] for t in ctiled], impl="tree"), pad_tiled,
        np.tile(cprep[6], reps), np.tile(np.asarray(cwant, dtype=bool), reps), SWEEP, tree_ms)
    for n in tsweep:
        tsweep[n]["chain_ms"] = csweep[n]["ms"]
    print(f"[comb tree sweep] equal to the plain tree at {sorted(tcheck)}, lanes differing from comb.cu or the "
          f"verdicts {t_vs_sweep}", flush=True)
    if any(t_vs_sweep.values()):
        raise AssertionError(f"comb tree kernel disagrees with comb.cu or the verdicts: {t_vs_sweep}")
    # the tree kernel's device time beside the chain's on the same lanes, by
    # the profiler
    tsplit = {n: kernel_split_ms(lambda: (CC.verify_comb_prepared(table25, *[t[:n] for t in ctiled], impl="tree"),
                                          CC.verify_comb_prepared(table25, *[t[:n] for t in ctiled], impl="chain")))
              for n in (CLIENTS * GRANTS, len(citems), BIG)}
    impl0 = comb.COMB_IMPL  # MOCHI_COMB_IMPL, restored after each tree leg
    try:  # one lone certificate through verify_batch under the tree switch
        comb.COMB_IMPL = "tree"
        BV.verify_batch(cert, dev, registry=reg)
        l0, t0 = CC.launches["tree"], time.perf_counter()
        for _ in range(10):
            BV.verify_batch(cert, dev, registry=reg)
        tcert_ms, tcert_launches = 1e2 * (time.perf_counter() - t0), (CC.launches["tree"] - l0) / 10
    finally:
        comb.COMB_IMPL = impl0
    res["comb_tree_times"] = {
        "kernel_ms_2752": t_wave, "kernel_ms_8192": t8k, "kernel_ms_65536": t64k, "plain_ms_8192": tplain,
        "bound_ms_8192": cbound(len(citems)), "bound_ms_65536": cbound(BIG), "bound_by": cbound_by,
        "sigs_per_s_8192": len(citems) / (t8k / 1e3), "sigs_per_s_65536": BIG / (t64k / 1e3),
        "imads_per_signature": CC.IMADS_PER_SIGNATURE, "imads_issued_per_signature": CC.IMADS_PER_SIGNATURE_TREE,
        "issued_bound_ms_8192": 1e3 * len(citems) * CC.IMADS_PER_SIGNATURE_TREE / rate,
        "launch_size_sweep": tsweep, "sweep_lanes_differing_from_comb_cu_or_verdicts": t_vs_sweep,
        "lane_counts_checked_vs_plain": sorted(tcheck),
        "cert43_verify_batch_ms": tcert_ms, "cert43_launches": tcert_launches,
        "chain_over_tree_ms_8192": c8k / t8k, "profiler_ms_beside_the_chain": tsplit,
        "attributes": res["kernel_attributes"]["comb_tree"],
        "ptxas": res["ptxas"].get("comb_tree", []), "sass": res["sass_comb_tree"],
    }
    print(f"[comb tree times] {res['comb_tree_times']}", flush=True)
    res["comb_times"] = {
        "kernel_ms_8192": c8k, "kernel_ms_65536": c64k, "plain_ms_8192": cplain,
        "bound_ms_8192": cbound(len(citems)), "bound_ms_65536": cbound(BIG), "bound_by": cbound_by,
        "sigs_per_s_8192": len(citems) / (c8k / 1e3), "sigs_per_s_65536": BIG / (c64k / 1e3),
        "imads_per_signature": CC.IMADS_PER_SIGNATURE, "launch_size_sweep": csweep,
        "cert43_verify_batch_ms": ccert_ms, "cert43_launches": ccert_launches,
        "general_over_comb_ms_8192": ms_8k / c8k,
        "attributes": res["kernel_attributes"]["comb"], "ptxas": res["ptxas"].get("comb", []),
        "sass": res["sass_comb"],
    }
    print(f"[comb times] {res['comb_times']}", flush=True)

    def check_comb(lane_counts):
        """The comb kernel against its plain version at each lane count a
        main path launched that was not checked yet."""
        for n in sorted(set(lane_counts) - set(ccheck)):
            ccheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant)

    # 6m-7m. the chain under mxu (comb_mxu.cu): on the comb corpus, its times
    skew0 = F.SKEW_IMPL  # MOCHI_SKEW_IMPL, restored after each mxu leg
    table17 = reg.device_table(dev, layout="fe17")
    table17_mismatch = int((table17.cpu() != torch.from_numpy(reg.host_table())).sum())
    try:
        F.SKEW_IMPL = "mxu"
        mcgot = CC.verify_comb_prepared(table17, *lanes).cpu().numpy()
        mcfinal = np.logical_and(mcgot, cprep[6])
        mcwrong = [k for k, g, w in zip(ckinds, mcfinal, cwant) if bool(g) != w]
        mccheck = {n: _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant)
                   for n in (len(citems), len(citems) - PARTIAL, CLIENTS * GRANTS)}
        mc_vs_pad = int(np.sum(mcgot != cgot))  # comb.cu's bitmap, lane for lane
        mcsample_wrong = [j for j in csample if keys.verify(citems[j].public_key, citems[j].message,
                                                            citems[j].signature) != bool(mcfinal[j])]
        res["comb_mxu_corpus"] = {
            "items": len(citems), "accepted": int(mcfinal.sum()), "table_rows": int(table17.shape[0]),
            "table_entries_not_equal_to_host_rows": table17_mismatch,
            "kernel_vs_plain_max_abs_err": max(mccheck.values()), "lane_counts_checked": sorted(mccheck),
            "lanes_differing_from_comb_cu": mc_vs_pad, "wrong_verdicts": len(mcwrong),
            "sample_vs_keys_verify_wrong": len(mcsample_wrong),
        }
        print(f"[comb mxu vs plain] {res['comb_mxu_corpus']}", flush=True)
        if table17_mismatch or mc_vs_pad or mcwrong or mcsample_wrong:
            raise AssertionError(f"comb mxu kernel disagrees: table entries {table17_mismatch}, {mc_vs_pad} lanes "
                                 f"with comb.cu, wrong kinds {sorted(set(mcwrong))[:10]}, sample lanes "
                                 f"{mcsample_wrong[:10]}")
        mc_wave = _ms_median(lambda: CC.verify_comb_prepared(table17, *wave_lanes), 2, REPEATS // 2)
        mc8k = _ms_median(lambda: CC.verify_comb_prepared(table17, *lanes), 2, REPEATS)
        mc64k = _ms_median(lambda: CC.verify_comb_prepared(table17, *big_lanes), 1, REPEATS // 4)
        mcplain = _ms_median(lambda: comb.verify_comb_prepared(table17, *lanes), 1, 3)
        # the launch-size sweep: each count up to the corpus against the
        # plain chain, each against comb.cu's bitmap and the verdicts
        for n in SWEEP:
            if n <= len(citems) and n not in mccheck:
                mccheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant)
        mcsweep, mc_vs_sweep = sweep_vs(
            lambda n: CC.verify_comb_prepared(table17, *[t[:n] for t in ctiled]), pad_tiled,
            np.tile(cprep[6], reps), np.tile(np.asarray(cwant, dtype=bool), reps), SWEEP,
            lambda n: _ms_median(lambda: CC.verify_comb_prepared(table17, *[t[:n] for t in ctiled]), 1, 5))
        print(f"[comb mxu sweep] equal to the plain chain at {sorted(mccheck)}, lanes differing from comb.cu or "
              f"the verdicts {mc_vs_sweep}", flush=True)
        if any(mc_vs_sweep.values()):
            raise AssertionError(f"comb mxu kernel disagrees with comb.cu or the verdicts: {mc_vs_sweep}")
    finally:
        F.SKEW_IMPL = skew0
    # the int8 tensor-core reckoning of the kernel's own team calls: each
    # multiply-add two operations at the card's dense int8 rate
    mc_tensor = lambda n: 1e3 * n * CC.MXU_CALLS_PER_SIGNATURE * 2 * CC.MMA_MACS_PER_CALL / INT8_OPS_PER_S  # noqa: E731
    res["comb_mxu_times"] = {
        "kernel_ms_2752": mc_wave, "kernel_ms_8192": mc8k, "kernel_ms_65536": mc64k, "plain_ms_8192": mcplain,
        "bound_ms_8192": cbound(len(citems)), "bound_ms_65536": cbound(BIG), "bound_by": cbound_by,
        "sigs_per_s_8192": len(citems) / (mc8k / 1e3), "sigs_per_s_65536": BIG / (mc64k / 1e3),
        "muls_per_signature": CC.MULS_PER_SIGNATURE_MXU, "calls_per_signature": CC.MXU_CALLS_PER_SIGNATURE,
        "mma_macs_per_call": CC.MMA_MACS_PER_CALL,
        "tensor_int8_ms_8192": mc_tensor(len(citems)), "tensor_int8_ms_65536": mc_tensor(BIG),
        "launch_size_sweep": mcsweep, "sweep_lanes_differing_from_comb_cu_or_verdicts": mc_vs_sweep,
        "over_comb_cu_ms_8192": mc8k / c8k, "comb_cu_ms_8192": c8k,
        "attributes": res["kernel_attributes"]["comb_mxu"], "ptxas": res["ptxas"].get("comb_mxu", []),
        "sass": res["sass_comb_mxu"],
    }
    print(f"[comb mxu times] {res['comb_mxu_times']}", flush=True)

    # 6tm-7tm. the tree under mxu (comb_tree_mxu.cu): on the comb corpus, its
    # times
    try:
        F.SKEW_IMPL = "mxu"
        tmgot = CC.verify_comb_prepared(table17, *lanes, impl="tree").cpu().numpy()
        tmfinal = np.logical_and(tmgot, cprep[6])
        tmwrong = [k for k, g, w in zip(ckinds, tmfinal, cwant) if bool(g) != w]
        tmcheck = {n: _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant, "tree")
                   for n in (len(citems), len(citems) - PARTIAL, CLIENTS * GRANTS)}
        # comb_tree.cu's and comb_mxu.cu's bitmaps, lane for lane
        tm_vs = {"comb_tree_cu": int(np.sum(tmgot != tgot)), "comb_mxu_cu": int(np.sum(tmgot != mcgot))}
        tmsample_wrong = [j for j in csample if keys.verify(citems[j].public_key, citems[j].message,
                                                            citems[j].signature) != bool(tmfinal[j])]
        res["comb_tree_mxu_corpus"] = {
            "items": len(citems), "accepted": int(tmfinal.sum()),
            "kernel_vs_plain_max_abs_err": max(tmcheck.values()), "lane_counts_checked": sorted(tmcheck),
            "lanes_differing": tm_vs, "wrong_verdicts": len(tmwrong),
            "sample_vs_keys_verify_wrong": len(tmsample_wrong),
        }
        print(f"[comb tree mxu vs plain] {res['comb_tree_mxu_corpus']}", flush=True)
        if any(tm_vs.values()) or tmwrong or tmsample_wrong:
            raise AssertionError(f"comb tree mxu kernel disagrees: lanes differing {tm_vs}, wrong kinds "
                                 f"{sorted(set(tmwrong))[:10]}, sample lanes {tmsample_wrong[:10]}")
        tm_wave = _ms_median(lambda: CC.verify_comb_prepared(table17, *wave_lanes, impl="tree"), 2, REPEATS // 2)
        tm8k = _ms_median(lambda: CC.verify_comb_prepared(table17, *lanes, impl="tree"), 2, REPEATS)
        tm64k = _ms_median(lambda: CC.verify_comb_prepared(table17, *big_lanes, impl="tree"), 1, REPEATS // 4)
        tmplain = _ms_median(lambda: comb.verify_comb_prepared(table17, *lanes, impl="tree"), 1, 3)
        # the launch-size sweep: each count up to the corpus against the
        # plain tree under mxu, each against comb_mxu.cu's bitmap on the
        # same lanes and the verdicts
        for n in SWEEP:
            if n <= len(citems) and n not in tmcheck:
                tmcheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant, "tree")
        mc_tiled = CC.verify_comb_prepared(table17, *ctiled, impl="chain").cpu().numpy()
        tmsweep, tm_vs_sweep = sweep_vs(
            lambda n: CC.verify_comb_prepared(table17, *[t[:n] for t in ctiled], impl="tree"), mc_tiled,
            np.tile(cprep[6], reps), np.tile(np.asarray(cwant, dtype=bool), reps), SWEEP,
            lambda n: _ms_median(lambda: CC.verify_comb_prepared(table17, *[t[:n] for t in ctiled], impl="tree"),
                                 1, 5))
        print(f"[comb tree mxu sweep] equal to the plain tree at {sorted(tmcheck)}, lanes differing from "
              f"comb_mxu.cu or the verdicts {tm_vs_sweep}", flush=True)
        if any(tm_vs_sweep.values()):
            raise AssertionError(f"comb tree mxu kernel disagrees with comb_mxu.cu or the verdicts: {tm_vs_sweep}")
        # the two passes apart, by the profiler
        tmsplit = {n: kernel_split_ms(lambda: CC.verify_comb_prepared(table17, *[t[:n] for t in ctiled],
                                                                      impl="tree"), repeats=5)
                   for n in (CLIENTS * GRANTS, len(citems), BIG)}
    finally:
        F.SKEW_IMPL = skew0
    # the int8 reckoning of the kernel's own team calls, as phase 7m's
    tm_tensor = lambda n: (1e3 * n * CC.TREE_MXU_CALLS_PER_SIGNATURE * 2 * CC.MMA_MACS_PER_CALL  # noqa: E731
                           / INT8_OPS_PER_S)
    res["comb_tree_mxu_times"] = {
        "kernel_ms_2752": tm_wave, "kernel_ms_8192": tm8k, "kernel_ms_65536": tm64k, "plain_ms_8192": tmplain,
        "bound_ms_8192": cbound(len(citems)), "bound_ms_65536": cbound(BIG), "bound_by": cbound_by,
        "sigs_per_s_8192": len(citems) / (tm8k / 1e3), "sigs_per_s_65536": BIG / (tm64k / 1e3),
        "teams_per_signature": CC.TREE_MXU_TEAMS, "calls_per_signature": CC.TREE_MXU_CALLS_PER_SIGNATURE,
        "mma_macs_per_call": CC.MMA_MACS_PER_CALL,
        "tensor_int8_estimate_ms_8192": tm_tensor(len(citems)), "tensor_int8_estimate_ms_65536": tm_tensor(BIG),
        "profiler_ms_per_pass": tmsplit, "launch_size_sweep": tmsweep,
        "sweep_lanes_differing_from_comb_mxu_cu_or_verdicts": tm_vs_sweep,
        "comb_mxu_cu_over_tree_ms_2752": mc_wave / tm_wave, "comb_mxu_cu_over_tree_ms_8192": mc8k / tm8k,
        "comb_mxu_cu_over_tree_ms_65536": mc64k / tm64k,
        "attributes": res["kernel_attributes"]["comb_tree_mxu"], "ptxas": res["ptxas"].get("comb_tree_mxu", []),
        "sass": res["sass_comb_tree_mxu"],
    }
    print(f"[comb tree mxu times] {res['comb_tree_mxu_times']}", flush=True)

    # 8. service with known signers: every grant takes the comb kernel
    pubs = [s.pub for s in signers]
    svc2, (_, clogs) = _drive(lambda: drive_service(traffic, "cuda", secret, signers=pubs), "service_signers",
                              res)
    check_comb(n for n, _, _ in clogs["chain"])
    problems = []
    if svc2["mismatched_requests"]:
        problems.append(f"{svc2['mismatched_requests']} bitmaps differ from the expected verdicts")
    if (svc2["comb_launches"]["chain"] <= 0 or _other_comb_launches(svc2, "chain")
            or svc2["routing"]["comb_items"] != svc2["items"]):
        problems.append(f"comb launches {svc2['comb_launches']}, routing {svc2['routing']} for {svc2['items']} items")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks", "verify_launches",
                "verify_mxu_launches"):
        if svc2[key]:
            problems.append(f"service with signers: {key} = {svc2[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 8t. the same traffic under MOCHI_COMB_IMPL=tree: every grant takes the
    # tree kernel
    try:
        comb.COMB_IMPL = "tree"
        svc2t, (_, tlogs) = _drive(lambda: drive_service(traffic, "cuda", secret, signers=pubs),
                                   "service_signers_tree", res)
    finally:
        comb.COMB_IMPL = impl0
    tlog = tlogs["tree"]
    for n in sorted({n for n, _, _ in tlog} - set(tcheck)):
        tcheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant, "tree")
    svc2t["tree_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in tlog})
    print(f"[service with signers, tree] tree kernel equals plain at lane counts "
          f"{svc2t['tree_lane_counts_checked_vs_plain']}", flush=True)
    problems = []
    if svc2t["mismatched_requests"]:
        problems.append(f"{svc2t['mismatched_requests']} bitmaps differ from the expected verdicts")
    if (svc2t["comb_launches"]["tree"] <= 0 or _other_comb_launches(svc2t, "tree")
            or svc2t["routing"]["comb_items"] != svc2t["items"]):
        problems.append(f"comb launches {svc2t['comb_launches']}, routing {svc2t['routing']} "
                        f"for {svc2t['items']} items")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks", "verify_launches",
                "verify_mxu_launches"):
        if svc2t[key]:
            problems.append(f"service with signers under the tree: {key} = {svc2t[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 8m. the same traffic under MOCHI_SKEW_IMPL=mxu: every grant takes the
    # chain under mxu
    try:
        F.SKEW_IMPL = "mxu"
        svc2m, (_, mlogs) = _drive(lambda: drive_service(traffic, "cuda", secret, signers=pubs),
                                   "service_signers_mxu", res)
        for n in sorted({n for n, _, _ in mlogs["chain_mxu"]} - set(mccheck)):
            mccheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant)
    finally:
        F.SKEW_IMPL = skew0
    svc2m["chain_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in mlogs["chain_mxu"]})
    print(f"[service with signers, mxu] chain under mxu equals plain at lane counts "
          f"{svc2m['chain_mxu_lane_counts_checked_vs_plain']}", flush=True)
    problems = comb_mxu_service_problems(svc2m)
    if problems:
        raise AssertionError("; ".join(problems))

    # 8tm. the same traffic under both switches: every grant takes the tree
    # under mxu
    try:
        comb.COMB_IMPL, F.SKEW_IMPL = "tree", "mxu"
        svc2tm, (_, tmlogs) = _drive(lambda: drive_service(traffic, "cuda", secret, signers=pubs),
                                     "service_signers_tree_mxu", res)
        for n in sorted({n for n, _, _ in tmlogs["tree_mxu"]} - set(tmcheck)):
            tmcheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant, "tree")
    finally:
        comb.COMB_IMPL, F.SKEW_IMPL = impl0, skew0
    svc2tm["tree_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in tmlogs["tree_mxu"]})
    print(f"[service with signers, tree and mxu] tree under mxu equals plain at lane counts "
          f"{svc2tm['tree_mxu_lane_counts_checked_vs_plain']}", flush=True)
    problems = comb_mxu_service_problems(svc2tm, kernel="tree_mxu")
    if problems:
        raise AssertionError("; ".join(problems))

    # 9. the cluster: the system's main path
    cl, (vlogs2, clogs2) = _drive(lambda: drive_cluster("cuda", CLUSTER_N, CLUSTER_CLIENTS, CLUSTER_WRITES),
                                  "cluster", res)
    vlog2, clog2 = vlogs2["pad"], clogs2["chain"]
    check_comb(n for n, _, _ in clog2)
    for n in sorted({n for n, _, _ in vlog2} - set(checked)):
        checked[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
    cl["comb_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in clog2})
    cl["verify_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in vlog2})
    print(f"[cluster] comb kernel equals plain at lane counts {cl['comb_lane_counts_checked_vs_plain']}, "
          f"general kernel at {cl['verify_lane_counts_checked_vs_plain']}", flush=True)
    problems = []
    if cl["comb_launches"]["chain"] <= 0 or cl["routing"]["comb_items"] <= 0:
        problems.append(f"the comb kernel carried nothing: {cl['comb_launches']} launches, {cl['routing']}")
    if _other_comb_launches(cl, "chain") or cl["verify_mxu_launches"]:
        problems.append(f"cluster: comb launches {cl['comb_launches']}, mxu launches {cl['verify_mxu_launches']}")
    for key in ("fallback_batches", "crossover_batches"):
        if cl[key]:
            problems.append(f"cluster: {key} = {cl[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 9m. the cluster under MOCHI_SKEW_IMPL=mxu, at a cut depth: grants on the
    # chain under mxu, client keys on the mxu general kernel
    try:
        F.SKEW_IMPL = "mxu"
        clm, (vlogs_m2, clogs_m2) = _drive(
            lambda: drive_cluster("cuda", CLUSTER_N, CLUSTER_MXU_CLIENTS, CLUSTER_MXU_WRITES), "cluster_mxu", res)
        for n in sorted({n for n, _, _ in clogs_m2["chain_mxu"]} - set(mccheck)):
            mccheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant)
        for n in sorted({n for n, _, _ in vlogs_m2["mxu"]} - set(mcheck)):
            mcheck[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
    finally:
        F.SKEW_IMPL = skew0
    clm["chain_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in clogs_m2["chain_mxu"]})
    clm["verify_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in vlogs_m2["mxu"]})
    print(f"[cluster, mxu] chain under mxu equals plain at lane counts {clm['chain_mxu_lane_counts_checked_vs_plain']}"
          f", mxu general kernel at {clm['verify_mxu_lane_counts_checked_vs_plain']}", flush=True)
    problems = cluster_mxu_problems(clm)
    if problems:
        raise AssertionError("; ".join(problems))

    # 9tm. the cluster under both switches, at 9m's cut depth: grants on the
    # tree under mxu, client keys on the mxu general kernel
    try:
        comb.COMB_IMPL, F.SKEW_IMPL = "tree", "mxu"
        cltm, (vlogs_tm2, clogs_tm2) = _drive(
            lambda: drive_cluster("cuda", CLUSTER_N, CLUSTER_MXU_CLIENTS, CLUSTER_MXU_WRITES), "cluster_tree_mxu",
            res)
        for n in sorted({n for n, _, _ in clogs_tm2["tree_mxu"]} - set(tmcheck)):
            tmcheck[n] = _check_comb_at(n, table17, table17, lanes, big_lanes, cprep[6], cwant, "tree")
        for n in sorted({n for n, _, _ in vlogs_tm2["mxu"]} - set(mcheck)):
            mcheck[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
    finally:
        comb.COMB_IMPL, F.SKEW_IMPL = impl0, skew0
    cltm["tree_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in clogs_tm2["tree_mxu"]})
    cltm["verify_mxu_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in vlogs_tm2["mxu"]})
    print(f"[cluster, tree and mxu] tree under mxu equals plain at lane counts "
          f"{cltm['tree_mxu_lane_counts_checked_vs_plain']}, mxu general kernel at "
          f"{cltm['verify_mxu_lane_counts_checked_vs_plain']}", flush=True)
    problems = cluster_mxu_problems(cltm, kernel="tree_mxu")
    if problems:
        raise AssertionError("; ".join(problems))

    # 10-12. several cards: the sharded service, the quorum step, NCCL
    qres = sharded_phases(args.seed, res, traffic, signers, secret, dev, check_comb)
    q_tally = qres["tally"]

    # 13, 13p. verified recovery from disk: the WAL engine, then the paged one
    with tempfile.TemporaryDirectory(prefix="mochi-smoke-") as td:
        spans = Spans("cuda")
        res["recovery"] = rec = asyncio.run(drive_recovery(
            "cuda", CLUSTER_N, RECOVERY_CLIENTS, RECOVERY_WRITES, os.path.join(td, "wal"), spans))
        print(f"[recovery] {rec}", flush=True)
        problems = recovery_problems(rec)
        if problems:
            raise AssertionError("; ".join(problems))
        spans = Spans("cuda")
        res["recovery_paged"] = recp = asyncio.run(drive_recovery_paged(
            "cuda", CLUSTER_N, RECOVERY_PAGED_CLIENTS, RECOVERY_WRITES, os.path.join(td, "paged"), spans))
        print(f"[recovery, paged] {recp}", flush=True)
        problems = recovery_paged_problems(recp)
        if problems:
            raise AssertionError("; ".join(problems))
    for r in rec["recoveries"] + [recp["compaction"], recp["audit"]]:
        check_comb(r["comb_lane_counts"])

    # 14, 14s. a cluster of replica processes: the card in every child, then a sidecar that owns it
    process_phases(res)

    res["kernels"] = [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/verify.cu",
        "design": "a team of 4 lanes a signature (csrc/verify25519.cuh), [S]B by the basepoint comb",
        "replaces": "mochi_tpu/crypto/pallas_verify.py:132",
        "launches": svc["verify_launches"],
        "max_abs_err": max([max_abs_err, *checked.values()]),
        "ms": ms_8k,
        "ms_65536": ms_64k,
        "plain_ms": plain_ms,
        "bound_ms": bound(len(items)),
        "bound_by": "operations",
        "library_ms": None,
    }, {
        "name": "ed25519_verify_mxu",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/verify_mxu.cu",
        "design": "a team of 4 lanes a signature, 8 a warp; each lane forms a quarter of a multiply's limb "
                  "products straight into the m16n8k32 A fragments (csrc/fe17_team.cuh), two independent "
                  "multiplies a call",
        "replaces": "mochi_tpu/crypto/field.py:330",
        "launches": svc_m["verify_mxu_launches"],
        "max_abs_err": max([*mcheck.values(), mul_err]),
        "ms": mxu_8k,
        "ms_2752": mxu_wave,
        "ms_65536": mxu_64k,
        "plain_ms": mxu_plain,
        "bound_ms": bound(len(items)),
        "bound_by": "operations",
        "library_ms": None,
        "mul_ms_65536": mul_ms,
        "mul_bound_ms": max(mul_bounds.values()),
        "mul_bound_by": res["mxu_times"]["mul_bound_by"],
    }, {
        "name": "comb_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/comb.cu",
        "design": f"a team of {ca['team']} lanes a signature, one a warp (csrc/comb_team.cuh), "
                  "the last also decoding R",
        "replaces": "mochi_tpu/crypto/comb.py:512",
        "launches": cl["comb_launches"]["chain"],
        "max_abs_err": max(ccheck.values()),
        "ms": c8k,
        "ms_65536": c64k,
        "plain_ms": cplain,
        "bound_ms": cbound(len(citems)),
        "bound_by": res["comb_times"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "comb_verify_mxu",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/comb_mxu.cu",
        "replaces": "mochi_tpu/crypto/comb.py:512",
        "replaces_also": "mochi_tpu/crypto/field.py:330",
        "launches": clm["comb_launches"]["chain_mxu"],
        "launches_service": svc2m["comb_launches"]["chain_mxu"],
        "max_abs_err": max(mccheck.values()),
        "ms": mc8k,
        "ms_65536": mc64k,
        "plain_ms": mcplain,
        "bound_ms": cbound(len(citems)),
        "bound_by": res["comb_mxu_times"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "comb_tree_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/comb_tree.cu",
        "design": f"one launch: a decode warp beside {res['kernel_attributes']['comb_tree']['team']} lanes a "
                  "signature summing its window points, four warps a block (csrc/comb_tree.cuh)",
        "replaces": "mochi_tpu/crypto/comb.py:428",
        "launches": svc2t["comb_launches"]["tree"],
        "max_abs_err": max(tcheck.values()),
        "ms": t8k,
        "ms_2752": t_wave,
        "ms_65536": t64k,
        "plain_ms": tplain,
        "bound_ms": cbound(len(citems)),
        "bound_by": res["comb_tree_times"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "comb_tree_verify_mxu",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/comb_tree_mxu.cu",
        "replaces": "mochi_tpu/crypto/comb.py:428",
        "replaces_also": "mochi_tpu/crypto/field.py:330",
        "launches": cltm["comb_launches"]["tree_mxu"],
        "launches_service": svc2tm["comb_launches"]["tree_mxu"],
        "max_abs_err": max(tmcheck.values()),
        "ms": tm8k,
        "ms_2752": tm_wave,
        "ms_65536": tm64k,
        "plain_ms": tmplain,
        "bound_ms": cbound(len(citems)),
        "bound_by": cbound_by,
        "library_ms": None,
    }, {
        "name": "quorum_tally",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/tally.cu",
        "design": "a warp sums each step's equal slots (match_any, ballot) and carries the run that reaches "
                  "its last lane: one atomic a run a warp (csrc/tally.cuh)",
        "replaces": "mochi_tpu/parallel/sharded.py:216",
        "launches": qres["launches"]["tally"],
        "max_abs_err": q_tally["max_abs_err"],
        "ms": q_tally["ms"],
        "plain_ms": q_tally["plain_ms"],
        "bound_ms": q_tally["bound_ms"],
        "bound_by": "bytes",
        "library_ms": q_tally["library_ms"],
    }, {
        "name": "quorum_commit",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/tally.cu",
        "replaces": "mochi_tpu/parallel/sharded.py:220",
        "launches": qres["launches"]["commit"],
        "max_abs_err": qres["commit"]["max_abs_err"],
        "ms": qres["commit"]["ms"],
        "plain_ms": qres["commit"]["plain_ms"],
        "bound_ms": qres["commit"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": qres["commit"]["library_ms"],
    }, {
        "name": "quorum_tally_commit",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/tally.cu",
        "design": "the tally kernel, then the last block (a ticket) writes counts >= threshold",
        "replaces": "mochi_tpu/parallel/sharded.py:216",
        "replaces_also": "mochi_tpu/parallel/sharded.py:220",
        "launches": qres["launches"]["fused_tally_commit"],
        "max_abs_err": qres["fused"]["max_abs_err"],
        "ms": qres["fused"]["ms"],
        "plain_ms": qres["fused"]["plain_ms"],
        "bound_ms": qres["fused"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    return res


def sharded_phases(seed: int, res: dict, traffic, signers: List[Signer], secret: bytes, dev, check_comb) -> dict:
    """Phases 10-12 over every visible card (see the module docstring);
    ``check_comb(lane_counts)`` holds the comb kernel against its plain
    version at the lane counts the sharded service launched.  Returns the
    quorum step's record."""
    import torch

    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier, ShardedCudaBatchVerifier

    # 10. the sharded service: phase 8's traffic split over every card
    pubs = [s.pub for s in signers]
    n_cards = torch.cuda.device_count()
    svc3, (_, clogs3) = _drive(
        lambda: drive_service(traffic, "cuda", secret, make_verifier=lambda: ShardedCudaBatchVerifier(signers=pubs)),
        "sharded_service", res)
    check_comb(n for n, _, _ in clogs3["chain"])
    svc3["cards"] = n_cards
    problems = []
    if svc3["mismatched_requests"]:
        problems.append(f"{svc3['mismatched_requests']} bitmaps differ from the expected verdicts")
    if (svc3["comb_launches"]["chain"] <= 0 or _other_comb_launches(svc3, "chain")
            or svc3["routing"]["comb_items"] != svc3["items"]):
        problems.append(f"comb launches {svc3['comb_launches']}, routing {svc3['routing']} for {svc3['items']} items")
    idle_cards = [i for i in range(n_cards) if svc3["launches_by_card"].get(f"cuda:{i}", 0) <= 0]
    if idle_cards:
        problems.append(f"no comb launches on cards {idle_cards}: {svc3['launches_by_card']}")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks", "verify_launches",
                "verify_mxu_launches"):
        if svc3[key]:
            problems.append(f"sharded service: {key} = {svc3[key]}")
    if problems:
        raise AssertionError("; ".join(problems))
    # the host-bound drives vary between runs: the sharded and single-card
    # verifiers again, in turns, on the same traffic
    turns = []
    for name, make in (("single card", lambda: CudaBatchVerifier(signers=pubs)),
                       ("sharded", lambda: ShardedCudaBatchVerifier(signers=pubs)),
                       ("single card", lambda: CudaBatchVerifier(signers=pubs))):
        r = asyncio.run(drive_service(traffic, "cuda", secret, make_verifier=make))
        if r["mismatched_requests"] or r["fallback_batches"]:
            raise AssertionError(f"{name} turn: {r}")
        turns.append({"verifier": name, **{k: r[k] for k in ("items_per_s", "p50_ms", "p99_ms", "wall_s")}})
    svc3["turns_after"] = turns
    print(f"[sharded service] turns {turns}", flush=True)

    # 11. the quorum step on the card
    qres = quorum_phase(seed, traffic, signers, dev, res)

    # 12. several processes, one card each, one NCCL group
    t0 = time.perf_counter()
    recs = run_multihost("nccl", n_cards)
    want_mh = check_multihost(recs, "nccl")
    res["multihost"] = {"processes": n_cards, "expected_counts": want_mh, "records": recs,
                        "seconds": time.perf_counter() - t0}
    print(f"[multihost] {res['multihost']}", flush=True)
    return qres


def quorum_phase(seed: int, traffic, signers: List[Signer], dev, res: dict) -> dict:
    """Phase 11: the quorum step on the mesh of every card and on two slices
    of one card (see the module docstring).  A certificate carries 2f+1
    grants, so the threshold is the traffic's grants per check.  Records
    into ``res["quorum"]`` and returns it."""
    import torch

    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import cuda_verify as CV
    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel import make_mesh
    from mochi_tpu_torch.parallel.sharded import commit, segment_tally

    ns = (NS_SLOTS, NS_VOTERS, NS_FORGED)
    grants = threshold = len(traffic[0][0][0])
    t0 = time.perf_counter()
    qitems, qwant, qgids, forged = quorum_stream(traffic, seed + 5, grants)
    n_stream, n_certs = len(qitems), len(qitems) // grants
    full = [c for c in range(n_certs) if all(qwant[c * grants:(c + 1) * grants])]
    qitems = qitems + host_rejected_items(signers[0])  # voting for an all-valid certificate
    qwant = qwant + [False, False]
    qgids = np.concatenate([qgids, [full[0], full[0]]]).astype(np.int32)
    ns_items, ns_want, ns_gids = north_star_votes(signers, *ns)
    qprep, nsprep = BV.prepare_packed(qitems), BV.prepare_packed(ns_items)
    make_s = time.perf_counter() - t0

    # the two host-rejected lanes: the device accepts them, the host does not
    raw = CV.verify_prepared_packed(*CV.from_reference_prepared(qprep, dev))
    raw_tail = raw[-2:].cpu().tolist()
    if raw_tail != [True, True] or qprep[6][-2:].tolist() != [False, False]:
        raise AssertionError(f"host-rejected lanes: device {raw_tail}, host {qprep[6][-2:].tolist()}")

    meshes = {"all cards": make_mesh(), "two slices of cuda:0": make_mesh(devices=["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() > 1:
        meshes["cuda:0 alone"] = make_mesh(devices=["cuda:0"])
    first_mesh = next(iter(meshes))
    legs = {"certificate stream": (qprep, qgids, qwant, n_certs),
            "north star": (nsprep, ns_gids, ns_want, ns[0])}
    out: dict = {"certificates": n_certs, "lanes": len(qitems), "forged_certificates": len(forged),
                 "all_valid_certificates": len(full), "host_rejected_lanes_device_verdict": raw_tail,
                 "seconds_to_make": make_s}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _zero_counts()
    legs_out, tally_lanes = {}, set()
    for mname, mesh in meshes.items():
        for lname, (prep, gids, want, n_groups) in legs.items():
            leg = legs_out[f"{lname} / {mname}"] = run_quorum_leg(mesh, prep, gids, want, n_groups, threshold)
            tally_lanes.add(leg["padded_lanes"] // mesh.size)  # the lanes of each slice's tally
    counts_out: dict = {}
    _read_counts(counts_out)
    out["launches"] = {"verify": counts_out["verify_launches"], "tally": counts_out["tally_launches"],
                       "fused_tally_commit": counts_out["fused_tally_launches"],
                       "commit": counts_out["commit_launches"], "by_card": counts_out["launches_by_card"]}
    if dev.type == "cuda" and min(out["launches"]["verify"], out["launches"]["tally"],
                                  out["launches"]["fused_tally_commit"], out["launches"]["commit"]) <= 0:
        raise AssertionError(f"the quorum step did not run every kernel: {out['launches']}")
    ns_counts = legs_out[f"north star / {first_mesh}"]["counts"].tolist()
    if ns_counts != [ns[1]] * (ns[0] - 1) + [ns[1] - ns[2]]:
        raise AssertionError(f"north-star counts {ns_counts}")
    stream = legs_out[f"certificate stream / {first_mesh}"]["counts"]
    if any(stream[c] != grants for c in full) or any(stream[c] >= threshold for c in forged):
        raise AssertionError("an all-valid certificate did not commit, or a forged one did")
    for v in legs_out.values():
        v["counts"] = v["counts"].tolist() if len(v["counts"]) <= ns[0] else "equal to the oracle"
    out["legs"] = legs_out

    # the tally kernel and the fused tally-and-commit against their plain
    # versions at every lane count the step ran, on ids that wrap and drop,
    # with every lane in one slot, on views one byte into their storage and
    # on no lane
    ok_dev = torch.from_numpy(qprep[6]).to(dev)
    ids_dev = torch.from_numpy(qgids).to(dev)
    g = n_certs + 1
    checked = {n: check_tally_vs_plain(raw[:n], ok_dev[:n], ids_dev[:n], g) for n in sorted(tally_lanes)}
    fused_checked = {n: check_fused_vs_plain(raw[:n], ok_dev[:n], ids_dev[:n], g, threshold)
                     for n in sorted(tally_lanes)}
    wild = torch.from_numpy(np.random.default_rng(seed + 6).integers(-2 * g, 2 * g, len(qgids)).astype(np.int32))
    wild = wild.to(dev)
    ones = torch.ones(n_stream, dtype=torch.bool, device=dev)
    one_slot = torch.zeros(n_stream, dtype=torch.int32, device=dev)
    nothing = (raw[:0], ok_dev[:0], ids_dev[:0])
    cases = {"wrap_and_drop_ids": (raw, ok_dev, wild), "one_slot": (ones, ones, one_slot),
             "offset_1": (raw[1:], ok_dev[1:], ids_dev[1:]), "no_lane": nothing}
    case_err = {cname: max([check_tally_vs_plain(*lanes, g)]
                           + [check_fused_vs_plain(*lanes, g, t) for t in (threshold, 0, 1)])
                for cname, lanes in cases.items()}
    one_slot_counts = CT.quorum_tally(ones, ones, one_slot, g)
    if int(one_slot_counts[0]) != n_stream or int(one_slot_counts[1:].sum()) != 0:
        raise AssertionError(f"one slot: {one_slot_counts[:4].tolist()}")

    # times at the certificate stream's 66,048 lanes
    b, o, i = raw[:n_stream], ok_dev[:n_stream], ids_dev[:n_stream]
    votes = (b & o).to(torch.int32)
    counts_k = CT.quorum_tally(b, o, i, g)
    lib = torch.zeros(g, dtype=torch.int32, device=dev).index_add_(0, i, votes)
    if not torch.equal(lib, counts_k):
        raise AssertionError("index_add_ and the tally kernel disagree")
    # "ms" is the card's time per call (a CUDA graph's replay); "eager_ms"
    # the host's rate of eager calls, which these short kernels are bound by
    def tally_k():
        return CT.quorum_tally(b, o, i, g)

    def fused_k():
        return CT.quorum_tally_commit(b, o, i, g, threshold)

    def tally_lib():
        return torch.zeros(g, dtype=torch.int32, device=dev).index_add_(0, i, votes)

    def empty_tally():  # no lane, no slot: no memset, one block that adds nothing
        return CT.quorum_tally(*nothing, 0)

    tally = {
        "lanes": n_stream, "slots": g, "max_abs_err": max([*case_err.values(), *checked.values()]),
        "lane_counts_checked": sorted(checked), "wrap_and_drop_ids_max_abs_err": case_err["wrap_and_drop_ids"],
        "cases_max_abs_err": case_err,
        "ms": _graph_ms(tally_k, 200), "eager_ms": _ms_per_call(tally_k, 200),
        "plain_ms": _graph_ms(lambda: segment_tally(b, o, i, g), 5),
        "library_ms": _graph_ms(tally_lib, 200), "library_eager_ms": _ms_per_call(tally_lib, 200),
        "library_call": "torch.zeros(slots).index_add_(0, group_ids, votes)",
        "bound_ms": 1e3 * (n_stream * CT.BYTES_PER_LANE + g * 4) / HBM_BYTES_PER_S,
        "one_slot_ms": _graph_ms(lambda: CT.quorum_tally(ones, ones, one_slot, g), 200),
        "empty_tally_ms": _graph_ms(empty_tally, 200),
        # the floor of one node of a CUDA graph: an empty PyTorch kernel
        "graph_floor_ms": _graph_ms(lambda: torch.cuda._sleep(0), 200),
        "attributes": res.get("kernel_attributes", {}).get("tally"), "ptxas": res.get("ptxas", {}).get("tally"),
    }
    fused = {
        "lanes": n_stream, "slots": g, "threshold": threshold,
        "max_abs_err": max([*case_err.values(), *fused_checked.values()]),
        "lane_counts_checked": sorted(fused_checked),
        "ms": _graph_ms(fused_k, 200), "eager_ms": _ms_per_call(fused_k, 200),
        "plain_ms": _graph_ms(lambda: commit(segment_tally(b, o, i, g), threshold), 5),
        "library_two_calls_ms": _graph_ms(lambda: torch.ge(tally_lib(), threshold), 200),
        "library_two_calls": "index_add_ as the tally's, then torch.ge(counts, threshold)",
        "bound_ms": 1e3 * (n_stream * CT.BYTES_PER_LANE + g * (4 + 1)) / HBM_BYTES_PER_S,
        "attributes": res.get("kernel_attributes", {}).get("tally_fused"),
    }
    if dev.type == "cuda":  # device time by node: the memset and the kernel
        tally["profiler_ms"] = kernel_split_ms(tally_k, 20, names=("mochi", "Memset", "memset"))
        fused["profiler_ms"] = kernel_split_ms(fused_k, 20, names=("mochi", "Memset", "memset"))
        print(f"[quorum] tally kernel {tally['attributes']}, fused {fused['attributes']}; ptxas "
              f"{tally['ptxas']}", flush=True)
    committed_k = CT.quorum_commit(counts_k, threshold)
    c_err = int((committed_k.to(torch.int64) - commit(counts_k, threshold).to(torch.int64)).abs().max().item())
    if c_err:
        raise AssertionError("the commit kernel disagrees with its plain version")
    out["commit"] = {
        "slots": g, "max_abs_err": c_err,
        "ms": _graph_ms(lambda: CT.quorum_commit(counts_k, threshold), 200),
        "eager_ms": _ms_per_call(lambda: CT.quorum_commit(counts_k, threshold), 200),
        "plain_ms": _graph_ms(lambda: commit(counts_k, threshold), 200),
        "library_ms": _graph_ms(lambda: torch.ge(counts_k, threshold), 200),
        "library_eager_ms": _ms_per_call(lambda: torch.ge(counts_k, threshold), 200),
        "library_call": "torch.ge(counts, threshold)",
        "bound_ms": 1e3 * g * (4 + 1) / HBM_BYTES_PER_S,
    }
    out["fused"] = fused
    out["tally"] = tally
    # the whole step (host prepare excluded: inputs already packed), host clock
    step_s = {}
    for mname, mesh in meshes.items():
        walls = [run_quorum_leg(mesh, qprep, qgids, qwant, n_certs, threshold)["step_s"] for _ in range(3)]
        step_s[mname] = {"median_ms": 1e3 * statistics.median(walls), "runs_ms": [1e3 * w for w in walls]}
    out["step_ms"] = step_s
    res["quorum"] = out
    print(f"[quorum] {out}", flush=True)
    return out


def _check_comb_at(n, table, table15, lanes, big_lanes, pre_ok, want, impl: str = "chain") -> int:
    """The comb kernel of ``impl`` (under the multiply switch in effect)
    against its plain version at ``n`` lanes of the comb corpus (tiled past
    its length)."""
    src = lanes if n <= lanes[0].shape[0] else big_lanes
    reps = -(-n // len(want))
    return check_comb_vs_plain(table, table15, [t[:n] for t in src], np.tile(pre_ok, reps)[:n],
                               (list(want) * reps)[:n], impl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result as JSON here")
    ap.add_argument("--only", choices=("14",), default=None,
                    help="run only the device and build phases and phase 14 (with 14s), print their "
                         "records and no result line")
    args = ap.parse_args(argv)
    try:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        res = run(args)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if args.only:
        print(json.dumps({k: res[k] for k in ("processes", "processes_service")}))
        return 0
    print(json.dumps({"kernels": res["kernels"]}))
    print(res["device"]["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": res["device"]["name"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
