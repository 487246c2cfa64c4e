#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mochi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed N] [--out F]``

Phases (any failure exits non-zero and prints no result line):

1. Device — the card's name, ``nvidia-smi`` name and power limit, compute
   capability, SM count, maximum SM clock, and the host's Ed25519 engine.
   No CUDA device: exit 2.
2. Build — compile both kernels, ``mochi_tpu_torch/csrc/verify.cu`` and
   ``comb.cu``, one nvcc each, started together; report ptxas's registers
   and spills and each kernel's attributes.
3. Kernel vs plain — an 8192-item corpus made from ``--seed``: valid
   signatures from 64 signers, forgeries, and adversarial encodings
   (low-order and mixed-order points, non-points, x = 0 with the sign bit,
   S >= L, y >= p, truncated lengths).  The kernel's bitmap must equal the
   plain PyTorch version's on the card and the expected verdicts; a random
   sample of 256 lanes is also checked against the port's ``keys.verify``.
   The same holds on the first wave of the service traffic, 64 x 43 = 2,752
   lanes (a partial last block), and, after phase 5, on a slice of the
   traffic at every other lane count the service launched.
4. Times — CUDA events, median over repeats after a warm-up: the kernel at
   8192 and 65536 lanes, the plain version at 8192, host prepare per item,
   and the bound (integer multiply-adds over the card's IMAD rate).
5. Service — the main path: ``VerifierService(CudaBatchVerifier())`` on
   loopback with a shared secret, driven by 64 concurrent ``RemoteVerifier``
   clients (one per replica of an n=64, f=21 cluster), each sending
   certificate checks of 2f+1 = 43 grants, 66,048 distinct items in all.
   Every bitmap must equal the expected verdicts, the kernel must have been
   launched, every item must have been verified on the device, and no layer
   may have fallen back to the CPU.  Each launch is timed with CUDA events on
   its own stream (``cuda_verify.launch_log``); the union of those intervals
   over the drive's span is the card's kernel-busy share.
6. Comb vs plain — the comb kernel (registered signers): an 8192-lane corpus
   signed by the 64 registered signers (valid, forged, another registered
   signer's key, adversarial R — small order, non-point, x = 0 with the sign
   bit, y >= p — and S >= L), at 8192 lanes and at a partial last block.
   The kernel's bitmap must equal the plain version's on the card and the
   expected verdicts, 256 sampled lanes must equal ``keys.verify``, and the
   uploaded kernel-radix table must equal the 17 x 15 rows integer for
   integer.
7. Comb times — CUDA events at 8192 and 65536 lanes, a launch-size sweep,
   the plain version at 8192, the bound, and one lone 43-grant certificate
   through ``verify_batch`` with the registry.
8. Service with signers — phase 5's traffic through
   ``CudaBatchVerifier(signers=...)``: every item must take the comb kernel
   and every bitmap must equal the expected verdicts.
9. Cluster — the main path of the system: ``VirtualCluster(64, rf=64)``
   (f = 21, quorum 43) with one ``CudaBatchVerifier(device="cuda")`` shared
   by all 64 replicas (the replicas register the cluster identities, so
   grant signatures take the comb kernel).  Concurrent SDK clients commit
   signed PUTs, then read each key back: every acked write must read back
   its value with a 43-grant certificate, the comb kernel must have carried
   the grants, and nothing may have fallen back to the CPU.  Each kernel is
   held against its plain version at every lane count it launched here.

Phases 5, 8 and 9 drive the main path: each zeroes the launch counts just
before it and reads them just after.  The last three lines of standard
output are the kernel table (JSON), the ``nvidia-smi`` name/power-limit
line, and ``{"ok": true, "device": ...}``.

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
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
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
PARTIAL = 37  # lanes short of a full last block in the partial-block check
REPEATS = 20  # timed kernel launches at CORPUS lanes
IMAD_PER_SM_PER_CLOCK = 64  # 32-bit integer multiply-add, compute capability 9.0

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


# ------------------------------------------------------------------ phases


def _nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0].strip()


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


def check_comb_vs_plain(table25, table15, lanes, pre_ok, want) -> int:
    """The comb kernel and its plain version on the same card tensors: the
    max abs difference of their bitmaps.  Raises if the kernel's verdicts
    (ANDed with ``pre_ok``) differ from ``want``."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    got = CC.verify_comb_prepared(table25, *lanes)
    plain = comb.verify_comb_prepared(table15, *lanes)
    got_np, plain_np = got.cpu().numpy(), plain.cpu().numpy()
    err = int(np.abs(got_np.astype(np.int64) - plain_np.astype(np.int64)).max())
    wrong = int(np.sum(np.logical_and(got_np, pre_ok) != np.asarray(want, dtype=bool)))
    if err or wrong:
        raise AssertionError(f"comb kernel disagrees at {len(want)} lanes: vs plain {err}, {wrong} wrong verdicts")
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
                        signers=()) -> dict:
    """Boot the verifier service on loopback (with ``signers`` as its known
    signers) and drive it from one RemoteVerifier per client, concurrently.
    Returns counts and times."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.service import RemoteVerifier, VerifierService

    verifier = CudaBatchVerifier(device=device, signers=list(signers))
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


def _zero_counts():
    """Launch counts and traces zeroed just before a main-path phase."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import cuda_verify as CV

    CV.launches = CC.launches = 0
    BV.reset_counts()
    CV.launch_log, CC.launch_log = [], []


def _read_counts(out: dict):
    """Counts and traces read just after a main-path phase; returns the
    (verify, comb) launch logs and turns tracing off."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import cuda_verify as CV

    out["verify_launches"] = CV.launches
    out["comb_launches"] = CC.launches
    out["device_items"] = BV.device_item_count()
    out["device_dispatches"] = BV.device_dispatch_count()
    out["routing"] = BV.comb_routing_counts()
    logs = (CV.launch_log, CC.launch_log)
    CV.launch_log = CC.launch_log = None
    return logs


def _drive(coro_fn, out_key: str, res: dict):
    """Run one main-path phase between two card events, with the counts
    zeroed just before and read just after; the kernel-busy share is the
    union of both kernels' logged launches over the phase's span."""
    import torch

    ref0, ref1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_counts()
    ref0.record()
    out = asyncio.run(coro_fn())
    logs = _read_counts(out)
    torch.cuda.synchronize()
    ref1.record()
    ref1.synchronize()
    out["device"] = device_busy(logs[0] + logs[1], ref0, ref1)
    out["device"]["verify_kernel"] = device_busy(logs[0], ref0, ref1)["launch_ms_by_lanes"]
    out["device"]["comb_kernel"] = device_busy(logs[1], ref0, ref1)["launch_ms_by_lanes"]
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
    from mochi_tpu_torch.crypto import keys

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
    res["kernel_attributes"] = {"verify": CV.kernel_attributes(), "comb": CC.kernel_attributes()}
    print(f"[build] {res['build_s']:.1f} s {took}; {res['kernel_attributes']}", flush=True)
    for name in ("verify", "comb"):
        for ln in kernels.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] ptxas {name}: {ln.strip()}", flush=True)

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    signers = make_signers(rng, CLIENTS)
    items, want, kinds = make_corpus(args.seed, CORPUS, signers)
    traffic = make_traffic(args.seed + 1, signers, clients=CLIENTS, requests=REQUESTS, grants=GRANTS)
    res["corpus_s"] = time.perf_counter() - t0
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
    l0, t0 = CV.launches, time.perf_counter()
    for _ in range(10):
        BV.verify_batch(cert, dev)
    cert_ms, cert_launches = 1e2 * (time.perf_counter() - t0), (CV.launches - l0) / 10
    # launch size: one launch of n lanes, n from 1024 to 4 x the large launch
    tiled = [torch.cat([t] * 4) for t in big_t]
    sweep = {}
    for n in (1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144):
        if n <= tiled[0].shape[0]:
            part = [t[:n] for t in tiled]
            ms = _ms_median(lambda: CV.verify_prepared_packed(*part), 1, 5)
            sweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
    per_sig_ops = CV.IMADS_PER_SIGNATURE
    bytes_per_sig = 2 * 17 * 4 + 2 * 4 + 2 * 32 + 1
    bound = lambda n: 1e3 * max(n * per_sig_ops / rate, n * bytes_per_sig / 3.35e12)  # noqa: E731
    res["times"] = {
        "kernel_ms_8192": ms_8k, "kernel_ms_65536": ms_64k, "plain_ms_8192": plain_ms,
        "bound_ms_8192": bound(len(items)), "bound_ms_65536": bound(len(flat)),
        "sigs_per_s_8192": len(items) / (ms_8k / 1e3), "sigs_per_s_65536": len(flat) / (ms_64k / 1e3),
        "host_prepare_us_per_item": prep_us, "imads_per_signature": per_sig_ops,
        "imad_rate_per_s": rate, "launch_size_sweep": sweep,
        "cert43_verify_batch_ms": cert_ms, "cert43_launches": cert_launches,
    }
    print(f"[times] {res['times']}", flush=True)

    # 5. service: the main path of the general kernel
    secret = hashlib.sha256(b"chip smoke %d" % args.seed).digest()
    svc, (vlog, _) = _drive(lambda: drive_service(traffic, "cuda", secret), "service", res)
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
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks", "comb_launches"):
        if svc[key]:
            problems.append(f"service: {key} = {svc[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 6. comb vs plain on the card: registered signers
    reg = comb.SignerRegistry(dev)
    reg.register_all([s.pub for s in signers])
    table25 = reg.device_table(dev)
    table15 = torch.from_numpy(reg.host_table()).to(dev)
    table_mismatch = check_table_radix(table25, table15)
    t0 = time.perf_counter()
    citems, cwant, ckinds = make_comb_corpus(args.seed + 3, CORPUS, signers)
    res["comb_corpus_s"] = time.perf_counter() - t0
    cprep = BV.prepare_packed(citems)
    kidx = np.asarray([reg.index_of(it.public_key) for it in citems], dtype=np.int32)
    lanes = CC.from_prepared(kidx, cprep, dev)
    cgot = CC.verify_comb_prepared(table25, *lanes).cpu().numpy()
    cfinal = np.logical_and(cgot, cprep[6])
    cwrong = [k for k, g, w in zip(ckinds, cfinal, cwant) if bool(g) != w]
    ccheck = {len(citems): check_comb_vs_plain(table25, table15, lanes, cprep[6], cwant)}
    part = len(citems) - PARTIAL
    ccheck[part] = check_comb_vs_plain(table25, table15, [t[:part] for t in lanes], cprep[6][:part], cwant[:part])
    csample = np.random.default_rng(args.seed + 4).choice(len(citems), 256, replace=False).tolist()
    csample_wrong = [j for j in csample if keys.verify(citems[j].public_key, citems[j].message,
                                                       citems[j].signature) != bool(cfinal[j])]
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
    big_lanes = [torch.cat([t] * (BIG // len(citems))) for t in lanes]
    c8k = _ms_median(lambda: CC.verify_comb_prepared(table25, *lanes), 3, REPEATS)
    c64k = _ms_median(lambda: CC.verify_comb_prepared(table25, *big_lanes), 2, REPEATS // 2)
    cplain = _ms_median(lambda: comb.verify_comb_prepared(table15, *lanes), 1, 3)
    BV.verify_batch(cert, dev, registry=reg)
    l0, t0 = CC.launches, time.perf_counter()
    for _ in range(10):
        BV.verify_batch(cert, dev, registry=reg)
    ccert_ms, ccert_launches = 1e2 * (time.perf_counter() - t0), (CC.launches - l0) / 10
    ctiled = [torch.cat([t] * 4) for t in big_lanes]
    csweep = {}
    for n in (1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144):
        part_l = [t[:n] for t in ctiled]
        ms = _ms_median(lambda: CC.verify_comb_prepared(table25, *part_l), 1, 5)
        csweep[n] = {"ms": ms, "sigs_per_s": n / (ms / 1e3)}
    # the bound: operations (IMADs) or bytes (each lane's inputs and verdict,
    # plus one read of the signer table and the basepoint comb)
    cbytes = lambda n: n * CC.BYTES_PER_SIGNATURE + (table25.shape[0] + 576) * CC.ENTRY_BYTES  # noqa: E731
    cbound = lambda n: 1e3 * max(n * CC.IMADS_PER_SIGNATURE / rate, cbytes(n) / 3.35e12)  # noqa: E731
    res["comb_times"] = {
        "kernel_ms_8192": c8k, "kernel_ms_65536": c64k, "plain_ms_8192": cplain,
        "bound_ms_8192": cbound(len(citems)), "bound_ms_65536": cbound(BIG),
        "bound_by": "operations" if len(citems) * CC.IMADS_PER_SIGNATURE / rate > cbytes(len(citems)) / 3.35e12
        else "bytes",
        "sigs_per_s_8192": len(citems) / (c8k / 1e3), "sigs_per_s_65536": BIG / (c64k / 1e3),
        "imads_per_signature": CC.IMADS_PER_SIGNATURE, "launch_size_sweep": csweep,
        "cert43_verify_batch_ms": ccert_ms, "cert43_launches": ccert_launches,
        "general_over_comb_ms_8192": ms_8k / c8k,
    }
    print(f"[comb times] {res['comb_times']}", flush=True)

    # 8. service with known signers: every grant takes the comb kernel
    pubs = [s.pub for s in signers]
    svc2, (_, clog) = _drive(lambda: drive_service(traffic, "cuda", secret, signers=pubs), "service_signers", res)
    for n in sorted({n for n, _, _ in clog} - set(ccheck)):
        ccheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant)
    problems = []
    if svc2["mismatched_requests"]:
        problems.append(f"{svc2['mismatched_requests']} bitmaps differ from the expected verdicts")
    if svc2["comb_launches"] <= 0 or svc2["routing"]["comb_items"] != svc2["items"]:
        problems.append(f"comb launches {svc2['comb_launches']}, routing {svc2['routing']} for {svc2['items']} items")
    for key in ("fallback_batches", "crossover_batches", "remote_fallbacks", "verify_launches"):
        if svc2[key]:
            problems.append(f"service with signers: {key} = {svc2[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    # 9. the cluster: the system's main path
    cl, (vlog2, clog2) = _drive(lambda: drive_cluster("cuda", CLUSTER_N, CLUSTER_CLIENTS, CLUSTER_WRITES),
                                "cluster", res)
    for n in sorted({n for n, _, _ in clog2} - set(ccheck)):
        ccheck[n] = _check_comb_at(n, table25, table15, lanes, big_lanes, cprep[6], cwant)
    for n in sorted({n for n, _, _ in vlog2} - set(checked)):
        checked[n] = check_kernel_vs_plain([t[:n] for t in big_t], big[6][:n], flat_want[:n])
    cl["comb_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in clog2})
    cl["verify_lane_counts_checked_vs_plain"] = sorted({n for n, _, _ in vlog2})
    print(f"[cluster] comb kernel equals plain at lane counts {cl['comb_lane_counts_checked_vs_plain']}, "
          f"general kernel at {cl['verify_lane_counts_checked_vs_plain']}", flush=True)
    problems = []
    if cl["comb_launches"] <= 0 or cl["routing"]["comb_items"] <= 0:
        problems.append(f"the comb kernel carried nothing: {cl['comb_launches']} launches, {cl['routing']}")
    for key in ("fallback_batches", "crossover_batches"):
        if cl[key]:
            problems.append(f"cluster: {key} = {cl[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    res["kernels"] = [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/verify.cu",
        "replaces": "mochi_tpu/crypto/pallas_verify.py:132",
        "launches": svc["verify_launches"],
        "max_abs_err": max([max_abs_err, *checked.values()]),
        "ms": ms_8k,
        "plain_ms": plain_ms,
        "bound_ms": bound(len(items)),
        "bound_by": "operations",
        "library_ms": None,
    }, {
        "name": "comb_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/comb.cu",
        "replaces": "mochi_tpu/crypto/comb.py:512",
        "launches": cl["comb_launches"],
        "max_abs_err": max(ccheck.values()),
        "ms": c8k,
        "plain_ms": cplain,
        "bound_ms": cbound(len(citems)),
        "bound_by": res["comb_times"]["bound_by"],
        "library_ms": None,
    }]
    return res


def _check_comb_at(n, table25, table15, lanes, big_lanes, pre_ok, want) -> int:
    """The comb kernel against its plain version at ``n`` lanes of the comb
    corpus (tiled past its length)."""
    src = lanes if n <= lanes[0].shape[0] else big_lanes
    reps = -(-n // len(want))
    return check_comb_vs_plain(table25, table15, [t[:n] for t in src], np.tile(pre_ok, reps)[:n],
                               (list(want) * reps)[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result as JSON here")
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
    print(json.dumps({"kernels": res["kernels"]}))
    print(res["device"]["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": res["device"]["name"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
