#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mochi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed N] [--out F]``

Phases (any failure exits non-zero and prints no result line):

1. Device — the card's name, ``nvidia-smi`` name and power limit, compute
   capability, SM count and maximum SM clock.  No CUDA device: exit 2.
2. Build — compile the kernel ``mochi_tpu_torch/csrc/verify.cu`` and
   report registers per thread.
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

The last three lines of standard output are the kernel table (JSON), the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.

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


async def drive_service(traffic, device: str, secret: Optional[bytes], timeout_s: float = 300.0) -> dict:
    """Boot the verifier service on loopback and drive it from one
    RemoteVerifier per client, concurrently.  Returns counts and times."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.service import RemoteVerifier, VerifierService

    verifier = CudaBatchVerifier(device=device)
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


def run(args) -> dict:
    import torch

    from mochi_tpu_torch import kernels
    from mochi_tpu_torch.crypto import batch_verify as BV
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
    }
    print(f"[device] {res['device']}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    kernels.load("verify")
    res["build_s"] = time.perf_counter() - t0
    attrs = CV.kernel_attributes()
    res["kernel_attributes"] = attrs
    ptxas = [ln.strip() for ln in kernels.build_logs.get("verify", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {res['build_s']:.1f} s; {attrs}", flush=True)
    for ln in ptxas:
        print(f"[build] ptxas: {ln}", flush=True)

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
    rate = IMAD_PER_SM_PER_CLOCK * props.multi_processor_count * clk_mhz * 1e6
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

    # 5. service: the main path, counts zeroed just before and read just after
    secret = hashlib.sha256(b"chip smoke %d" % args.seed).digest()
    ref0, ref1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    CV.launches = 0
    BV.reset_counts()
    CV.launch_log = []
    ref0.record()
    svc = asyncio.run(drive_service(traffic, "cuda", secret))
    svc["kernel_launches"] = CV.launches
    svc["device_items"] = BV.device_item_count()
    svc["device_dispatches"] = BV.device_dispatch_count()
    launch_log, CV.launch_log = CV.launch_log, None
    torch.cuda.synchronize()
    ref1.record()
    ref1.synchronize()
    svc["launches_per_request"] = svc["kernel_launches"] / svc["requests"]
    svc["device"] = device_busy(launch_log, ref0, ref1)
    res["service"] = svc
    print(f"[service] {svc}", flush=True)
    # kernel vs plain at every lane count the service launched
    for n in sorted({n for n, _, _ in launch_log} - set(checked)):
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
            problems.append(f"{key} = {svc[key]}")
    if problems:
        raise AssertionError("; ".join(problems))

    res["kernels"] = [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "mochi_tpu_torch/csrc/verify.cu",
        "replaces": "mochi_tpu/crypto/pallas_verify.py:132",
        "launches": svc["kernel_launches"],
        "max_abs_err": max_abs_err,
        "ms": ms_8k,
        "plain_ms": plain_ms,
        "bound_ms": bound(len(items)),
        "bound_by": "operations",
        "library_ms": None,
    }]
    return res


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
