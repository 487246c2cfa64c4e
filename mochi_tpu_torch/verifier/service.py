"""Verifier RPC service: one process owns the card, the cluster shares it.

A real cluster is N separate replica processes, and a GPU is best owned by
one process: replicas buffer signature checks and ship them here, and the
service answers each request with a validity bitmap.  Requests from many
replicas coalesce in the batcher, so the cluster-wide signature stream forms
device-sized batches even when each replica's own traffic is thin.

Server: :class:`VerifierService` — an ``RpcServer`` (the length-prefixed
transport the replicas speak, ``net/transport.py``) in front of a
:class:`~mochi_tpu_torch.verifier.spi.BatchingVerifier` over the CUDA kernels
(:class:`~mochi_tpu_torch.verifier.cuda.CudaBatchVerifier`: the comb kernel
for the known signers of ``--signers-file``, the general kernel for the
rest).

Client: :class:`RemoteVerifier` — a ``SignatureVerifier`` that ships batches
to the service and falls back to local CPU verification if the service is
unreachable (availability degrades; safety — never skip a check — holds).

Trust model: the verify RPC carries VERDICTS — a forged response saying
"all valid" would admit forged grants — so the channel must be
authenticated.  Two supported postures: (1) loopback-only (the default
bind; the OS is the trust boundary), or (2) a shared secret
(``--secret-file`` / ``secret=``): both directions MAC every envelope with
HMAC-SHA256 over the canonical envelope bytes.  A service with a secret
rejects unMAC'd requests; a client with a secret rejects unMAC'd responses
(falling back to LOCAL CPU verification, never to trusting the network).

Run:  ``python -m mochi_tpu_torch.verifier.service --port 18200 [--secret-file f]``
(on the card; ``--backend cuda-sharded`` splits every batch over all the
visible cards; ``--backend cpu`` verifies on the host instead).
``--admin-port`` serves :meth:`VerifierService.status` as JSON over loopback
HTTP (``/status``; ``/metrics.prom`` the same counters as Prometheus samples).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
from pathlib import Path
from typing import List, Optional, Sequence

from ..admin.http import HttpJsonServer
from ..cluster.config import ServerInfo
from ..crypto import session as session_crypto
from ..net.transport import RpcServer, _Connection, new_msg_id
from ..protocol import (
    Envelope,
    FailType,
    RequestFailedFromServer,
    VerifyBitmapFromServer,
    VerifyRequestToServer,
)
from .spi import (
    CachingVerifier,
    CpuVerifier,
    SignatureVerifier,
    VerifyItem,
    verifier_stats,
)

LOG = logging.getLogger(__name__)

SERVICE_ID = "verifier-service"


def _seal(env: Envelope, secret: Optional[bytes]) -> Envelope:
    """Attach the shared-secret MAC (no-op without a secret) — the single
    place the sealing scheme lives for requests, responses and failures."""
    if secret is None:
        return env
    return session_crypto.seal(env, secret)


def load_secret(path: str) -> bytes:
    """Load a hex shared secret; refuse degenerate keys (an empty file would
    silently 'authenticate' with HMAC key b'' that anyone can compute)."""
    secret = bytes.fromhex(Path(path).read_text().strip())
    if len(secret) < 16:
        raise SystemExit(
            f"verifier secret in {path} is {len(secret)} bytes; need >= 16"
        )
    return secret


class VerifierService:
    """Device-owning verification service shared by all replica processes."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 18200,
        verifier: Optional[SignatureVerifier] = None,
        max_items_per_request: int = 65536,
        cache: bool = True,
        secret: Optional[bytes] = None,
    ):
        self.secret = secret
        if verifier is None:
            from .cuda import CudaBatchVerifier

            verifier = CudaBatchVerifier()
        if cache:
            # Every replica of a set re-checks the same certificate grants;
            # the service-level memo collapses those rf duplicates into one
            # device verification (CachingVerifier docstring).
            verifier = CachingVerifier(verifier)
        self.verifier = verifier
        self.max_items_per_request = max_items_per_request
        self.rpc = RpcServer(host, port, self._handle)
        self.requests = 0
        self.items = 0

    async def start(self) -> None:
        await self.rpc.start()

    async def close(self) -> None:
        await self.rpc.close()
        await self.verifier.close()

    @property
    def bound_port(self) -> int:
        return self.rpc.bound_port

    def status(self) -> dict:
        """Operational counters for the one process that owns the device
        (served over HTTP via ``--admin-port``; the replica-side analog is
        the admin shell's ``/metrics``)."""
        return {
            "service_id": SERVICE_ID,
            "requests": self.requests,
            "items": self.items,
            "authenticated": self.secret is not None,
            "verifier": verifier_stats(self.verifier),
        }

    async def _handle(self, env: Envelope) -> Optional[Envelope]:
        def fail(ft: FailType, detail: str) -> Envelope:
            # Fail FAST with a typed error — a silent drop would park the
            # requesting replica for its full RPC timeout.  Sealed like the
            # success path so a secret-holding client sees the real reason
            # instead of misreporting it as a response-MAC failure.
            return _seal(
                Envelope(
                    RequestFailedFromServer(ft, detail),
                    msg_id=new_msg_id(),
                    sender_id=SERVICE_ID,
                    reply_to=env.msg_id,
                ),
                self.secret,
            )

        if not isinstance(env.payload, VerifyRequestToServer):
            return fail(FailType.BAD_REQUEST, "expected VerifyRequestToServer")
        if self.secret is not None and not (
            env.mac is not None
            and session_crypto.mac_ok(self.secret, env.signing_bytes(), env.mac)
        ):
            return fail(FailType.BAD_SIGNATURE, "verify request MAC missing/invalid")
        items = env.payload.items
        if len(items) > self.max_items_per_request:
            return fail(
                FailType.BAD_REQUEST,
                f"{len(items)} items > limit {self.max_items_per_request}",
            )
        bitmap = await self.verifier.verify_batch(
            [VerifyItem(pk, msg, sig) for pk, msg, sig in items]
        )
        self.requests += 1
        self.items += len(items)
        return _seal(
            Envelope(
                VerifyBitmapFromServer(tuple(bitmap)),
                msg_id=new_msg_id(),
                sender_id=SERVICE_ID,
                reply_to=env.msg_id,
            ),
            self.secret,
        )


class RemoteVerifier(SignatureVerifier):
    """Ship verification batches to a :class:`VerifierService`.

    The replica keeps its own micro-batching upstream (``BatchingVerifier``
    can wrap this), but even bare it benefits from the service-side batcher
    coalescing traffic across the whole cluster.  On transport failure the
    batch is re-verified locally (CPU) — never skipped.
    """

    # client-side request cap, kept under the service default so one request
    # can never trip the service's oversize rejection
    MAX_REQUEST_ITEMS = 16384

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 30.0,
        fallback: Optional[SignatureVerifier] = None,
        secret: Optional[bytes] = None,
    ):
        self._conn = _Connection(ServerInfo("verifier", host, port))
        self.timeout_s = timeout_s
        self.fallback = fallback if fallback is not None else CpuVerifier()
        self.secret = secret
        self.remote_batches = 0
        self.fallback_batches = 0

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        if not items:
            return []
        if len(items) > self.MAX_REQUEST_ITEMS:
            out: List[bool] = []
            for i in range(0, len(items), self.MAX_REQUEST_ITEMS):
                out.extend(await self.verify_batch(items[i : i + self.MAX_REQUEST_ITEMS]))
            return out
        req = Envelope(
            VerifyRequestToServer(
                tuple((it.public_key, it.message, it.signature) for it in items)
            ),
            msg_id=new_msg_id(),
            sender_id="verifier-client",
        )
        req = _seal(req, self.secret)
        try:
            resp = await self._conn.send_and_receive(req, self.timeout_s)
            if self.secret is not None and not (
                resp.mac is not None
                and session_crypto.mac_ok(self.secret, resp.signing_bytes(), resp.mac)
            ):
                # forged/unauthenticated verdicts NEVER pass through — the
                # fallback below re-verifies locally instead
                raise ValueError("verifier response MAC missing/invalid")
            payload = resp.payload
            if (
                not isinstance(payload, VerifyBitmapFromServer)
                or len(payload.bitmap) != len(items)
            ):
                raise ValueError("malformed verifier response")
            self.remote_batches += 1
            return [bool(b) for b in payload.bitmap]
        except asyncio.CancelledError:
            raise
        except Exception:
            LOG.exception("remote verify failed; falling back to CPU")
            self.fallback_batches += 1
            return await self.fallback.verify_batch(items)

    async def close(self) -> None:
        await self._conn.close()
        await self.fallback.close()


def warmup_sizes(spec: str) -> tuple:
    """``--warmup``'s comma-separated lane counts -> a tuple of ints."""
    return tuple(int(b) for b in spec.split(",") if b.strip())


def load_signers(path: str) -> List[bytes]:
    """Parse a signers file: one hex Ed25519 pubkey per line (# comments)."""
    out: List[bytes] = []
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            out.append(bytes.fromhex(line))
    return out


async def amain(args) -> None:
    signers: List[bytes] = (
        load_signers(args.signers_file) if args.signers_file else []
    )
    verifier: SignatureVerifier
    if args.backend == "cpu":
        verifier = CpuVerifier()
        if signers:
            verifier.register_signers(signers)
    elif args.backend == "cuda-sharded":
        from .cuda import ShardedCudaBatchVerifier

        t0 = time.time()
        verifier = ShardedCudaBatchVerifier(signers=signers, warmup_buckets=warmup_sizes(args.warmup))
        LOG.info(
            "sharded verifier over %d devices (warmup %.1fs, %d known signers)",
            verifier.backend.n_devices,
            time.time() - t0,
            len(signers),
        )
    else:
        from ..crypto.comb import COMB_IMPL
        from ..crypto.cuda_comb import multiply_of
        from ..crypto.cuda_verify import skew
        from .cuda import CudaBatchVerifier

        t0 = time.time()
        verifier = CudaBatchVerifier(device="cuda", signers=signers, warmup_buckets=warmup_sizes(args.warmup))
        LOG.info(
            "CUDA kernels ready in %.1fs, warmed at %s lanes (general kernel: %s multiply; %d known "
            "signers on the comb kernel, %s accumulation, %s multiply)",
            time.time() - t0,
            args.warmup,
            skew(),
            len(signers),
            COMB_IMPL,
            multiply_of(COMB_IMPL),
        )
    secret = None
    if args.secret_file:
        secret = load_secret(args.secret_file)
    service = VerifierService(
        host=args.host, port=args.port, verifier=verifier, secret=secret
    )
    await service.start()
    admin = None
    if args.admin_port is not None:
        admin = ServiceAdminServer(service, port=args.admin_port)
        await admin.start()
    print(f"READY {SERVICE_ID} {service.bound_port}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        if admin is not None:
            await admin.close()
        await service.close()


class ServiceAdminServer(HttpJsonServer):
    """Loopback HTTP status endpoint for the standalone service: /status
    (and /) serve :meth:`VerifierService.status` as JSON.  Reuses the
    admin shell's hardened transport loop (read timeouts, header drain)."""

    def __init__(self, service: VerifierService, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self.service = service

    def _route(self, path: str):
        import json as _json

        if path in ("/", "/status", "/metrics"):
            return 200, "application/json", _json.dumps(self.service.status())
        if path == "/metrics.prom":
            # Flatten the status counters into Prometheus samples (numeric
            # leaves only), same exposition family as the replica shell.
            def walk(prefix, obj, out):
                for k, v in obj.items():
                    key = f"{prefix}_{k}" if prefix else str(k)
                    if isinstance(v, dict):
                        walk(key, v, out)
                    elif isinstance(v, bool):
                        out.append((key, int(v)))
                    elif isinstance(v, (int, float)):
                        out.append((key, v))

            samples: list = []
            walk("", self.service.status(), samples)
            body = "".join(
                f'mochi_verifier_service{{name="{k}"}} {v}\n' for k, v in samples
            )
            return 200, "text/plain; version=0.0.4", body
        return 404, "application/json", '{"error": "not found"}'


def build_parser() -> argparse.ArgumentParser:
    """The service's command line."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=18200)
    parser.add_argument(
        "--backend",
        choices=("cuda", "cuda-sharded", "cpu"),
        default="cuda",
        help="cuda: the CUDA kernels on one card (the default; fails "
        "when no card is present); cuda-sharded: each batch split over "
        "every visible card (fails likewise); cpu: host verification per item",
    )
    parser.add_argument(
        "--warmup",
        default="16,256",
        help="comma-separated lane counts at which each kernel is launched once before READY "
        "(the cuda backends)",
    )
    parser.add_argument(
        "--secret-file",
        default=None,
        help="hex shared secret: MAC-authenticate the verify RPC in both "
        "directions (required when the service is not loopback-only)",
    )
    parser.add_argument(
        "--signers-file",
        default=None,
        help="file of hex Ed25519 pubkeys (one per line, # comments ok): "
        "known signers, usually the cluster's replica identities; their "
        "signatures take the comb kernel (every other key the general "
        "kernel)",
    )
    parser.add_argument(
        "--admin-port",
        type=int,
        default=None,
        help="serve service counters as JSON over loopback HTTP (0 = ephemeral)",
    )
    parser.add_argument("--log-level", default="INFO")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..utils.runtime import tune_gc_for_server

    tune_gc_for_server()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
