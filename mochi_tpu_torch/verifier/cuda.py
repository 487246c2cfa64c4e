"""CUDA-backed batch verifiers: ``CudaBatchVerifier`` on one card and
``ShardedCudaBatchVerifier`` over several.

Composition of two halves built elsewhere:

* :class:`mochi_tpu_torch.verifier.spi.BatchingVerifier` — async
  micro-batching;
* a backend: :class:`mochi_tpu_torch.crypto.batch_verify.TorchBatchBackend`
  (host prepare plus the hand-written CUDA kernels on ``device``: the comb
  kernel for registered signers, the cluster's replica identities, and the
  general verify kernel for every other key), or
  :class:`ShardedCudaBatchBackend`, which splits each batch over a mesh of
  cards (``parallel/sharded.py``).

``device="cuda"`` (or every visible card, for the sharded verifier) is the
default.  ``device="cpu"`` (``devices=["cpu", ...]``) runs the kernels'
plain PyTorch versions (the tests use it), with the SPI's counted CPU
fallback behind them.  Nothing carries on quietly on the CPU when the card
or a kernel is missing: asking for the card where there is none raises, and
on the card a kernel's build or launch failure raises to the callers of its
batch.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..crypto import batch_verify as BV
from ..crypto import cuda_comb
from ..crypto.batch_verify import MAX_LAUNCH, TorchBatchBackend
from ..parallel.sharded import Mesh, make_mesh, verify_prepared
from .spi import BatchingVerifier, SignatureVerifier, VerifyItem


class CudaBatchVerifier(BatchingVerifier):
    """BatchingVerifier over the CUDA kernels.

    ``max_batch``/``max_delay_s`` are the batching discipline: ship partial
    batches on a timer so latency stays bounded at low load while large
    batches amortise launches at high load.  ``max_batch`` defaults to the
    backend's launch size (``batch_verify.MAX_LAUNCH``: ``MOCHI_MAX_BUCKET``,
    the reference's 8192 by default until the card's own is chosen,
    ROADMAP.md).  ``signers`` (and
    later ``register_signers`` calls) register known signers with the
    backend first, whose comb kernel then carries their signatures, and
    then through the SPI's walk (on the CPU, the fallback's host tables).
    Construction builds the kernels and uploads the signers' comb table,
    then launches each kernel of the live path once at each size of
    ``warmup_buckets`` (the reference's ``warmup_buckets``: the server
    passes ``(16,)``, the service ``--warmup``), so the first request pays
    no first launch; a build or launch error there raises.  On a CUDA
    device there is no fallback: a failed batch raises.
    """

    def __init__(
        self,
        device="cuda",
        max_batch: int = MAX_LAUNCH,
        max_delay_s: float = 0.002,
        min_device_items: Optional[int] = None,
        max_inflight: int = 4,
        signers: Sequence[bytes] = (),
        warmup_buckets: Sequence[int] = (),
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBatchVerifier: no CUDA device is available; pass "
                "device='cpu' to run the plain version on the host"
            )
        backend = TorchBatchBackend(device=device, min_device_items=min_device_items)
        self._start(backend, max_batch, max_delay_s, max_inflight, signers, warmup_buckets)

    def _start(self, backend, max_batch, max_delay_s, max_inflight, signers, warmup_buckets) -> None:
        super().__init__(
            backend=backend,
            max_batch=max_batch,
            max_delay_s=max_delay_s,
            max_inflight=max_inflight,
        )
        if backend.device.type == "cuda":
            self.fallback = None  # fail closed: see the module docstring
        if signers:
            self.register_signers(signers)
        self.warmup_buckets = tuple(warmup_buckets)
        t0 = time.perf_counter()
        backend.warmup(self.warmup_buckets)
        self.warmup_s = time.perf_counter() - t0

    def register_signers(self, pubs: Sequence[bytes]) -> bool:
        """Backend first (its comb registry), then the SPI walk, which also
        reaches the CPU fallback where there is one; the walk's second visit
        to the backend is an idempotent no-op."""
        self.backend.register_signers(pubs)
        SignatureVerifier.register_signers(self, pubs)
        return True


class ShardedCudaBatchBackend(TorchBatchBackend):
    """``TorchBatchBackend`` whose device path splits each batch over a mesh.

    Counterpart of the reference's ``ShardedJaxBatchBackend``: every slice
    of a batch runs on its own device (``parallel/sharded.py``: one launch
    per slice, each on its own stream, all launched before any is read
    back), the comb table replicated to every device.  The slices are as
    even as they go; unlike the reference's static shapes, no padding.
    Verification needs no collective; the cluster's quorum tally happens at
    the replicas.  It keeps the reference's semantics:

    * comb routing is all-or-nothing per batch: a batch with any key not
      registered below the pinned generation runs the general kernel whole,
      and the router's counts say so;
    * a batch whose prechecks reject every item does no device work and is
      not counted as a dispatch (nor is any such slice: each slice that
      launches counts as one dispatch);
    * the verdicts are the device bitmap ANDed with the prechecks.

    The CPU crossover (``min_device_items``) is the base class's.
    """

    def __init__(self, mesh: Mesh, min_device_items: Optional[int] = None):
        self.mesh = mesh
        super().__init__(device=self.mesh.devices[0], min_device_items=min_device_items)

    @property
    def n_devices(self) -> int:
        """Slices of each batch (devices of the mesh, counted with repeats)."""
        return self.mesh.size

    def warmup(self, batch_sizes: Sequence[int] = ()) -> None:
        """Build and load the kernels, upload the registered signers' comb
        table to every device of the mesh, in the layout of the switches in
        effect, and launch each kernel once at each of ``batch_sizes`` on
        every device of the mesh."""
        super().warmup()
        if self.device.type == "cuda" and len(self.registry):
            switches = cuda_comb.switches()
            for dev in dict.fromkeys(self.mesh.devices):
                self.registry.device_table(dev, layout=cuda_comb.table_layout(dev, *switches))
        for dev in dict.fromkeys(self.mesh.devices):
            self._warm_launches(dev, batch_sizes)

    def _verify(self, items: Sequence[VerifyItem]) -> List[bool]:
        n = len(items)
        if not n:
            return []
        registry = self.registry
        use_comb = bool(len(registry)) and BV.comb_enabled()
        key_idx = gen = None
        if use_comb:
            gen = registry.generation  # pinned: later registrations wait for the next batch
            idxs = [registry.index_of(it.public_key) for it in items]
            if any(k is None or k >= gen for k in idxs):
                use_comb = False
            else:
                key_idx = np.asarray(idxs, dtype=np.int32)
            BV._note_routing(n if use_comb else 0, 0 if use_comb else n)
        return verify_prepared(self.mesh, BV.prepare_packed(items), key_idx, registry, gen).tolist()


class ShardedCudaBatchVerifier(CudaBatchVerifier):
    """BatchingVerifier over :class:`ShardedCudaBatchBackend`.

    The mesh is every visible card by default, ``devices=`` chooses (a
    device may repeat: two slices on one card), and ``devices=["cpu", ...]``
    runs the plain versions on the host.  ``max_batch`` defaults to
    ``MAX_LAUNCH`` lanes per slice, so each card gets the single-card
    verifier's launch.  ``warmup_buckets`` warms every device of the mesh.
    """

    def __init__(
        self,
        devices: Optional[Sequence] = None,
        max_batch: Optional[int] = None,
        max_delay_s: float = 0.002,
        min_device_items: Optional[int] = None,
        max_inflight: int = 4,
        signers: Sequence[bytes] = (),
        warmup_buckets: Sequence[int] = (),
    ):
        mesh = make_mesh(devices)
        backend = ShardedCudaBatchBackend(mesh, min_device_items=min_device_items)
        self._start(backend, MAX_LAUNCH * mesh.size if max_batch is None else max_batch,
                    max_delay_s, max_inflight, signers, warmup_buckets)
