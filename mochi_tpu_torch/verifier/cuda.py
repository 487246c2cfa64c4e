"""CUDA-backed batch verifier: ``CudaBatchVerifier``.

Composition of two halves built elsewhere:

* :class:`mochi_tpu_torch.verifier.spi.BatchingVerifier` — async
  micro-batching;
* :class:`mochi_tpu_torch.crypto.batch_verify.TorchBatchBackend` — host
  prepare plus the hand-written CUDA kernels on ``device``: the comb kernel
  for registered signers (the cluster's replica identities), the general
  verify kernel for every other key.

``device="cuda"`` is the default.  ``device="cpu"`` runs the kernels' plain
PyTorch versions (the tests use it), with the SPI's counted CPU fallback
behind them.  Nothing carries on quietly on the CPU when the card or a kernel
is missing: asking for the card where there is none raises, and on the card
a kernel's build or launch failure raises to the callers of its batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..crypto.batch_verify import MAX_LAUNCH, TorchBatchBackend
from .spi import BatchingVerifier, SignatureVerifier


class CudaBatchVerifier(BatchingVerifier):
    """BatchingVerifier over the CUDA kernels.

    ``max_batch``/``max_delay_s`` are the batching discipline: ship partial
    batches on a timer so latency stays bounded at low load while large
    batches amortise launches at high load.  ``max_batch`` defaults to the
    backend's launch size (``batch_verify.MAX_LAUNCH``, the reference's
    8192 until the card's own is chosen, ROADMAP.md).  ``signers`` (and
    later ``register_signers`` calls) register known signers with the
    backend first, whose comb kernel then carries their signatures, and
    then through the SPI's walk (on the CPU, the fallback's host tables).
    Construction builds both kernels and uploads the signers' comb table.
    On a CUDA device there is no fallback: a failed batch raises.
    """

    def __init__(
        self,
        device="cuda",
        max_batch: int = MAX_LAUNCH,
        max_delay_s: float = 0.002,
        min_device_items: Optional[int] = None,
        max_inflight: int = 4,
        signers: Sequence[bytes] = (),
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBatchVerifier: no CUDA device is available; pass "
                "device='cpu' to run the plain version on the host"
            )
        backend = TorchBatchBackend(device=device, min_device_items=min_device_items)
        super().__init__(
            backend=backend,
            max_batch=max_batch,
            max_delay_s=max_delay_s,
            max_inflight=max_inflight,
        )
        if device.type == "cuda":
            self.fallback = None  # fail closed: see the module docstring
        if signers:
            self.register_signers(signers)
        backend.warmup()

    def register_signers(self, pubs: Sequence[bytes]) -> bool:
        """Backend first (its comb registry), then the SPI walk, which also
        reaches the CPU fallback where there is one; the walk's second visit
        to the backend is an idempotent no-op."""
        self.backend.register_signers(pubs)
        SignatureVerifier.register_signers(self, pubs)
        return True
