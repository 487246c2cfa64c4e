"""CUDA-backed batch verifier: ``CudaBatchVerifier``.

Composition of two halves built elsewhere:

* :class:`mochi_tpu_torch.verifier.spi.BatchingVerifier` — async
  micro-batching with a CPU fallback (never skips verification on device
  failure, counts ``fallback_batches``);
* :class:`mochi_tpu_torch.crypto.batch_verify.TorchBatchBackend` — host
  prepare plus the hand-written CUDA verify kernel on ``device``.

``device="cuda"`` is the default.  ``device="cpu"`` runs the kernel's plain
PyTorch version (the tests use it).  Asking for the card where there is none
raises; nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..crypto.batch_verify import MAX_LAUNCH, TorchBatchBackend
from .spi import BatchingVerifier, SignatureVerifier


class CudaBatchVerifier(BatchingVerifier):
    """BatchingVerifier over the CUDA verify kernel.

    ``max_batch``/``max_delay_s`` are the batching discipline: ship partial
    batches on a timer so latency stays bounded at low load while large
    batches amortise launches at high load.  ``max_batch`` defaults to the
    backend's launch size (``batch_verify.MAX_LAUNCH``, the reference's
    8192 until the card's own is chosen, ROADMAP.md).  ``signers`` (and later ``register_signers`` calls, the
    SPI's walk) reach the backend, which records them for the comb path to
    come, and the CPU fallback; all traffic takes the general kernel.
    """

    def __init__(
        self,
        device="cuda",
        max_batch: int = MAX_LAUNCH,
        max_delay_s: float = 0.002,
        fallback: Optional[SignatureVerifier] = None,
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
            fallback=fallback,
            max_inflight=max_inflight,
        )
        if signers:
            self.register_signers(signers)
        backend.warmup()
