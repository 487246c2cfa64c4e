"""mochi-tpu on PyTorch and CUDA: the port of the quorum-BFT KV store's
device data plane to an NVIDIA H100.

The package mirrors ``mochi_tpu``'s layout module for module and imports
nothing of it.  Ported so far:

- ``crypto/``    — GF(2^255-19) and Ed25519 on tensors (the plain version of
  the verify kernel), the hand-written CUDA verify kernel's wrapper
  (``crypto/cuda_verify.py``, sources in ``csrc/``), host prepare and the
  batch backend, host sign/verify, session keys.
- ``verifier/``  — the ``SignatureVerifier`` SPI, ``CudaBatchVerifier`` and
  the verifier service (``python -m mochi_tpu_torch.verifier.service``).
- ``protocol/``, ``net/``, ``cluster/``, ``obs/``, ``utils/`` — the wire and
  host layers the service stands on.

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
