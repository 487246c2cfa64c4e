"""mochi-tpu on PyTorch and CUDA: the port of the quorum-BFT KV store to an
NVIDIA H100.

The package mirrors ``mochi_tpu``'s layout module for module and imports
nothing of it.  Ported so far:

- ``crypto/``    — GF(2^255-19) and Ed25519 on tensors (the plain versions
  of the kernels), the hand-written CUDA kernels' wrappers
  (``crypto/cuda_verify.py`` for any key, ``crypto/cuda_comb.py`` for the
  registered signers of ``crypto/comb.py``; sources in ``csrc/``), host
  prepare and the routing batch backend, host sign/verify, session keys.
- ``verifier/``  — the ``SignatureVerifier`` SPI, ``CudaBatchVerifier`` and
  the verifier service (``python -m mochi_tpu_torch.verifier.service``).
- ``server/``, ``client/``, ``storage/`` (in-memory engine), ``testing/``
  (``VirtualCluster``), ``tools/gen_cluster`` — the signed-write path
  (``python -m mochi_tpu_torch.server``).
- ``protocol/``, ``net/``, ``cluster/``, ``obs/``, ``utils/`` — the wire and
  host layers they stand on.

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
