"""Several devices: mesh construction, sharded verify and the quorum tally.

Counterpart of the reference package's ``parallel/``: a batch split over a
list of devices (CUDA kernels per card, plain versions on the CPU), and the
2f+1 tally summed across cards and across processes with
``torch.distributed`` (NCCL on cards, gloo on the CPU).
"""

from .sharded import (  # noqa: F401
    make_mesh,
    make_quorum_step,
    make_sharded_verify,
    pad_to_multiple,
)
