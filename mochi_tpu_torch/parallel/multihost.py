"""Several processes, one card each: the multi-host feeder of the quorum step.

Counterpart of the reference package's ``parallel/multihost.py``.  Every
process calls :func:`init_process` (one rendezvous address, N processes,
a rank each — nothing in the environment names the cluster, so all three
are given), builds its mesh with :func:`~mochi_tpu_torch.parallel.sharded.make_mesh`
(its own card once the group exists) and feeds its own rows of each batch
to :func:`~mochi_tpu_torch.parallel.sharded.make_quorum_step`.  The only
traffic between processes is the step's ``all_reduce`` of the quorum slots:
NCCL between cards, gloo between CPU processes.

Demo, one line of JSON per process (the tests and ``chip_smoke.py`` run it):

    python -m mochi_tpu_torch.parallel.multihost --coordinator 127.0.0.1:PORT \\
        --num-processes N --process-id I [--backend nccl|gloo]

``nccl`` (the default) needs one card per process and fails without one;
``gloo`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .sharded import make_mesh, make_quorum_step


def init_process(coordinator_address: str, num_processes: int, process_id: int,
                 backend: str = "nccl") -> None:
    """Join this process to the process group (blocks until all
    ``num_processes`` have joined).  ``coordinator_address`` is host:port;
    process 0 serves the rendezvous there.  With ``nccl`` the process takes
    card ``process_id`` modulo the visible cards, one process per card."""
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process: the nccl backend needs a CUDA device; none is available")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif backend != "gloo":
        raise ValueError(f"init_process: unknown backend {backend!r} (nccl or gloo)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def host_local_to_global(mesh, arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """This process's rows of a batch, ready for the mesh's step.

    In the reference this assembles global device arrays from each
    process's rows; here every rank keeps its own rows, and the step's
    ``all_reduce`` is what joins them.  The rows must split evenly over the
    process's slices (pad with ``pad_to_multiple``)."""
    arrays = tuple(np.ascontiguousarray(a) for a in arrays)
    n = arrays[0].shape[0]
    if n % mesh.size or any(a.shape[0] != n for a in arrays):
        raise ValueError(f"rows {[a.shape[0] for a in arrays]} do not split over {mesh.size} slices")
    return arrays


def _demo_main(argv: Optional[Sequence[str]] = None) -> None:
    """One process of the multi-process proof: a deterministic mixed
    valid/invalid batch of its own, the quorum step across every process,
    and a comb leg under a signer every process registers; prints the
    summed tally as JSON.  Every process must print the same counts."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--coordinator", required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--lanes-per-process", type=int, default=8)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                        help="nccl: the CUDA kernels, one card per process (the default); "
                        "gloo: the plain versions on the CPU")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    init_process(args.coordinator, args.num_processes, args.process_id, args.backend)
    try:
        mesh = make_mesh() if args.backend == "nccl" else make_mesh(devices=["cpu"])
        assert dist.get_world_size() == args.num_processes

        from ..crypto import batch_verify, comb as comb_mod, keys
        from ..verifier.spi import VerifyItem
        from .sharded import make_sharded_verify_comb

        # Deterministic cross-process pattern without shared key material:
        # lane i of EVERY process votes for group (i % 3); lanes with
        # i % 4 == 3 carry a corrupted signature.  The expected per-group
        # count is then a closed form of (lanes_per_process, num_processes).
        lanes = args.lanes_per_process
        kp = keys.generate_keypair()
        items = []
        group_ids = np.zeros(lanes, dtype=np.int32)
        for i in range(lanes):
            msg = b"lane-%d-%d" % (args.process_id, i)
            sig = kp.sign(msg)
            if i % 4 == 3:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            items.append(VerifyItem(kp.public_key, msg, sig))
            group_ids[i] = i % 3
        prepared = batch_verify.prepare_packed(items)
        assert prepared[6].all()

        step = make_quorum_step(mesh, 3)
        rows = host_local_to_global(mesh, (*prepared, group_ids))
        bitmap, counts, committed = step(*rows, np.int32(3))

        # Comb leg: the signer set is cluster config — identical on every
        # process — so each builds the same table on its own device.
        ckp = keys.keypair_from_seed(bytes([7]) * 32)
        citems = []
        for i in range(lanes):
            msg = b"comb-lane-%d-%d" % (args.process_id, i)
            sig = ckp.sign(msg)
            if i % 4 == 3:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            citems.append(VerifyItem(ckp.public_key, msg, sig))
        reg = comb_mod.SignerRegistry(mesh.devices[0])
        if reg.register(ckp.public_key) is None:
            raise RuntimeError("registration failed")
        cprep = batch_verify.prepare_packed(citems)
        assert cprep[6].all()
        crows = host_local_to_global(mesh, (np.zeros(lanes, np.int32), *cprep[2:6]))
        comb_local = make_sharded_verify_comb(mesh)(reg, *crows).numpy()
        expect_local = np.asarray([i % 4 != 3 for i in range(lanes)])
        assert (comb_local == expect_local).all(), (comb_local, expect_local)

        print(json.dumps({
            "process_id": args.process_id,
            "process_count": dist.get_world_size(),
            "backend": dist.get_backend(),
            "local_devices": mesh.size,
            "global_devices": mesh.size * dist.get_world_size(),
            "device": str(mesh.devices[0]),
            "counts": counts.tolist(),
            "committed": committed.tolist(),
            "local_valid": int(bitmap.sum()),
            "comb_local_valid": int(comb_local.sum()),
        }), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _demo_main()
