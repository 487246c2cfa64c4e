"""Carry protocol payloads between the port and the reference package
through their wire format, for the differential tests of the port's host
layers: a payload of either package is encoded in a fixed envelope by its
own codec and decoded by the other's."""

from mochi_tpu import protocol as ref_protocol
from mochi_tpu_torch import protocol


def wire(payload) -> bytes:
    """The port's encoding of ``payload`` in a fixed envelope."""
    return protocol.encode_envelope(protocol.Envelope(payload, "m", "s"))


def ref_wire(payload) -> bytes:
    """The reference's encoding of one of its payloads in the same envelope."""
    return ref_protocol.encode_envelope(ref_protocol.Envelope(payload, "m", "s"))


def to_reference(payload):
    """The reference package's object for a payload of the port."""
    return ref_protocol.decode_envelope(wire(payload)).payload


def to_port(payload):
    """The port's object for a payload of the reference package."""
    return protocol.decode_envelope(ref_wire(payload)).payload


class PairedStores:
    """The port's DataStores and the reference's, one pair per server of
    one membership, driven with the same requests: :meth:`both` carries a
    request to the reference over the wire, runs it through every pair,
    requires the responses to encode to the same bytes (an exception to
    carry the same message), and returns the port's responses."""

    def __init__(self, n: int = 4, rf: int = 4):
        from mochi_tpu.cluster import ClusterConfig as RefConfig
        from mochi_tpu.server.store import DataStore as RefStore
        from mochi_tpu_torch.cluster import ClusterConfig
        from mochi_tpu_torch.server.store import DataStore

        servers = {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(n)}
        self.config = ClusterConfig.build(servers, rf=rf)
        ref_config = RefConfig.build(servers, rf=rf)
        self.mine = [DataStore(sid, self.config) for sid in servers]
        self.theirs = [RefStore(sid, ref_config) for sid in servers]

    def both(self, method: str, req, stores=None) -> list:
        outs = []
        for i, (a, b) in enumerate(zip(self.mine, self.theirs)):
            if stores is not None and i not in stores:
                continue
            if method == "process_read":  # a bare transaction and result: carried in read messages
                ra = protocol.ReadFromServer(a.process_read(req), "n", "r")
                rb = ref_protocol.ReadFromServer(
                    b.process_read(to_reference(protocol.ReadToServer("c", req, "n")).transaction), "n", "r")
                assert wire(ra) == ref_wire(rb)
            elif method.endswith("_batch"):
                ra = getattr(a, method)(req)
                rb = getattr(b, method)([to_reference(r) for r in req])
                assert [str(x) if isinstance(x, Exception) else wire(x) for x in ra] == [
                    str(x) if isinstance(x, Exception) else ref_wire(x) for x in rb], method
            else:
                ra, rb = getattr(a, method)(req), getattr(b, method)(to_reference(req))
                assert wire(ra) == ref_wire(rb), method
            outs.append(ra)
        return outs

    def sync_entries(self, keys=None) -> list:
        """Each store's exported sync entries: equal in both packages."""
        outs = []
        for a, b in zip(self.mine, self.theirs):
            ea = protocol.SyncEntriesFromServer(tuple(a.export_sync_entries(keys)))
            eb = ref_protocol.SyncEntriesFromServer(tuple(b.export_sync_entries(keys)))
            assert wire(ea) == ref_wire(eb)
            outs.append(ea)
        return outs
