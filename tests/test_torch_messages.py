"""Message schema round-trips, envelope encoding, transaction hashing.

Mirrors the reference's hash tests (``UtilsTest.java:11-33``: identical
transactions hash equal, different ones differ).
"""

from mochi_tpu_torch.protocol import (
    Action,
    Envelope,
    FailType,
    Grant,
    HelloFromServer,
    HelloToServer,
    MultiGrant,
    Operation,
    OperationResult,
    ReadFromServer,
    ReadToServer,
    RequestFailedFromServer,
    Status,
    Transaction,
    TransactionResult,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    decode_envelope,
    encode_envelope,
    transaction_hash,
)


def sample_txn() -> Transaction:
    return Transaction(
        (
            Operation(Action.WRITE, "k1", b"v1"),
            Operation(Action.READ, "k2"),
            Operation(Action.DELETE, "k3"),
        )
    )


def sample_multigrant(signed: bool = False) -> MultiGrant:
    txh = transaction_hash(sample_txn())
    mg = MultiGrant(
        grants={
            "k1": Grant("k1", 1042, 1, txh, Status.OK),
            "k3": Grant("k3", 1042, 1, txh, Status.OK),
        },
        client_id="client-abc",
        server_id="server-1",
    )
    if signed:
        mg = mg.with_signature(b"\x01" * 64)
    return mg


def sample_certificate() -> WriteCertificate:
    return WriteCertificate(
        {f"server-{i}": sample_multigrant(signed=True) for i in range(3)}
    )


PAYLOADS = [
    ReadToServer("client-1", sample_txn(), "nonce-1"),
    ReadFromServer(
        TransactionResult(
            (
                OperationResult(b"v", sample_certificate(), True, Status.OK),
                OperationResult(None, None, False, Status.WRONG_SHARD),
            )
        ),
        "nonce-1",
        "rid-1",
    ),
    Write1ToServer("client-1", sample_txn(), 517, transaction_hash(sample_txn())),
    Write1OkFromServer(sample_multigrant(signed=True), {"k1": sample_certificate()}),
    Write1RefusedFromServer(sample_multigrant(), {"k1": sample_certificate()}, "client-1"),
    Write2ToServer(sample_certificate(), sample_txn()),
    Write2AnsFromServer(TransactionResult((OperationResult(b"v"),)), "rid-2"),
    RequestFailedFromServer(FailType.BAD_SIGNATURE, "forged"),
    HelloToServer("hi"),
    HelloFromServer("hi back"),
]


def test_envelope_roundtrip_all_payload_types():
    for payload in PAYLOADS:
        env = Envelope(
            payload,
            msg_id="msg-123",
            sender_id="client-1",
            reply_to="msg-122",
            timestamp_ms=1712345678901,
            signature=b"\x02" * 64,
        )
        decoded = decode_envelope(encode_envelope(env))
        assert decoded == env, type(payload).__name__


def test_transaction_hash_stable_and_distinct():
    t1, t2 = sample_txn(), sample_txn()
    assert transaction_hash(t1) == transaction_hash(t2)
    assert len(transaction_hash(t1)) == 64
    t3 = Transaction((Operation(Action.WRITE, "k1", b"DIFFERENT"),))
    assert transaction_hash(t1) != transaction_hash(t3)


def test_signing_bytes_exclude_signature():
    mg = sample_multigrant()
    assert mg.signing_bytes() == mg.with_signature(b"\x05" * 64).signing_bytes()
    env = Envelope(HelloToServer(), "m1", "s1")
    assert env.signing_bytes() == env.with_signature(b"\x06" * 64).signing_bytes()


def test_signing_bytes_cover_content():
    mg = sample_multigrant()
    mutated = MultiGrant(
        grants={**mg.grants, "k9": Grant("k9", 7, 1, b"\x00" * 64, Status.OK)},
        client_id=mg.client_id,
        server_id=mg.server_id,
    )
    assert mg.signing_bytes() != mutated.signing_bytes()


def test_six_bytes_splice_is_byte_identical():
    """The payload-level mcode cache splices cached payload bytes
    between a freshly encoded tag and tail; the result must be byte-equal
    to encoding the whole 6-element list in one call, for EVERY payload
    type — this is what keeps fan-out envelopes (shared payload, distinct
    msg_id/MAC) wire-compatible with peers without the cache."""
    from mochi_tpu_torch.protocol.codec import encode
    from mochi_tpu_torch.protocol.messages import _TAG_BY_TYPE

    for payload in PAYLOADS:
        env = Envelope(payload, "msg-1", "sender-1", "reply-1", 1712345678901)
        reference = encode(
            [
                _TAG_BY_TYPE[type(payload)],
                payload.to_obj(),
                env.msg_id,
                env.sender_id,
                env.reply_to,
                env.timestamp_ms,
            ]
        )
        assert env._six_bytes == reference, type(payload).__name__
        # second envelope over the SAME payload object hits the cache and
        # must produce its own correct bytes (different msg_id)
        env2 = Envelope(payload, "msg-2", "sender-1", "reply-1", 1712345678901)
        assert "_mcode" in payload.__dict__
        reference2 = reference.replace(b"msg-1", b"msg-2")
        assert env2._six_bytes == reference2, type(payload).__name__
        decoded = decode_envelope(encode_envelope(env2))
        assert decoded.payload == payload, type(payload).__name__


def test_signed_bytes_equal_the_reference():
    """Every payload type crosses to the reference package and back: the
    reference decodes the port's envelope, re-encodes it to the same
    bytes, and signs the same bytes; the port decodes the reference's."""
    from mochi_tpu.protocol import decode_envelope as ref_decode
    from mochi_tpu.protocol import encode_envelope as ref_encode

    for i, payload in enumerate(PAYLOADS):
        env = Envelope(payload, f"msg-{i}", "server-0", "msg-0", 1234 + i, b"\x07" * 64)
        data = encode_envelope(env)
        theirs = ref_decode(data)
        assert ref_encode(theirs) == data, type(payload).__name__
        assert theirs.signing_bytes() == env.signing_bytes(), type(payload).__name__
        assert decode_envelope(ref_encode(theirs)) == env
