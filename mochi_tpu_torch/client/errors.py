"""Client-visible outcome taxonomy (ref: ``client/*Exception.java``)."""


class MochiClientError(Exception):
    """Base class for client-visible transaction failures."""


class InconsistentRead(MochiClientError):
    """No 2f+1 agreeing read responses (ref: ``InconsistentReadException``).

    ``responders``: how many in-set replicas answered the failing op —
    the client's recovery path only attempts a nudge-resync when a quorum
    RESPONDED but disagreed (a recoverable split); with fewer responders
    the set is simply down and retries would only amplify outage load.
    """

    def __init__(self, msg: str, responders: int = 0):
        super().__init__(msg)
        self.responders = responders


class InconsistentWrite(MochiClientError):
    """No 2f+1 agreeing Write2 acks (ref: ``InconsistentWriteException``).

    ``bad_certificate``: replicas rejected the certificate itself
    (BAD_CERTIFICATE answers in the tally) — retryable with fresh grants,
    e.g. a Byzantine in-set grant poisoned this attempt's certificate; the
    write loop burns a refusal-retry instead of surfacing the failure.
    """

    def __init__(self, msg: str, bad_certificate: bool = False):
        super().__init__(msg)
        self.bad_certificate = bad_certificate


class RequestFailed(MochiClientError):
    """Server reported a typed failure (ref: ``RequestFailedException``)."""


class RequestRefused(MochiClientError):
    """Write1 grant refused after retries (ref: ``RequestRefusedException``)."""
