"""The yardstick of the kernels' roofline share, frozen: the work a quorum
step needs and the card's peak rates.

Verify: the known-signer (comb) algorithm's 105,725 32-bit multiply-adds a
signature, for each lane that passes the host prechecks.  Every lane of
this traffic is signed by one of the cluster's replicas, whose keys a
verifier registers, so that is the least work the program has an algorithm
for; the general algorithm's 274,070 would count the same lane 2.59 times
over, and a step routed to the comb kernel could then read above 100%.
The same count holds whatever kernel does the work.  Rate: 64 multiply-adds
a clock an SM x 132 SMs x 1,980 MHz (NVIDIA H100 SXM, boost clock).

Tally and commit: bytes, read and written once: a lane's verdict, host
precheck and int32 slot id (6 bytes), a slot's count written and read and
its commit flag written (9 bytes), at 3.35 TB/s (H100 SXM HBM3).
"""

IMADS_PER_LANE = 105_725
IMAD_RATE = 64 * 132 * 1.98e9  # multiply-adds a second
TALLY_BYTES_PER_LANE = 6
TALLY_BYTES_PER_SLOT = 9
HBM_BYTES_PER_S = 3.35e12


def least_seconds(passing_lanes: int, lanes: int, slots: int) -> float:
    """The least time one step's kernels could take on the card."""
    verify = passing_lanes * IMADS_PER_LANE / IMAD_RATE
    tally = (TALLY_BYTES_PER_LANE * lanes + TALLY_BYTES_PER_SLOT * slots) / HBM_BYTES_PER_S
    return verify + tally
