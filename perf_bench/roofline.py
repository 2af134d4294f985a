"""Peaks of the card and the byte count of the deposit kernel, frozen
here so that a change to the program cannot move them.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB, at its full power
limit of 700 W.  A card set to a lower ``power.limit`` runs slower under
load; every result line carries the card's name and limit
(``card``), and a share of these peaks is stated beside them.

``deposit_add_bytes`` is the bound of ``rsmcrt_tpu_torch/profile_deposit.py``
(``profile_add``): each row's 4-byte index and ``s``-byte value read once,
each touched cell of an ``s``-byte tally read and written once.
"""

H100_HBM_BYTES_PER_S = 3.35e12


def deposit_add_bytes(rows: int, touched: int, value_bytes: int) -> int:
    """Bytes a ``deposit_add`` launch of ``rows`` rows that touch
    ``touched`` distinct cells needs at least."""
    return (4 + value_bytes) * rows + 2 * value_bytes * touched


def bound_seconds(n_bytes: float,
                  bytes_per_s: float = H100_HBM_BYTES_PER_S) -> float:
    """The least time the card's memory takes to move ``n_bytes``."""
    return n_bytes / bytes_per_s
