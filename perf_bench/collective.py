"""The peak of the link between the cards, and the bus bytes of an
all-reduce, frozen here so that a change to the program cannot move
them.

Peak: NVIDIA's data sheet for the H100 SXM5 80 GB, NVLink 4 with 18
links: 900 GB/s in all, 450 GB/s a direction.  A machine whose cards are
joined by PCIe alone reaches far less, and its share of this peak reads
low; ``nvidia-smi topo -m`` says which.

``busbw_bytes`` is NCCL's convention (its tests' ``busbw``): a ring
all-reduce over ``world`` ranks moves ``2 (world - 1) / world`` times the
reduced bytes through each rank's link, whatever the algorithm, so the
bus bytes over the time are comparable with the link's peak.
"""

H100_NVLINK_BYTES_PER_S = 450e9


def busbw_bytes(reduced_bytes: int, world: int) -> float:
    """Bytes through each rank's link when ``world`` ranks all-reduce
    ``reduced_bytes``."""
    return 2.0 * (world - 1) / world * reduced_bytes
