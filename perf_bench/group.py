"""The process group as one rank of a cell on several cards sees it
(:mod:`perf_bench.ranks`): the collectives the harness makes between
ranks, each a small all-reduce or all-gather of whole numbers."""

from __future__ import annotations

import torch
import torch.distributed as dist


class Group:
    """This rank's view of the process group, on the device its
    collectives use (the rank's card for NCCL, the host for gloo)."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device

    def _word(self, value: int) -> torch.Tensor:
        return torch.tensor([value], dtype=torch.int64, device=self.device)

    def barrier(self):
        """Returns once every rank has come here."""
        t = self._word(0)
        dist.all_reduce(t)
        t.item()

    def decide(self, more: bool) -> bool:
        """Rank 0's ``more``, on every rank.  An all-reduce, so it also
        returns only once every rank has ended the job."""
        t = self._word(int(more) if self.rank == 0 else 0)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def exchange(self, row: list) -> list:
        """Every rank's ``row`` of whole numbers, in rank order; then
        leaves the group."""
        rows = [self._word(0).repeat(len(row)) for _ in range(self.world)]
        dist.all_gather(
            rows, torch.tensor(row, dtype=torch.int64, device=self.device))
        out = [[int(v) for v in r.tolist()] for r in rows]
        self.close()
        return out

    @staticmethod
    def close():
        if dist.is_initialized():
            dist.destroy_process_group()
