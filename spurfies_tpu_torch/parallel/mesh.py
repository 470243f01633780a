"""Ray sharding over ranks (port of ``spurfies_tpu/parallel/mesh.py``).

The per-scene model is small (latents + MLPs, a few MB), so its parameters
are replicated and the batch's rays are split.  The JAX package runs one
program over a 1-D ``("data",)`` mesh and XLA inserts the gradient
all-reduce.  Here each rank is a process under ``torch.distributed``
(:mod:`parallel.launch` starts or joins them): every rank holds the whole
batch, renders its share of the rays, and the ranks sum their gradients
with one all-reduce of a flat buffer before the optimizer.  The collectives
are NCCL's when the ranks sit on distinct cards and gloo's otherwise (the
CPU, or several ranks on one card, which NCCL refuses); gloo stages CUDA
tensors through the host and waits for them.
"""

import dataclasses

import torch
import torch.distributed as dist

_CURRENT = None


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's rank among ``world`` ranks, its device and the
    backend of the default process group, which its collectives use."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def lead(self) -> bool:
        """Rank 0: the rank that logs, writes files and counts the terms
        that do not depend on the rays."""
        return self.rank == 0

    def all_reduce_(self, tensors: list) -> list:
        """Sum ``tensors`` over the ranks in place, through one flat buffer
        (one collective, however many tensors)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return tensors

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``x`` summed over the ranks (sums and counts)."""
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[world, *x.shape]``: every rank's ``x`` (same shape on every
        rank), in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    def broadcast_(self, tensors: list, src: int = 0) -> list:
        """Rank ``src``'s values of ``tensors``, in place on every rank,
        through one flat buffer."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        i = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()
        return tensors

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(
            box, src, device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def current() -> RankGroup | None:
    """The group this process joined through :mod:`parallel.launch`, or
    None outside one."""
    return _CURRENT


def set_current(group: RankGroup | None):
    global _CURRENT
    _CURRENT = group


def visible_devices() -> int:
    """The devices a ``Trainer`` can shard over: the ranks of this
    process's group (1 outside one)."""
    return _CURRENT.world if _CURRENT is not None else 1


def make_group(n: int) -> RankGroup:
    """The counterpart of ``make_mesh(n)``: this process's group, which
    must hold ``n`` ranks."""
    have = visible_devices()
    if have < n:
        raise ValueError(
            f"train.data_parallel={n} but only {have} devices visible")
    if have != n:
        raise ValueError(
            f"train.data_parallel={n} but {have} ranks joined the group")
    return _CURRENT


def shard_views(views: dict, group: RankGroup) -> dict:
    """The counterpart of JAX's ``shard_views``, which replicates the view
    stacks over the mesh.  Here every rank loads the same views onto its
    own device, so nothing is moved: the views are returned as they are."""
    return views
