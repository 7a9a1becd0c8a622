"""Process meshes over ``torch.distributed`` — twin of the JAX
``parallel/mesh.py``.

A JAX mesh names the axes of an array of devices, and code inside
``shard_map`` reaches an axis by its name. In the port every process is one
member of the mesh (one rank, one device), and an axis is a process group:
the ranks whose coordinates differ only along that axis. :func:`make_mesh`
creates the groups of every axis; ``mesh.axis("seq")`` (an :class:`Axis`)
is what the port's parallel functions take where JAX takes an axis name:
its size, this rank's index along it, its group and the group's ranks.
Ranks are laid out row-major over the axes, as JAX lays out
``np.array(devices).reshape(sizes)``.

Axis names, as in JAX: ``"data"`` (batch rows), ``"seq"`` (sequence shards:
ring attention, Ulysses, the sequence-sharded decode, context-parallel
training), ``"model"`` (tensor and expert parallelism, ``parallel/tp.py``)
and ``"pipe"`` (pipeline stages, ``parallel/pp.py``).

:func:`init_distributed` joins the process group: from ``env://`` (what
``torchrun`` sets) or from an explicit address, world size and rank, with
the backend the caller names (``"nccl"`` across cards, ``"gloo"`` for
processes on the CPU or sharing one card); nothing switches it.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

from starflashattention_tpu_torch.utils.device import resolve_device


def init_distributed(init_method: str | None = None, *, backend: str, world_size: int | None = None,
                     rank: int | None = None, device: torch.device | str | None = None) -> torch.device:
    """Join the default process group (once; a second call only returns the
    device) and return this rank's device.

    ``init_method`` None reads ``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them; otherwise an
    address such as ``"tcp://localhost:29500"`` with ``world_size`` and
    ``rank``. The device is ``cuda:{LOCAL_RANK % device_count}`` (the rank
    when ``LOCAL_RANK`` is unset), which raises without a card, unless the
    caller passes ``device`` (``"cpu"`` for the CPU)."""
    if not dist.is_initialized():
        if init_method is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            if world_size is None or rank is None:
                raise ValueError("an explicit init_method needs world_size and rank")
            dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if device is None:
        resolve_device("cuda")  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis of a :class:`Mesh` as this rank sees it."""

    name: str
    size: int
    index: int  # this rank's coordinate along the axis
    ranks: tuple[int, ...]  # the global ranks of the axis's group, in index order
    group: object  # the torch.distributed process group of those ranks
    backend: str  # the group's backend: "gloo" copies CUDA tensors through the host (parallel/comm.py)

    def rank_at(self, index: int) -> int:
        """The global rank at ``index`` (mod the size) along the axis."""
        return self.ranks[index % self.size]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named process groups over the world, and this rank's device."""

    axes: dict[str, Axis]
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {name: a.size for name, a in self.axes.items()}

    def axis(self, name: str) -> Axis:
        if name not in self.axes:
            raise ValueError(f"mesh has no axis {name!r} (axes: {', '.join(self.axes)})")
        return self.axes[name]


def make_mesh(axis_sizes: dict[str, int] | None = None, *, device: torch.device | str | None = None) -> Mesh:
    """A :class:`Mesh` from ``{axis_name: size}`` over the world of the
    initialized process group (size -1 absorbs the rest); every rank must
    call it with the same sizes, since it creates the groups of every axis
    in one order. ``make_mesh({"seq": 4})`` on 4 ranks: one group of 4;
    ``make_mesh({"data": 2, "seq": 2})``: ranks (0, 1) and (2, 3) share a
    sequence, (0, 2) and (1, 3) a position in it. Default: every rank on one
    ``"model"`` axis. ``device`` as in :func:`init_distributed` (default the
    current card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call init_distributed first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"model": n}
    names, sizes = list(axis_sizes), list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    grid = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    coords = [int(c[0]) for c in np.nonzero(grid == me)]
    backend = str(dist.get_backend())
    axes = {}
    for i, name in enumerate(names):
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):  # every group of the axis, in one order on every rank
            idx = list(rest)
            idx.insert(i, slice(None))
            ranks = tuple(int(r) for r in grid[tuple(idx)])
            group = dist.new_group(list(ranks))
            if me in ranks:
                axes[name] = Axis(name, sizes[i], coords[i], ranks, group, backend)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cuda"
    return Mesh(axes, resolve_device(device))
