"""The (data, model) grid of ranks: the port's parallelism substrate.

Counterpart of ``stable_diffusion_videos_tpu/parallel/mesh.py``.  The JAX
package lays a ``jax.sharding.Mesh`` over every chip and lets XLA insert the
collectives.  Here the program is SPMD in PyTorch's own idiom: one process
a rank (launched by ``torchrun`` or by ``initialize_multihost``), every rank
running the same walk call, and the collectives written out with
``torch.distributed`` on one process group an axis:

* ``data``: the frames of a dispatch are split over its ranks, each rank
  runs its rows and the frames are all-gathered, so every rank returns the
  whole batch (the JAX program's global array);
* ``model``: the weights are split Megatron-style (``parallel/tp.py``), or
  with ``spatial_shard`` the latent's width is (``parallel/spatial.py``).

Training (``training/``) splits a step's batch over ``data`` and averages
the fp32 gradients with ``Mesh.all_reduce_mean_``: the tensors in
parameter order, flattened into buckets of at most ``BUCKET_BYTES``, each
bucket summed and divided by the axis size, so every rank ends with the
same bits (the psum XLA inserts in the JAX trainers).

Global rank r sits at ``(r // model, r % model)``, the JAX package's
``reshape(data, model)``.  Without an initialised process group the mesh
is one rank and no collective runs.

The backend is the caller's: NCCL across cards, gloo on the CPU and where
two ranks share one card (NCCL refuses that).  Under gloo a tensor on the
card is staged through host memory around each collective, except in a
group whose ranks all sit on one card (``devices=`` repeating it): there
the bytes move card to card through buffers each rank maps from the others
by CUDA IPC (``PeerBuffers``), and gloo carries only the barrier that
orders them.  Both choices are made from the layout when the mesh is built,
never after a failure.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the most bytes one bucket of ``Mesh.all_reduce_mean_`` holds: the peer
#: buffers' first capacity, so a gradient reduction never grows them (a
#: 3.44 GB fp32 gradient in one piece would map about four times that a
#: rank, on a card the ranks share)
BUCKET_BYTES = 64 << 20


class PeerBuffers:
    """The exchange of one group whose ranks share a card: two device
    buffers a rank, each mapped into every other rank by CUDA IPC.  A
    collective copies this rank's bytes into its buffer, waits for its
    stream, meets the others at the group's barrier and reads their
    buffers; the two buffers alternate, so a buffer is written again only
    after every rank has passed a later barrier, by which time its reads
    of it have completed.  The buffers grow (collectively: every rank
    exchanges tensors of one size) when a tensor does not fit."""

    def __init__(self, group, n: int, index: int, device,
                 capacity: int = 64 << 20):
        self.group, self.n, self.index = group, n, index
        self.device, self.turn = torch.device(device), 0
        self._map(capacity)

    def _map(self, capacity: int) -> None:
        from torch.multiprocessing.reductions import reduce_tensor
        self.capacity = capacity
        self.own = [torch.empty(capacity, dtype=torch.uint8,
                                device=self.device) for _ in range(2)]
        shared = [None] * self.n
        dist.all_gather_object(shared, [reduce_tensor(b) for b in self.own],
                               group=self.group)
        self.bufs = [self.own if r == self.index
                     else [fn(*args) for fn, args in shared[r]]
                     for r in range(self.n)]

    def exchange(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (one shape and dtype on every rank), as views
        of the buffers, valid until the collective after next."""
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        if nbytes > self.capacity:
            torch.cuda.current_stream(self.device).synchronize()
            dist.barrier(group=self.group)  # nobody still reads the old
            self._map(max(nbytes, 2 * self.capacity))
        k, self.turn = self.turn, self.turn ^ 1
        self.own[k][:nbytes].copy_(x.view(-1).view(torch.uint8))
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)
        return [b[k][:nbytes].view(x.dtype).view(x.shape) for b in self.bufs]


class Mesh:
    """A (data, model) grid of ranks with one process group an axis; this
    process is one of them, on ``device``.  ``group(axis)`` is the group of
    the ranks that share this rank's other coordinate (None for a one-rank
    axis); ``index(axis)`` this rank's place on ``axis``.  ``peers``: the
    axes whose ranks share this rank's card, with their ``PeerBuffers``."""

    def __init__(self, data: int, model: int, rank: int, device,
                 backend: Optional[str], groups: dict,
                 peers: Optional[dict] = None):
        self.shape = {"data": int(data), "model": int(model)}
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups
        self.peers = peers or {}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, device="
                f"{self.device}, backend={self.backend})")

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        return (self.rank // self.shape["model"] if axis == "data"
                else self.rank % self.shape["model"])

    def group(self, axis: str):
        return self._groups.get(axis)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: gloo moves host memory."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        return t.contiguous()

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in the
        axis' order; ``t`` itself on a one-rank axis.  Every rank's ``t``
        has one shape."""
        n = self.shape[axis]
        if n == 1:
            return t
        if axis in self.peers:
            return torch.cat(self.peers[axis].exchange(t), dim)
        x = self._staged(t)
        if self.backend == "gloo" and x.dtype == torch.bfloat16:
            x = x.view(torch.float16)  # gloo has no bf16: moved bit for bit
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group(axis))
        return torch.cat(parts, dim).view(t.dtype).to(t.device)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of the ranks' ``t`` along ``axis`` (a new tensor in
        ``t``'s dtype; under gloo a bf16 tensor is summed in fp32 and
        rounded once)."""
        if self.shape[axis] == 1:
            return t
        if axis in self.peers:
            parts = self.peers[axis].exchange(t)
            out = parts[0].float() if t.dtype == torch.bfloat16 else \
                parts[0].clone()
            for p in parts[1:]:
                out += p
            return out.to(t.dtype)
        x = self._staged(t)
        if self.backend == "gloo" and x.dtype == torch.bfloat16:
            x = x.float()
        else:
            x = x.clone()
        dist.all_reduce(x, group=self.group(axis))
        return x.to(t.device, t.dtype)

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor],
                         axis: str = "data") -> None:
        """Each of ``tensors`` becomes, in place, the mean of the ranks'
        along ``axis`` (contiguous tensors of one dtype, the same list of
        shapes on every rank, as a data-parallel step's gradients are).  The
        tensors go in list order through ``flat_buckets`` of at most
        ``BUCKET_BYTES``; each bucket is summed by ``all_reduce`` and
        divided by the axis size, so every rank ends with the same bits.
        Nothing happens on a one-rank axis."""
        n = self.shape[axis]
        if n == 1:
            return
        for pieces in flat_buckets(tensors):
            bucket = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
            total = self.all_reduce(bucket, axis)
            total.div_(n)
            torch._foreach_copy_(
                pieces, list(total.split([p.numel() for p in pieces])))

    def barrier(self) -> None:
        """Every rank of the mesh meets here (nothing on one rank)."""
        if self.size > 1:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (itself on a one-rank mesh)."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def rows(self, n: int, axis: str = "data") -> slice:
        """This rank's share of ``n`` rows split evenly over ``axis``."""
        k = self.shape[axis]
        if n % k:
            raise ValueError(f"{n} rows do not split over {k} {axis} ranks")
        i = self.index(axis)
        return slice(i * n // k, (i + 1) * n // k)


def flat_buckets(tensors: Sequence[torch.Tensor],
                 bucket_bytes: int = BUCKET_BYTES):
    """The elements of ``tensors`` (contiguous, one dtype) in list order,
    as lists of 1-D views holding at most ``bucket_bytes`` each; a tensor
    larger than a bucket spans several."""
    flat = [t.view(-1) for t in tensors]
    if not flat:
        return
    cap = max(1, bucket_bytes // flat[0].element_size())
    pieces, room = [], cap
    for t in flat:
        start = 0
        while start < t.numel():
            take = min(room, t.numel() - start)
            pieces.append(t[start:start + take])
            start, room = start + take, room - take
            if not room:
                yield pieces
                pieces, room = [], cap
    if pieces:
        yield pieces


def single(device) -> Mesh:
    """The one-rank mesh on ``device``: no process group, no collective."""
    return Mesh(1, 1, 0, device, None, {})


def _rank_device(devices, rank: int, local_rank: int) -> torch.device:
    if devices is not None:
        return torch.device(devices[rank])
    dev = torch.device("cuda", local_rank)
    if not torch.cuda.is_available() or local_rank >= \
            torch.cuda.device_count():
        raise RuntimeError(f"rank {rank} maps to {dev} (LOCAL_RANK "
                           f"{local_rank}), which this host does not have; "
                           "pass devices= for CPU ranks")
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """Build the (data, model) grid over the process group's ranks.

    ``data`` defaults to world size // ``model``; ``data·model`` must be
    the world size (``ValueError`` otherwise).  Without an initialised
    process group the world is this one process.  ``devices``: each global
    rank's device, in rank order (one card may repeat: two ranks sharing
    it over gloo); by default rank r takes ``cuda:LOCAL_RANK``, which must
    exist.  ``backend``: the axis groups' backend, by default the default
    group's.  A CUDA rank makes its card current here, before the kernel
    library loads (it prepares the kernels on the current device).  Every
    rank calls this with the same arguments: the axis groups are created
    collectively."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if data is None:
        data = world // model
    if model < 1 or data < 1 or data * model != world:
        raise ValueError(f"data*model ({data}*{model}) != world size "
                         f"({world})")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    local = int(os.environ.get("LOCAL_RANK", rank if world > 1 else 0))
    device = _rank_device(devices, rank, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not initialised:
        return single(device)
    backend = backend or dist.get_backend()
    grid = np.arange(world).reshape(data, model)
    groups, peers = {}, {}
    # every rank creates every group, in one order
    for axis, lines in (("data", grid.T), ("model", grid)):
        for line in lines:
            g = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line and len(line) > 1:
                groups[axis] = g
                on_one_card = devices is not None and len(
                    {torch.device(devices[int(r)]) for r in line}) == 1
                if backend == "gloo" and device.type == "cuda" and \
                        on_one_card:
                    peers[axis] = PeerBuffers(
                        g, len(line), list(line).index(rank), device)
    return Mesh(data, model, rank, device, backend, groups, peers)


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.shape["data"]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0."""
    return ((n + multiple - 1) // multiple) * multiple


def pad_along_axis(array, pad_size: int, axis: int = 0):
    """Zero-pad ``pad_size`` trailing entries on ``axis`` of a numpy array
    or a tensor."""
    if pad_size <= 0:
        return array
    if torch.is_tensor(array):
        shape = list(array.shape)
        shape[axis] = pad_size
        return torch.cat([array, array.new_zeros(shape)], axis)
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, pad_size)
    return np.pad(array, widths)


def wrap_pad(x, multiple: int):
    """``x`` (a tensor or a numpy array) with its rows repeated from the
    start until their count is a multiple of ``multiple``: rows
    ``arange(ceil(b / multiple) · multiple) % b``, as the JAX trainers pad
    an uneven batch (real samples, so the padded batch's mean stays an
    unbiased mini-batch estimate).  ``x`` itself when it divides."""
    b = x.shape[0]
    if b % multiple == 0:
        return x
    idx = np.arange(pad_to_multiple(b, multiple)) % b
    if torch.is_tensor(x):
        return x[torch.as_tensor(idx, device=x.device)]
    return x[idx]


def shard_rows(mesh: Mesh, x):
    """This rank's rows of ``x`` on the ``data`` axis (the JAX package's
    ``batch_sharding``): ``x`` has a multiple of the data size rows."""
    return x[mesh.rows(x.shape[0])]


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows, in order: the whole batch on every rank
    (the JAX package's replicated result)."""
    return mesh.all_gather(x, "data", 0)
