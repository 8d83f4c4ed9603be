"""Multi-process runtime and device meshes on torch.distributed.

Counterpart of aruco_slam_tpu/parallel/dist.py and mesh.py. One OS
process per rank, each with an explicit device, joined by
`torch.distributed` process groups where the JAX package has one runtime
spanning every chip and a `Mesh`:

* `initialize` joins the processes (the ``SLAM_COORDINATOR`` /
  ``SLAM_NUM_PROCESSES`` / ``SLAM_PROCESS_ID`` environment, as in JAX)
  over NCCL or Gloo by a written rule (`choose_backend`);
* a mesh "device" is a (process, slot) pair: a process holds
  ``local_devices`` slots (default 1), so the global device count is
  processes × local_devices, slot-major within a process as JAX lists a
  host's devices. A process runs all its slots on its one device as a
  batch (parallel/sharded_ba.py);
* `make_mesh` / `make_mesh2d` lay the (data, kf) grid over those devices
  as JAX does, kf innermost, and give this process the group of the
  processes that share its kf row (the collectives of an LM iteration run
  over it alone);
* `replicate_to_hosts` and `all_gather_host` make results readable on
  every process with collectives every backend takes (all_reduce on the
  device; all_gather of host bytes).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from aruco_slam_tpu_torch._device import resolve_device

# a collective waits this long for a peer before the run fails (a dead
# peer ends the run instead of hanging it)
TIMEOUT_S = 300
_LOOPBACK = ("127.0.0.1", "localhost", "::1")


@dataclass
class _Runtime:
    local_devices: int = 1
    host_group: object = None  # Gloo group for host tensors under NCCL


_RT = _Runtime()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device_count(local_devices: int | None = None) -> int:
    """Mesh devices over every process: processes × local_devices."""
    return process_count() * (local_devices or _RT.local_devices)


def choose_backend(platform: str, world_size: int,
                   cards: int) -> tuple[str, str]:
    """(backend, reason). NCCL when the ranks' tensors live on CUDA and
    each rank has a card of its own; Gloo otherwise: CPU tensors, or
    several ranks sharing a card, which NCCL refuses ("Duplicate GPU
    detected"). Gloo takes CUDA tensors for all_reduce, staged through
    the host. A rule, not a fallback: a failed NCCL start raises."""
    if platform != "cuda":
        return "gloo", "CPU tensors"
    if world_size <= cards:
        return "nccl", f"{world_size} ranks on {cards} cards, one each"
    return "gloo", (f"{world_size} ranks share {cards} card(s): NCCL needs "
                    "a card per rank; Gloo stages CUDA tensors through the "
                    "host")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_devices: int | None = None,
               platform: str = "cuda") -> None:
    """Join this process to a multi-process run (idempotent).

    The arguments fall back to the ``SLAM_COORDINATOR`` (host:port),
    ``SLAM_NUM_PROCESSES`` and ``SLAM_PROCESS_ID`` environment variables;
    with none of them set it is a no-op (one process). ``local_devices``
    records how many mesh slots this process holds (the JAX
    ``--local-devices``). ``platform`` says where the ranks' tensors
    live: with "cuda" each rank takes card ``rank % device_count``
    before anything is allocated, and "cuda" without a card raises."""
    if local_devices is not None:
        _RT.local_devices = local_devices
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address \
        or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None and "SLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SLAM_NUM_PROCESSES"])
    if process_id is None and "SLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SLAM_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: a multi-process run needs the "
                         "coordinator address, the process count and this "
                         "process's id (SLAM_COORDINATOR, "
                         "SLAM_NUM_PROCESSES, SLAM_PROCESS_ID)")
    resolve_device(platform)
    cards = torch.cuda.device_count() if platform == "cuda" else 0
    if cards:
        torch.cuda.set_device(process_id % cards)
    backend, reason = choose_backend(platform, num_processes, cards)
    if coordinator_address.rsplit(":", 1)[0].strip("[]") in _LOOPBACK:
        # one machine: keep the transports on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # host tensors (front-end candidates, ingested graph states) need a
    # Gloo group; every rank creates it, in the same order
    _RT.host_group = dist.new_group(backend="gloo") \
        if backend == "nccl" else None
    if process_id == 0:
        print(f"dist: {num_processes} processes over {backend} ({reason}); "
              f"{device_count()} mesh devices")


@dataclass(frozen=True)
class Mesh:
    """A grid of mesh devices: ``devices`` holds each position's global
    device index (process × local_devices + slot) with axes
    ``axis_names``; ``group`` is this process's kf group: None when its
    kf rows lie within this process, else the group of the processes
    that share its row."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    local_devices: int
    group: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def layout(self) -> tuple[list[int], int, int]:
        """This process's part of the grid: (its kf rows, the first kf
        slot it holds in them, how many it holds). A 1-D mesh is one row."""
        grid = self.devices.reshape(-1, self.devices.shape[-1])
        owner = grid // self.local_devices
        rank = process_index()
        rows = [d for d in range(grid.shape[0]) if (owner[d] == rank).any()]
        if not rows:
            return [], 0, 0
        ks = np.nonzero(owner[rows[0]] == rank)[0]
        return rows, int(ks[0]), len(ks)


def _mesh(grid: np.ndarray, axis_names, local_devices: int) -> Mesh:
    """Check that every kf row lies within one process or spans whole
    processes (so a process holds the same slots of each of its rows),
    and make the groups of the rows that span processes: every process
    creates every group, in the same order."""
    rows = grid.reshape(-1, grid.shape[-1])
    n_kf = rows.shape[1]
    owner = rows // local_devices
    span = [sorted(set(o.tolist())) for o in owner]
    if any(len(s) > 1 for s in span) and n_kf % local_devices:
        raise ValueError(f"mesh: a {n_kf}-device kf row spans processes but "
                         f"is no multiple of the {local_devices} devices a "
                         "process holds")
    group = None
    world = list(range(process_count()))
    rank = process_index()
    for ranks in span:
        if len(ranks) < 2:
            continue
        g = dist.group.WORLD if ranks == world else dist.new_group(ranks)
        if rank in ranks:
            group = g
    return Mesh(grid, tuple(axis_names), local_devices, group)


def make_mesh(n_devices: int | None = None,
              local_devices: int | None = None) -> Mesh:
    """1-D ``('kf',)`` mesh over the first ``n_devices`` devices (all by
    default), spanning every process. ``local_devices`` defaults to what
    `initialize` recorded (1)."""
    m = local_devices or _RT.local_devices
    n = device_count(m)
    n = n if n_devices is None else min(n_devices, n)
    return _mesh(np.arange(n), ("kf",), m)


def make_mesh2d(n_data: int | None = None, n_kf: int | None = None,
                local_devices: int | None = None) -> Mesh:
    """2-D ``('data', 'kf')`` mesh over the global devices, kf innermost.

    Sizes default as in JAX: kf = one process's devices, data = the rest.
    Unlike JAX, whose ``--local-devices`` acts on its CPU backend only,
    ``local_devices`` here acts on the card too: one process on one H100
    holds several mesh devices (the slots of `Mesh.layout`, batched on
    its card), so one card runs a 2- or 4-shard solve in one process."""
    m = local_devices or _RT.local_devices
    n = device_count(m)
    if n_kf is None:
        n_kf = n // process_count() if n_data is None else n // n_data
    if n_data is None:
        n_data = n // n_kf if n_kf else 0
    if n_data < 1 or n_kf < 1 or n_data * n_kf > n:
        raise ValueError(
            f"make_mesh2d: {n_data}x{n_kf} mesh does not fit "
            f"{n} devices")
    if n_data * n_kf != n:
        print(f"make_mesh2d: {n_data}x{n_kf} uses "
              f"{n_data * n_kf}/{n} devices")
    grid = np.arange(n_data * n_kf).reshape(n_data, n_kf)
    return _mesh(grid, ("data", "kf"), m)


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf, like):
    out, i = [], 0
    for t in like:
        out.append(buf[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def all_reduce_sum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum same-dtype tensors over ``group`` in one collective (packed
    into one flat buffer); no group: returned as they are."""
    if group is None:
        return tensors
    buf = _flat(tensors)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _unflat(buf, tensors)


def replicate_to_hosts(tensors):
    """Make a result readable on every process: each process passes
    full-size tensors holding the parts it owns and zeros elsewhere, and
    one all_reduce per dtype assembles them on every process (adding
    zeros is exact). Returns them as a tuple; one process: unchanged."""
    out = list(tensors)
    if process_count() == 1:
        return tuple(out)
    for dt in dict.fromkeys(t.dtype for t in out):
        idx = [i for i, t in enumerate(out) if t.dtype == dt]
        summed = all_reduce_sum([out[i] for i in idx], dist.group.WORLD)
        for i, t in zip(idx, summed):
            out[i] = t
    return tuple(out)


def all_gather_host(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """numpy arrays of the same shapes on every process -> each stacked
    over the processes (P, ...), bit for bit: their bytes travel in one
    all_gather of a host buffer (Gloo)."""
    p = process_count()
    if p == 1:
        return [a[None] for a in arrays]
    arrays = [np.asarray(a) for a in arrays]
    buf = torch.from_numpy(np.frombuffer(
        b"".join(a.tobytes() for a in arrays), np.uint8).copy())
    bufs = [torch.empty_like(buf) for _ in range(p)]
    dist.all_gather(bufs, buf, group=_RT.host_group)
    out, i = [], 0
    for a in arrays:
        out.append(np.stack([b[i:i + a.nbytes].numpy().copy().view(a.dtype)
                             .reshape(a.shape) for b in bufs]))
        i += a.nbytes
    return out
