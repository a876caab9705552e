"""Multi-process training: joining the process group, and which rows of the
global batch this rank loads (port of ``mx_rcnn_tpu/parallel/distributed.py``).

A JAX mesh device is a **rank** here: one process with one device,
``cuda:(rank % torch.cuda.device_count())`` on the card and ``cpu`` under
``--cpu``.  Every rank calls :func:`initialize` first; the backend follows
the topology, never a caught failure: NCCL when every local rank has a card
of its own, gloo on the CPU or when local ranks share a card (a test
topology, as the JAX package's virtual CPU devices are).  :func:`backend`
says which one is in use.

Every rank runs the same program over the same global batch *plan* and
loads only its rows (:func:`process_slice`, ``TrainLoader(row_slice=)``), so
the global data order does not depend on the number of ranks.  torch has no
global array: :func:`globalize_batch` places the rank's own rows on its
device, and the collectives of ``parallel/mesh.py`` keep the ranks' states
equal.  Collectives over host data (:func:`agree_on_down`, the resume
choice, the stop vote) run on CPU tensors over :func:`host_group`, a gloo
group (gloo has no CUDA ``all_gather``, NCCL no CPU tensors).

In one process all of this is the identity, so the trainer keeps one code
path.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from mx_rcnn_tpu_torch.core.pipeline import batch_to_device

logger = logging.getLogger(__name__)

# how long a collective may wait for its peers before it raises
TIMEOUT_S = 300.0
# set (to anything) by a launcher that hosts the rendezvous store itself
# (:func:`host_rendezvous`): every rank, rank 0 too, joins it as a client
HOSTED_STORE_ENV = "MX_RCNN_DIST_HOSTED_STORE"

_state: Dict[str, Any] = {"device": None, "host_group": None}


def device_for_rank(rank: int, cpu: bool = False) -> torch.device:
    """The rank's device: ``cpu``, or card ``rank % device_count``."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass cpu=True (--cpu) to train "
                           "on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(cpu: bool, local_ranks: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if cpu or local_ranks > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu: bool = False,
    timeout: float = TIMEOUT_S,
) -> Optional[str]:
    """Join the process group; a no-op in a single process (returns None).

    ``coordinator`` is ``host:port`` of rank 0's rendezvous (of the
    launcher's when :data:`HOSTED_STORE_ENV` is set), ``num_processes``
    the world size, ``process_id`` this rank.  ``--dist_procid`` given
    without the other two is refused, as the JAX package does.  The local
    rank count is ``LOCAL_WORLD_SIZE`` when the launcher sets it, else the
    world size (every rank on this host).  Sets this rank's device (card
    ``rank % device_count``, or the CPU) and returns the backend."""
    if coordinator is None and num_processes is None:
        if process_id is not None:
            raise ValueError(
                "distributed: --dist_procid given without --dist_coordinator/--dist_nprocs — "
                "refusing to train as an independent single process"
            )
        _state["device"] = torch.device("cpu") if cpu else None
        return None
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("distributed: --dist_coordinator, --dist_nprocs and --dist_procid "
                         "go together")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(cpu, local)
    dev = device_for_rank(process_id, cpu)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    td = datetime.timedelta(seconds=timeout)
    if os.environ.get(HOSTED_STORE_ENV):
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), int(num_processes), is_master=False, timeout=td)
        dist.init_process_group(backend, store=store, world_size=int(num_processes),
                                rank=int(process_id), timeout=td)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=td)
    _state["device"] = dev
    # host-data collectives need CPU tensors, which NCCL does not take
    _state["host_group"] = (dist.new_group(backend="gloo") if backend == "nccl"
                            else dist.group.WORLD)
    logger.info("distributed: rank %d/%d on %s over %s (%d local)", process_id,
                num_processes, dev, backend, local)
    return backend


def host_rendezvous(world: int, timeout: float = TIMEOUT_S):
    """A rendezvous store for ``world`` ranks that this process, their
    launcher, hosts on a port the OS picks as it binds it: → ``(store,
    "127.0.0.1:PORT")``.  A port found free and bound later by rank 0 can be
    taken in between by any process of the host (a rank takes seconds to
    start).  Keep ``store`` while the ranks run and start them with
    :data:`HOSTED_STORE_ENV` set."""
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    return store, f"127.0.0.1:{store.port}"


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["host_group"] = None


def backend() -> Optional[str]:
    """The process group's backend ("nccl" | "gloo"), None in one process."""
    return dist.get_backend() if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one that writes run metadata, checkpoints and metrics."""
    return process_index() == 0


def local_device() -> torch.device:
    """The device :func:`initialize` gave this rank (the card by default)."""
    if _state["device"] is None:
        _state["device"] = device_for_rank(process_index())
    return _state["device"]


def host_group():
    """The gloo group over every rank that host-data collectives use."""
    return _state["host_group"] if dist.is_initialized() else None


def process_slice(global_batch: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> slice:
    """The rows ``[rank·L, (rank+1)·L)`` of the global batch this rank
    loads, L = global / world (default: this process's rank and the world
    size): the row → rank placement :func:`globalize_batch` and
    ``mesh.shard_batch`` use."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    local = global_batch // world
    return slice(rank * local, (rank + 1) * local)


def globalize_batch(local_batch: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """The rank's own rows of a global batch (a row-sliced loader's batch)
    on its device.  torch has no global array view: the ranks' step
    functions see only their rows, and the gradients' all-reduce makes the
    step global.  ``mesh``: its device, else :func:`local_device`."""
    return batch_to_device(local_batch, mesh.device if mesh is not None else local_device())


def agree_on_down(down, n_replicas: int, group=None) -> frozenset:
    """The union over every rank of the replica ordinals each suspects
    down: every rank must shrink to the same survivor set, or the rebuilt
    groups disagree and the next collective hangs.  The identity in one
    process; else one ``all_reduce(MAX)`` of an int32 mask on the CPU over
    ``group`` (default :func:`host_group`), paid only on the shrink path."""
    down = frozenset(int(d) for d in down)
    if process_count() == 1:
        return down
    mask = torch.zeros(n_replicas, dtype=torch.int32)
    for d in down:
        mask[d] = 1
    dist.all_reduce(mask, op=dist.ReduceOp.MAX, group=group or host_group())
    return frozenset(int(i) for i in torch.nonzero(mask).flatten().tolist())


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is True on any (one CPU
    ``all_reduce(MAX)``; ``flag`` itself in one process)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group or host_group())
    return bool(t.item())


def broadcast_ints(values, src: int = 0, group=None) -> tuple:
    """Rank ``src``'s integers on every rank (a CPU broadcast)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if process_count() > 1:
        dist.broadcast(t, src=src, group=group or host_group())
    return tuple(int(v) for v in t.tolist())


def local_global_batch_sizes(per_chip: int, world: Optional[int] = None) -> tuple:
    """(local, global) batch sizes for ``per_chip`` images a rank: one
    device a rank, so the local batch is ``per_chip``."""
    world = process_count() if world is None else world
    return per_chip, per_chip * world
