"""Data parallelism over ranks: the KVStore('device') replacement (port of
``mx_rcnn_tpu/parallel/mesh.py``).

The JAX package runs one ``shard_map`` over a ``('data', 'model')`` device
mesh.  Here a mesh is a :class:`DataMesh`: a ``torch.distributed`` process
group over some ranks (one process and one device each,
``parallel/distributed.py``), this rank's position in it and its device.
Each rank runs the same train step on its rows of the global batch; the
trainable gradients are summed over the group in one flat buffer and divided
by the group's size read at call time (JAX's runtime ``psum(1)``), the
float32 aux meaned the same way, then every rank makes the same MXNet-SGD
update, so the states stay equal: the invariant KVStore kept with explicit
broadcasts.  :func:`replicate` makes them equal to begin with.

Only the ``data`` axis exists: ``n_model > 1`` (spatial sharding,
``parallel/spatial.py``) raises.  The all-reduce runs after the whole
backward (DDP's overlap of communication with the backward is a speed
change for later).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.train import train_step
from mx_rcnn_tpu_torch.models.faster_rcnn import fold_in
from mx_rcnn_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class DataMesh:
    """A data-parallel set of ranks: ``group`` (None in one process),
    ``ranks`` (global ranks, in mesh order), ``position`` (this rank's index
    in ``ranks``, None when it is not a member) and this rank's ``device``."""

    group: Any
    ranks: Tuple[int, ...]
    position: Optional[int]
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.position is not None

    def live_size(self) -> int:
        """The group's size as the process group reports it now."""
        return 1 if self.group is None else dist.get_world_size(self.group)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None, device=None) -> DataMesh:
    """A mesh over ``ranks`` (default: every rank).  A proper subset gets a
    group of its own from ``dist.new_group``, which every rank of the world
    must call, in the same order, members or not."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: spatial sharding over a 'model' axis (ROADMAP item 9's "
            f"parallel/spatial.py) is not ported; the port's mesh has the data axis only")
    world = distributed.process_count()
    ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
    if n_data is not None and n_data != len(ranks):
        raise ValueError(f"{len(ranks)} ranks cannot form a data axis of {n_data}")
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    dev = torch.device(device) if device is not None else distributed.local_device()
    if not dist.is_initialized():
        group = None
    elif ranks == tuple(range(world)):
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(ranks))
    me = distributed.process_index()
    return DataMesh(group, ranks, ranks.index(me) if me in ranks else None, dev)


def replica_slices(n_replicas: Optional[int] = None, devices=None) -> list:
    """Devices for a serving replica pool: replica i runs on
    ``slices[i % len(slices)]``.  The transpose of the training mesh: one
    independent predictor a device.  Default: every card (the CPU when
    there is none); with ``n_replicas`` ≤ their count, the first ones."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif torch.cuda.is_available():
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    if n_replicas is None or n_replicas >= len(devs):
        return devs
    return devs[:n_replicas]


def _flat_groups(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    chunks, pos = [], 0
    for t in tensors:
        n = t.numel()
        chunks.append(flat[pos:pos + n].view(t.shape))
        pos += n
    torch._foreach_copy_(tensors, chunks)


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], group, divide_by: int = 1) -> int:
    """Sum ``tensors`` in place over ``group``, one flat buffer per dtype
    (one collective each), then divide by ``divide_by`` (skipped at 1, where
    it is exact anyway).  Returns the bytes reduced."""
    nbytes = 0
    for ts in _flat_groups(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divide_by != 1:
            flat.div_(divide_by)
        _unflatten_into(flat, ts)
        nbytes += flat.numel() * flat.element_size()
    return nbytes


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Rank ``src``'s values of ``tensors`` into every member's, one flat
    buffer per dtype."""
    for ts in _flat_groups(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        _unflatten_into(flat, ts)


@torch.no_grad()
def replicate(state, mesh: DataMesh, src: Optional[int] = None):
    """Make every member's train state equal to rank ``src``'s (default the
    mesh's first rank): the trainable tensors, the momentum buffers (created
    or dropped where the source has or lacks one), the frozen tensors and
    buffers of the ``state_dict``, and the update count.  Ranks that start
    from different seeds end identical.  A non-member or a one-rank mesh
    keeps its state as it is."""
    if not mesh.member or mesh.size == 1:
        return state
    src = mesh.ranks[0] if src is None else int(src)
    opt = state.optimizer
    meta = [opt.count] + [int(opt.sgd.state[p].get("momentum_buffer") is not None)
                          for p in opt.params]
    meta_t = torch.tensor(meta, dtype=torch.int64, device=mesh.device)
    dist.broadcast(meta_t, src=src, group=mesh.group)
    meta = meta_t.tolist()
    opt.count = int(meta[0])
    momenta = []
    for p, has in zip(opt.params, meta[1:]):
        st = opt.sgd.state[p]
        if not has:
            st.pop("momentum_buffer", None)
            continue
        if st.get("momentum_buffer") is None:
            st["momentum_buffer"] = torch.empty_like(p)
        momenta.append(st["momentum_buffer"])
    broadcast_(list(state.model.state_dict().values()) + momenta, src, mesh.group)
    return state


def shard_batch(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """This rank's rows of a host global batch (the leading axis split in
    mesh order), on its device."""
    rows = distributed.process_slice(len(batch["images"]), rank=mesh.position, world=mesh.size)
    return batch_to_device({k: v[rows] for k, v in batch.items()}, mesh.device)


def take_replica_rows(batch: Dict, n_active: int, n_base: int) -> Dict:
    """Truncate a base-set global batch to ``n_active`` of ``n_base``
    replicas' worth of leading-axis rows.

    The elastic shrink path (``parallel/elastic.py``) keeps the loader's
    plan at the BASE global batch size (re-planning mid-epoch would change
    the deterministic shuffle and bucketing) and drops the tail rows of
    each global batch.  Always the tail, never the dead replica's rows: the
    kept prefix is then a function of the survivor COUNT only, so a fresh
    small run fed the same stream consumes the same batches whichever
    ordinal died."""
    if n_active == n_base:
        return batch
    out = {}
    for k, v in batch.items():
        rows = np.shape(v)[0]
        if rows % n_base:
            raise ValueError(f"batch key {k!r}: {rows} rows not divisible by the "
                             f"{n_base}-replica base set")
        out[k] = v[: rows * n_active // n_base]
    return out


def make_parallel_train_step(mesh: DataMesh, accum_steps: int = 1):
    """The DP train step ``step(state, batch, rng, lr_scale=None,
    draws=None) → (state, aux)`` over ``mesh``; ``batch`` (and ``draws``)
    hold this rank's rows on its device.

    Arithmetic of the JAX package's ``make_parallel_train_step``: a batch
    without per-image ``sample_seeds`` folds the rank's position into the
    seed (with them, each image draws as in a one-device run); forward and
    backward on the rank's rows (``accum_steps`` microbatches first); the
    trainable gradients summed over the group and divided by its size, read
    at call time; the aux as float32, meaned the same way; then the update
    (the clip after the mean).  ``step.comm`` counts the all-reduces and
    their bytes."""
    comm = {"all_reduces": 0, "bytes": 0}

    def mean_over_group(params, aux):
        n = mesh.live_size()
        grads = [p.grad for p in params if p.grad is not None]
        keys = list(aux)
        vals = [aux[k].detach().to(torch.float32) for k in keys]
        flat_aux = torch.cat([v.reshape(-1) for v in vals])
        # one float32 buffer: one collective a step
        comm["bytes"] += all_reduce_sum_(grads + [flat_aux], mesh.group, n)
        comm["all_reduces"] += 1
        out, pos = {}, 0
        for k, v in zip(keys, vals):
            out[k] = flat_aux[pos:pos + v.numel()].view(v.shape)
            pos += v.numel()
        return out

    def step(state, batch, rng, lr_scale=None, draws=None):
        if "sample_seeds" not in batch:
            rng = fold_in(rng, mesh.position)
        return train_step(state, batch, rng, lr_scale, draws=draws, accum_steps=accum_steps,
                          reduce=mean_over_group)

    step.comm = comm
    step.mesh = mesh
    return step
