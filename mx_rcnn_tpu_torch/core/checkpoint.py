"""Checkpoint save and restore, and preemption handling (port of
``mx_rcnn_tpu/core/checkpoint.py``).

A dump is a directory under the run's prefix: ``epoch_EEEE`` at an epoch
boundary (the end of epoch E − 1), ``step_EEEE_BBBBBB`` mid-epoch (a
preemption or a watchdog abort after B batches of epoch E).  It holds:

- ``state.pt``, the train state's tree (``TrainState.state_tree``) written by
  ``torch.save`` and read with ``torch.load(weights_only=True)``: ``model``,
  the whole ``state_dict`` (frozen tensors and BN buffers included),
  ``momentum``, each trainable tensor's momentum buffer by name (None before
  its first update), and ``count``, the optimizer's update count;
- ``manifest.json``, with the JAX package's manifest keys: ``format``,
  ``epoch``, ``batch_in_epoch``, ``step`` (the count), ``checksum``
  (:func:`tree_checksum` of the tree) and ``files`` (each file's size).

The JAX package writes its data with Orbax, which the port does not import.
The directory logic is the same: a save writes ``<name>.tmp``, fsyncs its
data and manifest, renames it to ``<name>`` and fsyncs the directory, so a
process killed mid-save leaves only an orphaned ``.tmp``.  The readers that
look only at names, manifests and file sizes (:func:`is_committed`,
:func:`restorable_checkpoints`, :func:`latest_checkpoint`,
:func:`prune_step_checkpoints`) therefore judge a directory of the port's
dumps as the JAX package's do.  An Orbax dump is refused by name, before any
of it is read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import signal
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from mx_rcnn_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
MANIFEST_FORMAT = 1
DATA_FILE = "state.pt"
# files an Orbax StandardCheckpointer writes at a dump's top level
_ORBAX_FILES = frozenset({"_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding"})


class CheckpointCorrupt(RuntimeError):
    """A dump that cannot be restored: unreadable, uncommitted, of another
    format, or whose tree's checksum disagrees with its manifest."""


def _ckpt_name(epoch: int, batch_in_epoch: int) -> str:
    """epoch boundary → ``epoch_EEEE``; mid-epoch → ``step_EEEE_BBBBBB``."""
    if batch_in_epoch == 0:
        return f"epoch_{epoch:04d}"
    return f"step_{epoch:04d}_{batch_in_epoch:06d}"


def _parse_ckpt_name(name: str) -> Optional[Tuple[int, int]]:
    parts = name.split("_")
    if name.startswith("epoch_") and len(parts) == 2 and parts[1].isdigit():
        return int(parts[1]), 0
    if name.startswith("step_") and len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
        return int(parts[1]), int(parts[2])
    return None


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def tree_checksum(tree: Any) -> str:
    """sha256 over a tree's sorted names, each tensor's dtype and shape and
    its bytes on the host (any other leaf by its ``repr``): a reshaped or
    re-typed tensor cannot collide with the original, and the memory format
    does not enter."""
    h = hashlib.sha256()
    for name, leaf in _leaves(tree):
        h.update(name.encode())
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def _manifest_files(root: str) -> Dict[str, int]:
    """relpath → size for every regular file under ``root`` but the manifest."""
    out: Dict[str, int] = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            if rel != MANIFEST:
                out[rel] = os.path.getsize(full)
    return out


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover — filesystems that cannot fsync a directory
        pass


def save_checkpoint(
    prefix: str,
    state: Any,
    epoch: int,
    batch_in_epoch: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Crash-safe save of ``state`` (a ``TrainState``, or a tree as
    ``state_tree`` / ``TrainSnapshot.host`` give it), with ``meta`` (JSON)
    recorded under ``manifest["meta"]`` (an elastic shrink stamps its
    emergency dump with the event): write ``<name>.tmp``,
    fsync the data and a manifest into it, rename it to ``<name>``, fsync the
    directory.  A kill at any point leaves the previous committed dump intact
    and at most an orphaned ``.tmp`` that every reader skips.  Returns the
    dump's path."""
    final = os.path.abspath(os.path.join(prefix, _ckpt_name(epoch, batch_in_epoch)))
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = state.state_tree() if hasattr(state, "state_tree") else state
    with open(os.path.join(tmp, DATA_FILE), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "format": MANIFEST_FORMAT,
        "epoch": epoch,
        "batch_in_epoch": batch_in_epoch,
        "step": int(tree["count"]) if "count" in tree else None,
        "checksum": tree_checksum(tree),
        "files": _manifest_files(tmp),
    }
    if meta is not None:
        manifest["meta"] = meta
    # injection point: a kill between the data write and the commit
    faults.crash_save()
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(os.path.dirname(final))
    return final


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed(path: str) -> bool:
    """The manifest exists and every file it records is present at its
    recorded size: catches uncommitted, truncated and partly deleted dumps
    without reading the data."""
    man = read_manifest(path)
    if man is None or not isinstance(man.get("files"), dict):
        return False
    for rel, size in man["files"].items():
        try:
            if os.path.getsize(os.path.join(path, rel)) != int(size):
                return False
        except OSError:
            return False
    return True


def restore_tree(path: str) -> Dict:
    """The dump's tree on the host (no device is touched), unverified.  An
    Orbax dump (the JAX package's) or an unreadable file raises
    :class:`CheckpointCorrupt` before anything is loaded."""
    path = os.path.abspath(path)
    data = os.path.join(path, DATA_FILE)
    if not os.path.isfile(data):
        try:
            names = set(os.listdir(path))
        except OSError as e:
            raise CheckpointCorrupt(f"{path}: {e}") from e
        if names & _ORBAX_FILES:
            raise CheckpointCorrupt(
                f"{path}: an Orbax dump (the JAX package's format), which the port does not "
                f"read; carry a JAX train state across with utils/bridge.py::flax_state_to_torch")
        raise CheckpointCorrupt(f"{path}: no {DATA_FILE}")
    try:
        return torch.load(data, map_location="cpu", weights_only=True)
    except (OSError, EOFError, RuntimeError, ValueError, pickle.UnpicklingError) as e:
        raise CheckpointCorrupt(f"{path}: {DATA_FILE} does not load ({e})") from e


def verify_manifest(path: str, tree: Any = None) -> Dict[str, Any]:
    """The full gate for one committed dump: the manifest present, every
    recorded file at its size, and the tree's checksum equal to the
    manifest's (``tree``: the restored tree, when the caller holds it).
    Returns the manifest; raises :class:`CheckpointCorrupt`."""
    path = os.path.abspath(path)
    man = read_manifest(path)
    if man is None:
        raise CheckpointCorrupt(f"{path}: missing or unreadable manifest")
    if not is_committed(path):
        raise CheckpointCorrupt(
            f"{path}: uncommitted or truncated dump (manifest file sizes disagree with what is "
            f"on disk)")
    if man.get("checksum"):
        if tree is None:
            tree = restore_tree(path)
        got = tree_checksum(tree)
        if got != man["checksum"]:
            raise CheckpointCorrupt(
                f"{path}: restored tree checksum {got[:12]}… does not match manifest "
                f"{str(man['checksum'])[:12]}…")
    return man


def load_checkpoint(prefix: str, epoch: int, target: Any, batch_in_epoch: int = 0) -> Any:
    """Restore dump ``(epoch, batch_in_epoch)`` under ``prefix`` into
    ``target`` in place and return it: a ``TrainState`` takes the whole tree
    (``load_state_tree``), an ``nn.Module`` only the model's ``state_dict``.
    The dump is verified first (:func:`verify_manifest`): one without a
    manifest, truncated, or whose checksum disagrees raises
    :class:`CheckpointCorrupt`."""
    path = os.path.abspath(os.path.join(prefix, _ckpt_name(epoch, batch_in_epoch)))
    tree = restore_tree(path)
    verify_manifest(path, tree=tree)
    if isinstance(target, nn.Module):
        target.load_state_dict(tree["model"])
        return target
    return target.load_state_tree(tree)


def latest_epoch(prefix: str) -> Optional[int]:
    epochs = [e for e, b in restorable_checkpoints(prefix) if b == 0]
    return max(epochs) if epochs else None


def restorable_checkpoints(prefix: str) -> List[Tuple[int, int]]:
    """Every committed checkpoint, newest first.  ``.tmp`` dirs never parse
    as names; dumps whose manifest is missing or whose files are truncated
    are skipped."""
    if not os.path.isdir(prefix):
        return []
    found = []
    for d in os.listdir(prefix):
        parsed = _parse_ckpt_name(d)
        if parsed is None:
            continue
        if not is_committed(os.path.join(prefix, d)):
            logger.warning("skipping unverifiable checkpoint %s (missing/corrupt manifest or "
                           "truncated files)", os.path.join(prefix, d))
            continue
        found.append(parsed)
    # (epoch, batch) order is the resume order: a step dump inside epoch E
    # carries E, the boundary save at the end of epoch E is epoch_{E+1}
    return sorted(found, reverse=True)


def latest_checkpoint(prefix: str) -> Optional[Tuple[int, int]]:
    """(epoch, batch_in_epoch) of the newest committed checkpoint; batch 0
    is an epoch boundary."""
    found = restorable_checkpoints(prefix)
    return found[0] if found else None


def load_restorable(prefix: str, target: Any) -> Optional[Tuple[Tuple[int, int], Any]]:
    """Restore the newest checkpoint that loads and verifies, falling back
    past corrupt dumps to older ones: ``((epoch, batch), target)``, or None
    when nothing is restorable."""
    for epoch, batch in restorable_checkpoints(prefix):
        try:
            return (epoch, batch), load_checkpoint(prefix, epoch, target, batch)
        except CheckpointCorrupt as e:
            logger.warning("checkpoint (epoch %d, batch %d) failed to restore (%s): falling back "
                           "to the previous dump", epoch, batch, e)
    return None


def prune_step_checkpoints(prefix: str, up_to_epoch: int) -> None:
    """Delete the ``step_E_B`` dumps with E ≤ ``up_to_epoch`` (superseded
    once ``epoch_{E+1}`` exists) and every orphaned ``.tmp``.  The newest
    committed step dump is kept whatever its epoch, so a lost or corrupt
    boundary save still has a mid-epoch dump to fall back to."""
    if not os.path.isdir(prefix):
        return
    step_dumps = []
    for d in os.listdir(prefix):
        parsed = _parse_ckpt_name(d)
        if parsed is not None and parsed[1] != 0:
            step_dumps.append((parsed, d))
    keep = max((pd for pd in step_dumps if is_committed(os.path.join(prefix, pd[1]))),
               default=None)
    for d in os.listdir(prefix):
        full = os.path.join(prefix, d)
        if d.endswith(".tmp") and os.path.isdir(full):
            logger.info("pruning orphaned partial checkpoint %s", full)
            shutil.rmtree(full, ignore_errors=True)
            continue
        parsed = _parse_ckpt_name(d)
        if parsed is None or parsed[1] == 0:
            continue
        if keep is not None and d == keep[1]:
            continue
        if parsed[0] <= up_to_epoch:
            shutil.rmtree(full, ignore_errors=True)


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a "stop after this step" flag::

        guard = PreemptionGuard()          # installs the handlers
        for batch in loader:
            ...
            if guard.should_stop:
                save_checkpoint(prefix, state, epoch, batch_idx)
                return

    The first signal sets the flag; a second falls through to the previous
    handler, so a stuck run can still be killed.  Python runs the handler on
    the main thread between bytecodes, so the flag is read after the step in
    hand returns.  Install it from the main thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        if self.should_stop:  # second signal: escalate
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        self.should_stop = True

    def uninstall(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
