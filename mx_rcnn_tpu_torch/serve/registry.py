"""Versioned model registry and live checkpoint hot swap (port of
``mx_rcnn_tpu/serve/registry.py``).

Params are a versioned, swappable resource: a :class:`ModelRegistry` owns
one :class:`_Entry` per model family (the module it was registered with,
its config and a version history), and the runner resolves ``(model_id,
version)`` through it on every batch.  A version's params are a
``state_dict`` of CPU tensors: :func:`as_state_dict` takes the port's
checkpoint tree (its ``model`` entry), a ``state_dict``, or a Flax-layout
tree of numpy arrays (the JAX package's params, through
``utils/bridge.py``).

Each :class:`ModelVersion` moves through one state machine::

    LOADING ──restore_tree──▶ VERIFYING ──manifest gate ok──▶ WARMING
                                                                 │
       RETIRED ◀──superseded by a later swap── LIVE ◀──warm rungs ok,
          ▲                                     │      commit between
          │                                     │      batches
          └── verify/warm/canary failure, ──────┘
              cancel, or rollback (params
              reference dropped)

A :class:`SwapController` runs one swap on a background thread, off the
predict path:

1. **LOADING**: :func:`~mx_rcnn_tpu_torch.core.checkpoint.restore_tree`
   restores the checkpoint on the host.
2. **VERIFYING**: :func:`~mx_rcnn_tpu_torch.core.checkpoint.verify_manifest`
   (manifest present, file sizes intact, tree checksum equal to the
   recorded one), plus a structure check against the LIVE version: a
   ``state_dict`` with other names, shapes or dtypes would not fit the
   slots' modules, so it is rejected here.
3. **WARMING**: ``target.warm_version(...)`` copies the candidate to the
   device beside the live weights and drives it through every bucket the
   target serves (``torch.func.functional_call``: the same modules, the
   same rungs, zero new signatures); the staged copy is parked for the
   commit.
4. **commit**: the registry's live pointer flips; every runner sees the
   flip at its next batch and copies the staged weights into its slot's
   module in place, under the slot lock, on the stream the forwards use,
   so a forward already dispatched reads the old weights and the next
   one the new (a request is served entirely by one version).
5. **canary**: one probe batch through the live path; a failure rolls
   the live pointer back to the previous version and retires the
   candidate.

Failures at any stage (including the ``MX_RCNN_FAULTS`` injectors
``swap_verify_fail`` / ``swap_warm_fail`` / ``canary_fail``) retire the
candidate, release its params and surface :class:`SwapRolledBack` on the
controller's future; the previous LIVE version keeps serving throughout.
``ServingEngine.stop`` calls :meth:`ModelRegistry.cancel_swaps` first, so
an in-flight swap cancels cleanly: the abort hook raises between warm
rungs, before any further device copy.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import torch

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock
from mx_rcnn_tpu_torch.core.checkpoint import restore_tree, verify_manifest
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.bridge import flax_state_dict, state_dict_to_flax

logger = logging.getLogger(__name__)

#: model id used when a runner is built legacy-style (model+params in the
#: constructor) and for requests that carry no model id
DEFAULT_MODEL = "default"

#: ring-buffer bound on each version's transition log — long-running
#: rollout soaks cycle candidates through VERIFYING repeatedly, and an
#: unbounded audit trail is a slow leak under a fleet's uptime
TRANSITION_LOG_MAX = 64


class RegistryError(RuntimeError):
    """Invalid registry operation (duplicate registration, no live
    version, …)."""


class UnknownModel(KeyError):
    """A request or swap referenced a model id nobody registered."""


class UnknownVersion(KeyError):
    """A request named a model version that is neither live nor staged —
    a rollout arm already rolled back, or a version never warmed on this
    target."""


class SwapError(RuntimeError):
    """A swap failed outright (bad structure, no capacity, …)."""


class SwapInProgress(SwapError):
    """At most one in-flight swap per model: a second ``swap`` on the
    same model while one is running is an operator error, not a queue."""


class SwapCancelled(SwapError):
    """The swap was cancelled (engine stop / operator) before commit —
    the previous LIVE version was never at risk."""


class SwapRolledBack(SwapError):
    """The swap failed at a gate and the previous LIVE version is (still
    or again) serving.  ``stage`` says where: "verify" and "warm" fail
    before commit (the candidate never served a request); "canary" fails
    after commit and the live pointer was rolled back between batches."""

    def __init__(self, stage: str, cause: BaseException):
        super().__init__(f"swap rolled back at {stage} stage: {cause!r}")
        self.stage = stage
        self.cause = cause


class VersionState(enum.Enum):
    LOADING = "loading"
    VERIFYING = "verifying"
    WARMING = "warming"
    LIVE = "live"
    RETIRED = "retired"


class ModelVersion:
    """One immutable-params version of one model family."""

    def __init__(
        self,
        model_id: str,
        version: int,
        params: Any = None,
        digest: Optional[str] = None,
        source: str = "init",
        state: VersionState = VersionState.LOADING,
    ):
        self.model_id = model_id
        self.version = int(version)
        self.params = params
        self.digest = digest
        self.source = source
        self.state = state
        self.transitions: List[Dict[str, Any]] = []
        self.transitions_dropped = 0
        self._t0 = time.monotonic()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "model": self.model_id,
            "version": self.version,
            "state": self.state.value,
            "source": self.source,
            "digest": (self.digest[:12] if self.digest else None),
            "released": self.params is None,
            "transitions": list(self.transitions),
            "transitions_dropped": self.transitions_dropped,
        }


class _Entry:
    """Registry row for one model family: the module it was registered with,
    its config, the version history with a live pointer, and the
    family's default SLO lane (requests without an explicit lane tag
    inherit it — an interactive-tier model taints its traffic)."""

    def __init__(self, model_id: str, model: Any, cfg: Any,
                 slo_class: str = "bulk",
                 limits: Optional[Dict[str, Any]] = None):
        self.model_id = model_id
        self.model = model
        self.cfg = cfg
        self.slo_class = slo_class
        self.limits = dict(limits or {})
        self.versions: List[ModelVersion] = []
        self.live: Optional[ModelVersion] = None
        self.next_version = 1


class ModelRegistry:
    """Owner of every model family's versioned, swappable params."""

    def __init__(self):
        self._lock = make_lock("ModelRegistry._lock", rlock=True)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._swaps: Dict[str, "SwapController"] = {}
        self._swap_ordinal = 0
        # lifecycle counters (merged into pool/engine snapshots)
        self.swaps_started = 0
        self.swaps_completed = 0
        self.swaps_rolled_back = 0
        self.swaps_cancelled = 0
        self.versions_released = 0
        # live-pointer-moved listeners (response-cache invalidation):
        # called OUTSIDE the registry lock — listeners take their own
        # leaf locks and must never re-enter the registry
        self._live_listeners: List[Any] = []
        # int8 rung (core/quantize.py): per-(model, version) quantized
        # trees, computed once at registry load/restore and shared by
        # every runner/replica serving that version — scales are folded
        # HERE, never per slot and never on the predict path.  Families
        # in _quantize_on_load get their candidate versions quantized on
        # the swap restore path, before the commit flip.
        self._quantized: Dict[Any, Any] = {}
        self._quantize_on_load: set = set()

    # ----------------------------------------------------------- versions
    def _transition(
        self, ver: ModelVersion, state: VersionState, reason: str
    ) -> None:
        with self._lock:
            old = ver.state
            ver.state = state
            ver.transitions.append(
                {
                    "t": round(time.monotonic() - ver._t0, 4),
                    "from": old.value,
                    "to": state.value,
                    "reason": reason,
                }
            )
            while len(ver.transitions) > TRANSITION_LOG_MAX:
                ver.transitions.pop(0)
                ver.transitions_dropped += 1
        logger.info(
            "model %s v%d: %s -> %s (%s)",
            ver.model_id, ver.version, old.value, state.value, reason,
        )

    def _retire(self, ver: ModelVersion, reason: str) -> None:
        """Terminal: drop the params reference so the host tree (and,
        once every runner has synced past it, the device copy staged from
        it) becomes collectible."""
        with self._lock:
            if ver.state is VersionState.RETIRED:
                return
            self._transition(ver, VersionState.RETIRED, reason)
            if ver.params is not None:
                ver.params = None
                self.versions_released += 1
            self._quantized.pop((ver.model_id, ver.version), None)

    # ------------------------------------------------------------- models
    def register(
        self,
        model_id: str,
        model: Any,
        cfg: Any,
        params: Any,
        digest: Optional[str] = None,
        source: str = "init",
        slo_class: str = "bulk",
        limits: Optional[Dict[str, Any]] = None,
    ) -> ModelVersion:
        """Add a model family with its v1 params (already loaded and
        trusted by the caller — the CLI verifies checkpoint sources
        before registering; any form :func:`as_state_dict` takes).
        ``model`` is the family's module: runners build each slot's own
        module of its class.  v1 goes straight to LIVE; later versions
        arrive only through :meth:`swap` and walk the full gate.
        ``slo_class`` ("interactive" | "bulk") is the lane requests for
        this family default into when they carry no lane of their own."""
        from mx_rcnn_tpu_torch.serve.batcher import LANES

        if slo_class not in LANES:
            raise RegistryError(
                f"slo_class must be one of {LANES}, got {slo_class!r}"
            )
        with self._lock:
            if model_id in self._entries:
                raise RegistryError(f"model {model_id!r} already registered")
            e = _Entry(model_id, model, cfg, slo_class=slo_class,
                       limits=limits)
            v = ModelVersion(
                model_id, e.next_version, params=as_state_dict(params, model),
                digest=digest,
                source=source, state=VersionState.LOADING,
            )
            e.next_version += 1
            self._transition(v, VersionState.LIVE, "register")
            e.versions.append(v)
            e.live = v
            self._entries[model_id] = e
            return v

    def has(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._entries

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    @property
    def default_model(self) -> str:
        """First-registered model — what a model-less request resolves
        to."""
        with self._lock:
            if not self._entries:
                raise RegistryError("registry is empty")
            return next(iter(self._entries))

    def entry(self, model_id: Optional[str] = None) -> _Entry:
        with self._lock:
            mid = self.default_model if model_id is None else model_id
            e = self._entries.get(mid)
            if e is None:
                raise UnknownModel(mid)
            return e

    def live(self, model_id: Optional[str] = None) -> ModelVersion:
        """The version currently serving ``model_id`` — the single
        pointer every runner compares against on each batch."""
        with self._lock:
            e = self.entry(model_id)
            if e.live is None:
                raise RegistryError(f"model {e.model_id!r} has no live version")
            return e.live

    def slo_class(self, model_id: Optional[str] = None) -> str:
        """The lane a request for ``model_id`` defaults into when it
        carries no explicit lane tag (the engine consults this on
        submit)."""
        with self._lock:
            return self.entry(model_id).slo_class

    def limits(self, model_id: Optional[str] = None) -> Dict[str, Any]:
        """Per-model admission bounds (``max_side`` / ``max_pixels``)
        for the engine's validation gate; empty dict means the
        ``serve.quarantine`` defaults apply."""
        with self._lock:
            return dict(self.entry(model_id).limits)

    # ------------------------------------------------ int8 weight rung
    def enable_quantization(self, model_id: Optional[str] = None) -> None:
        """Mark a family for the int8 rung: its live version is
        quantized now (registry-load fold) and every future swap
        candidate is quantized on the restore path, so the commit flip
        and the runners' ``_sync`` never pay the fold."""
        with self._lock:
            mid = self.default_model if model_id is None else model_id
            if mid not in self._entries:
                raise UnknownModel(mid)
            self._quantize_on_load.add(mid)
        self.quantized_tree(mid)

    def quantized_tree(
        self, model_id: Optional[str] = None, version: Optional[int] = None
    ) -> Any:
        """The per-channel int8 quantized form of a version's params
        (live version when ``version`` is None), in the Flax layout
        (``core/quantize.py``), computed once and cached per ``(model,
        version)``; dropped at retire alongside the f32 tree.  The
        quantized tree's structure is a pure function of the f32
        structure, so the swap-time f32 structure gate stays the one
        authority."""
        from mx_rcnn_tpu_torch.core.quantize import quantize_tree

        with self._lock:
            ver = (
                self.live(model_id)
                if version is None
                else self._version(model_id, version)
            )
            key = (ver.model_id, ver.version)
            cached = self._quantized.get(key)
            if cached is not None:
                return cached
            params = ver.params
            if params is None:
                raise RegistryError(
                    f"model {ver.model_id!r} v{ver.version} params released — "
                    f"cannot quantize a retired version"
                )
        # fold outside the lock: pure host numpy over a tree we hold a
        # reference to; racing computations produce identical content
        qtree = quantize_tree(state_dict_to_flax(params))
        with self._lock:
            return self._quantized.setdefault(key, qtree)

    def _version(self, model_id: Optional[str], version: int) -> ModelVersion:
        with self._lock:
            e = self.entry(model_id)
            for v in e.versions:
                if v.version == int(version):
                    return v
            raise UnknownVersion(f"{e.model_id} v{version}")

    # --------------------------------------------- live-change listeners
    def subscribe_live(self, callback: Any) -> None:
        """Register ``callback(model_id)`` to fire whenever a model's
        live pointer moves — swap commit, canary rollback, or cancel
        rollback.  The serving engine wires its response cache's
        ``invalidate_model`` here, so a hot-swap can never leave cached
        responses from a superseded version behind."""
        with self._lock:
            self._live_listeners.append(callback)

    def _notify_live(self, model_id: str) -> None:
        """Fan the live-pointer movement out to listeners.  Called
        OUTSIDE the registry lock (listeners take their own leaf locks);
        a listener error is logged, never propagated — invalidation is
        hygiene, not a swap gate."""
        with self._lock:
            listeners = list(self._live_listeners)
        for cb in listeners:
            try:
                cb(model_id)
            except Exception:  # noqa: BLE001 — hygiene, not a gate
                logger.exception("live-change listener failed for %s", model_id)

    # -------------------------------------------------------------- swaps
    def swap(
        self,
        model_id: str,
        checkpoint: str,
        target: Any,
        block: bool = False,
        timeout: Optional[float] = None,
    ) -> Any:
        """Launch a background load→verify→warm→commit→canary swap of
        ``model_id`` to ``checkpoint`` on ``target`` (a ServeRunner —
        anything with ``warm_version``/``canary``).
        Returns the :class:`SwapController` (or, with ``block=True``,
        its result — raising :class:`SwapRolledBack` etc. inline)."""
        with self._lock:
            e = self.entry(model_id)
            prev = self._swaps.get(e.model_id)
            if prev is not None and not prev.done():
                raise SwapInProgress(
                    f"model {e.model_id!r} already has a swap in flight"
                )
            self._swap_ordinal += 1
            self.swaps_started += 1
            ctrl = SwapController(
                self, e, checkpoint, target, ordinal=self._swap_ordinal
            )
            self._swaps[e.model_id] = ctrl
        ctrl.start()
        if block:
            return ctrl.result(timeout)
        return ctrl

    def swaps_in_flight(self) -> int:
        with self._lock:
            return sum(1 for c in self._swaps.values() if not c.done())

    def cancel_swaps(self, wait: bool = True) -> int:
        """Cancel every in-flight swap; with ``wait`` (the engine-stop
        interlock) block until the controller threads have exited — no
        orphaned warmup thread survives, and no device copy runs after
        this returns.  Returns how many were still in flight."""
        with self._lock:
            ctrls = [c for c in self._swaps.values() if not c.done()]
        for c in ctrls:
            c.cancel()
        if wait:
            for c in ctrls:
                c.join()
        return len(ctrls)

    # ------------------------------------------------------ observability
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            models = {
                mid: {
                    "live_version": e.live.version if e.live else None,
                    "slo_class": e.slo_class,
                    "versions": [v.snapshot() for v in e.versions],
                    "swap_in_flight": (
                        mid in self._swaps and not self._swaps[mid].done()
                    ),
                }
                for mid, e in self._entries.items()
            }
            return {
                "models": models,
                "swaps": {
                    "started": self.swaps_started,
                    "completed": self.swaps_completed,
                    "rolled_back": self.swaps_rolled_back,
                    "cancelled": self.swaps_cancelled,
                    "in_flight": sum(
                        1 for c in self._swaps.values() if not c.done()
                    ),
                },
                "versions_released": self.versions_released,
            }


def as_state_dict(tree: Any, model: Any) -> Dict[str, torch.Tensor]:
    """A version's params as a ``state_dict`` of CPU tensors: the port's
    checkpoint tree (``core/checkpoint.py``: its ``model`` entry), a tree
    under ``params``, a ``state_dict``, or a Flax-layout tree of numpy
    arrays carried across by ``utils/bridge.py`` against ``model``'s
    tensor names and shapes."""
    if isinstance(tree, dict) and isinstance(tree.get("model"), dict):
        tree = tree["model"]
    elif isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        return {k: v.detach().cpu() for k, v in tree.items()}
    return flax_state_dict(tree, model.state_dict())


def _tree_signature(state: Dict[str, torch.Tensor]) -> List:
    """(name, shape, dtype) per tensor: the structure a swap must keep so
    the slots' modules take the new version as it is."""
    return [(k, tuple(v.shape), str(v.dtype)) for k, v in sorted(state.items())]


class SwapController:
    """One background swap: a thread walking the candidate version
    through the LOADING→VERIFYING→WARMING→LIVE gauntlet with rollback.

    ``future`` resolves exactly once: a result dict on success, or
    :class:`SwapRolledBack` / :class:`SwapCancelled` / :class:`SwapError`.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        entry: _Entry,
        checkpoint: str,
        target: Any,
        ordinal: int,
    ):
        self.registry = registry
        self.entry = entry
        self.checkpoint = checkpoint
        self.target = target
        self.ordinal = int(ordinal)
        self.future: "Future" = Future()
        self._cancel = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"swap-{entry.model_id}-{ordinal}",
            daemon=True,
        )

    # ----------------------------------------------------------- control
    def start(self) -> "SwapController":
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._cancel.set()

    def done(self) -> bool:
        return self.future.done()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    def _abort_check(self) -> None:
        """Passed into ``target.warm_version`` and called between stages:
        raising here (instead of polling a flag at the call sites) means
        a cancelled swap stops BEFORE its next device copy, which is the
        engine-stop interlock's contract."""
        if self._cancel.is_set():
            raise SwapCancelled(
                f"swap #{self.ordinal} of model {self.entry.model_id!r} "
                f"cancelled"
            )

    # ------------------------------------------------------------- stages
    def _run(self) -> None:
        reg, e = self.registry, self.entry
        ver: Optional[ModelVersion] = None
        stage = "load"
        try:
            old = reg.live(e.model_id)
            with reg._lock:
                ver = ModelVersion(
                    e.model_id, e.next_version, source=str(self.checkpoint),
                )
                e.next_version += 1
                e.versions.append(ver)
            self._abort_check()

            # LOADING: host-side restore, nothing on device
            tree = restore_tree(self.checkpoint)
            self._abort_check()

            # VERIFYING: shared manifest gate + structure-vs-live check
            stage = "verify"
            reg._transition(ver, VersionState.VERIFYING, "loaded")
            man = verify_manifest(self.checkpoint, tree=tree)
            faults.swap_fault("verify", self.ordinal)
            params = as_state_dict(tree, e.model)
            got, want = _tree_signature(params), _tree_signature(old.params)
            if got != want:
                raise SwapError(
                    f"checkpoint tree structure does not match live "
                    f"v{old.version} ({len(got)} vs {len(want)} tensors or "
                    f"mismatched shapes/dtypes) — a swap must not change "
                    f"the serving modules"
                )
            ver.params = params
            ver.digest = man.get("checksum")
            # int8 rung: fold the candidate's per-channel scales on the
            # restore path (off the serve path) so runners adopting the
            # new version after the commit flip find the quantized tree
            # already cached
            if e.model_id in reg._quantize_on_load:
                reg.quantized_tree(e.model_id, ver.version)
            self._abort_check()

            # WARMING: candidate params through every served signature,
            # off the live path (functional_call: zero new signatures)
            stage = "warm"
            reg._transition(ver, VersionState.WARMING, "verified")
            warmed = self.target.warm_version(
                e.model_id, ver.version, params, abort=self._abort_check
            )
            faults.swap_fault("warm", self.ordinal)
            self._abort_check()

            # commit: flip the live pointer; runners swap between batches
            with reg._lock:
                self._abort_check()
                reg._transition(ver, VersionState.LIVE, "swap commit")
                e.live = ver
            reg._notify_live(e.model_id)  # cached v(old) responses: out

            # canary: live-path probes; failure rolls the pointer back
            stage = "canary"
            try:
                probed = self.target.canary(e.model_id)
                faults.swap_fault("canary", self.ordinal)
            except Exception as ce:
                with reg._lock:
                    e.live = old
                reg._notify_live(e.model_id)
                reg._retire(ver, f"canary failed — rolled back: {ce!r}")
                self._discard(ver)
                with reg._lock:
                    reg.swaps_rolled_back += 1
                raise SwapRolledBack("canary", ce) from ce

            reg._retire(old, f"superseded by v{ver.version}")
            with reg._lock:
                reg.swaps_completed += 1
            self.future.set_result(
                {
                    "model": e.model_id,
                    "version": ver.version,
                    "previous": old.version,
                    "warmed": warmed,
                    "canary_probes": probed,
                    "digest": ver.digest,
                }
            )
        except SwapCancelled as exc:
            if ver is not None:
                self._rollback_uncommitted(ver, old, "cancelled")
                self._discard(ver)
            with reg._lock:
                reg.swaps_cancelled += 1
            self.future.set_exception(exc)
        except SwapRolledBack as exc:
            self.future.set_exception(exc)
        except Exception as exc:  # noqa: BLE001 — every gate failure rolls back
            if ver is not None:
                self._rollback_uncommitted(ver, old, f"{stage} failed: {exc!r}")
                self._discard(ver)
            with reg._lock:
                reg.swaps_rolled_back += 1
            self.future.set_exception(SwapRolledBack(stage, exc))

    def _rollback_uncommitted(
        self, ver: ModelVersion, old: ModelVersion, reason: str
    ) -> None:
        """Retire a candidate that failed before (or during) commit; if
        the live pointer already moved to it, point back at ``old``."""
        reg = self.registry
        moved = False
        with reg._lock:
            if self.entry.live is ver:
                self.entry.live = old
                moved = True
        if moved:
            reg._notify_live(self.entry.model_id)
        reg._retire(ver, reason)

    def _discard(self, ver: ModelVersion) -> None:
        """Drop any device-staged buffers the target parked for this
        version (best-effort: a fake target in tests may not stage)."""
        discard = getattr(self.target, "discard_version", None)
        if discard is not None:
            try:
                discard(ver.model_id, ver.version)
            except Exception:  # noqa: BLE001 — discard is cleanup, not a gate
                logger.exception(
                    "discard_version(%s, %d) failed", ver.model_id, ver.version
                )
