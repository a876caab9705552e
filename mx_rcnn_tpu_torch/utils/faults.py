"""Deterministic fault injection for the training loop (port of the train
kinds of ``mx_rcnn_tpu/utils/faults.py``).

Every injector is driven by the ``MX_RCNN_FAULTS`` environment variable and
keyed on deterministic run coordinates (guarded step index, roidb record
index, save-call ordinal), never on wall clock or an RNG, so a replayed run injects the same
faults at the same points.

Spec grammar, the JAX package's: comma-separated entries
``KIND@KEY[xTIMES][:ARG]``::

    nan_loss@STEP          NaN the observed loss at guarded step STEP
                           (every attempt: a poison batch)
    spike@STEP[xN][:F]     multiply the loss by F (default 1e4) at STEP;
                           xN bounds how many attempts fire (x1 = a
                           transient spike that a retry survives)
    record_fail@IDX[xN]    raise IOError loading roidb record IDX
                           (unbounded = permanently corrupt record)
    save_crash@NCALL       raise SimulatedCrash inside the NCALLth
                           save_checkpoint (1-based), after the data is
                           written but before the atomic commit: the
                           "killed mid-save" torn state
    stall@STEP:SECONDS     sleep SECONDS at guarded step STEP (drives the
                           step past the watchdog deadline)

Swap-phase injectors are keyed by the registry-wide swap ordinal (1-based:
the Nth ``SwapController`` the registry launches, any model), or ``*`` for
every swap.  Each fires at its stage of ``serve/registry.py``'s controller
and raises :class:`InjectedSwapFault`, driving the rollback path::

    swap_verify_fail@N     fail swap N's manifest-verification stage
    swap_warm_fail@N       fail swap N after its warmup rungs ran
    canary_fail@N          fail swap N's post-commit canary probe (the
                           committed version rolls back between batches)

The JAX package's other kinds (replica, poison and device faults) belong to paths the port does not have: a spec naming one raises
``NotImplementedError``, and a kind neither package knows raises
``ValueError``, so no entry is ignored.  Injection sites cost one
environment lookup when the variable is unset.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

ENV_VAR = "MX_RCNN_FAULTS"


class InjectedFault(IOError):
    """Raised by the record-load injector (an IOError, so the loader's retry
    treats it exactly like a disk or decode failure)."""


class SimulatedCrash(RuntimeError):
    """Raised by the save injector: stands in for SIGKILL mid-save (the
    writer cannot clean up, the ``.tmp`` dir is left uncommitted)."""


class InjectedSwapFault(RuntimeError):
    """Raised by the swap-phase injector inside a ``SwapController`` stage:
    a RuntimeError, so the controller rolls back exactly as on a real
    verification, warmup or canary failure."""


# swap-phase kinds, keyed by the 1-based registry-wide swap ordinal
_SWAP_KINDS = {
    "verify": "swap_verify_fail",
    "warm": "swap_warm_fail",
    "canary": "canary_fail",
}

_PORTED_KINDS = frozenset({"nan_loss", "spike", "record_fail", "save_crash", "stall"}
                          | set(_SWAP_KINDS.values()))

# the JAX package's kinds whose injection sites the port does not have yet
_UNPORTED_KINDS = frozenset({
    "predict_fail", "predict_stall", "replica_wedge",
    "poison_fail", "poison_stall", "poison_wedge",
    "device_lost", "device_wedge",
})

_DEFAULT_ARG = {"spike": 1e4, "stall": 5.0}


@dataclass
class _Fault:
    kind: str
    key: Optional[int]  # None: every key (``*``, the swap kinds)
    times: Optional[int]  # None = unbounded
    arg: float
    fired: int = 0

    def fire(self) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


@dataclass
class _Registry:
    spec: str
    faults: List[_Fault] = field(default_factory=list)
    save_calls: int = 0


_registry: Optional[_Registry] = None


def _parse(spec: str) -> List[_Fault]:
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, rest = entry.partition("@")
        if kind in _UNPORTED_KINDS:
            raise NotImplementedError(
                f"MX_RCNN_FAULTS: injector kind {kind!r} (entry {entry!r}) belongs to a path "
                f"the port does not have; ported kinds: {', '.join(sorted(_PORTED_KINDS))}"
            )
        if kind not in _PORTED_KINDS:
            raise ValueError(
                f"MX_RCNN_FAULTS: unknown injector kind {kind!r} in entry {entry!r}; "
                f"known kinds: {', '.join(sorted(_PORTED_KINDS | _UNPORTED_KINDS))}"
            )
        arg_s = None
        if ":" in rest:
            rest, _, arg_s = rest.partition(":")
        times: Optional[int] = None
        if "x" in rest:
            rest, _, times_s = rest.partition("x")
            times = int(times_s)
        out.append(_Fault(
            kind=kind, key=None if rest == "*" else int(rest), times=times,
            arg=float(arg_s) if arg_s is not None else _DEFAULT_ARG.get(kind, 0.0),
        ))
    return out


def _active() -> Optional[_Registry]:
    """Parse-once registry, parsed again (with fresh fire counts) whenever
    the variable's value changes."""
    global _registry
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        _registry = None
        return None
    if _registry is None or _registry.spec != spec:
        _registry = _Registry(spec=spec, faults=_parse(spec))
    return _registry


def reset() -> None:
    """Forget fire counts (runs that reuse an identical spec string)."""
    global _registry
    _registry = None


def corrupt_loss(step: int, loss: float) -> float:
    """The guarded loop's observed-loss hook: NaN or spike injection."""
    reg = _active()
    if reg is None:
        return loss
    for f in reg.faults:
        if f.key != step:
            continue
        if f.kind == "nan_loss" and f.fire():
            return float("nan")
        if f.kind == "spike" and f.fire():
            return loss * f.arg if loss else f.arg
    return loss


def fail_record(index: int) -> None:
    """The loader's hook: raise for a corrupt or missing record."""
    reg = _active()
    if reg is None:
        return
    for f in reg.faults:
        if f.kind == "record_fail" and f.key == index and f.fire():
            raise InjectedFault(f"injected read failure for record {index}")


def crash_save() -> None:
    """The checkpoint hook, called once per ``save_checkpoint`` after the
    data write and before the atomic commit."""
    reg = _active()
    if reg is None:
        return
    reg.save_calls += 1
    for f in reg.faults:
        if f.kind == "save_crash" and f.key == reg.save_calls and f.fire():
            raise SimulatedCrash(
                f"injected crash during save #{reg.save_calls} (uncommitted .tmp left behind)"
            )


def stall(step: int) -> None:
    """The guarded loop's hook: wedge this step (watchdog exercise)."""
    reg = _active()
    if reg is None:
        return
    for f in reg.faults:
        if f.kind == "stall" and f.key == step and f.fire():
            time.sleep(f.arg)


def swap_fault(stage: str, ordinal: int) -> None:
    """The swap controller's hook (``serve/registry.py``): fail this swap's
    ``stage`` ("verify" | "warm" | "canary"), called once per swap per
    stage with the registry-wide 1-based swap ordinal."""
    reg = _active()
    if reg is None:
        return
    kind = _SWAP_KINDS[stage]
    for f in reg.faults:
        if f.kind != kind:
            continue
        if f.key is not None and f.key != ordinal:
            continue
        if f.fire():
            raise InjectedSwapFault(f"injected {kind}: swap #{ordinal} ({stage} stage)")
