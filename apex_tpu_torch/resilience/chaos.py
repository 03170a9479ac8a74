"""Deterministic fault injection — the test double for everything that can
go wrong in a long training run.

A *fault* names an injection site, the steps (or a seeded per-step
probability) at which it fires, and a mode (what failure to fake).  The
schedule is a pure function of ``(seed, site, mode, step)`` — a SHA-256
coin, not ``random`` — so every host of a multi-process job, and every
re-execution of a test, injects the exact same faults.

Sites and their modes (the **registered-site registry** — a spec
clause naming a site or mode outside it raises at parse time, so a
typo'd drill can never silently inject nothing and "pass"):

========================  ==========================================
``GRADS``                 ``nan`` / ``inf`` poison a gradient pytree
``CHECKPOINT_SAVE``       ``raise`` / ``partial`` (debris then raise)
``CHECKPOINT_RESTORE``    ``raise``
``COLLECTIVE``            ``raise`` / ``stall``
``RENDEZVOUS``            ``raise`` / ``stall``
``PREEMPTION``            SIGTERM to the current process
``SERVE_PREFILL``         ``raise`` / ``stall`` / ``nan`` (poison)
``SERVE_DECODE``          ``raise`` / ``stall`` / ``nan`` / ``inf``
``SERVE_ADMISSION``       ``raise`` / ``stall``
``SERVE_KV_ALLOC``        ``fail`` (forced alloc failure) / ``raise``
``SERVE_PREFIX_EVICT``    ``force`` (forced prefix-cache eviction)
``SERVE_DRAFT``           ``raise`` / ``stall`` / ``nan`` (poison)
========================  ==========================================

The ``serve.*`` sites live in the serving path
(the reference's ``serve/engine.py`` / ``serve/scheduler.py``), so
ONE ``APEX_TPU_CHAOS`` spec drives training and serving drills through
the same parser, coin, and hit accounting.  Subsystems can extend the
registry with :func:`register_site`.

Activation is explicit (:func:`configure` / the :func:`inject` context
manager, used by tests) or ambient via ``APEX_TPU_CHAOS`` for real runs::

    APEX_TPU_CHAOS="grads:nan@3,7;checkpoint_save:raise@5;preemption@12"
    APEX_TPU_CHAOS="grads:nan:p=0.001;seed=42"

Hooks are host-side and fire only where training code calls them
(the port's call sites: ``runner``, ``retry``, the serving engine and
scheduler, the guards, and ``fleetctl``'s fleet and router);
with no faults configured every hook is a cheap no-op.

Counterpart of ``apex_tpu/resilience/chaos.py``, host code copied over:
the same registry, spec grammar and SHA-256 coin, so one
``APEX_TPU_CHAOS`` spec and seed give the same fault schedule in both
packages.  :func:`corrupt_tree` poisons a tree of tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "GRADS",
    "CHECKPOINT_SAVE",
    "CHECKPOINT_RESTORE",
    "COLLECTIVE",
    "RENDEZVOUS",
    "PREEMPTION",
    "SERVE_PREFILL",
    "SERVE_DECODE",
    "SERVE_ADMISSION",
    "SERVE_KV_ALLOC",
    "SERVE_PREFIX_EVICT",
    "SERVE_DRAFT",
    "FLEET_REPLICA_CRASH",
    "FLEET_PREEMPT",
    "FLEET_ROUTER",
    "Fault",
    "InjectedFault",
    "register_site",
    "registered_sites",
    "site_modes",
    "configure",
    "clear",
    "inject",
    "faults",
    "active",
    "parse_spec",
    "corrupt_tree",
    "maybe_fail",
    "maybe_stall",
    "maybe_preempt",
]

GRADS = "grads"
CHECKPOINT_SAVE = "checkpoint_save"
CHECKPOINT_RESTORE = "checkpoint_restore"
COLLECTIVE = "collective"
RENDEZVOUS = "rendezvous"
PREEMPTION = "preemption"
#: serving-path sites (docs/serving.md "Failure semantics"): hooks
#: live in the reference's serve/engine.py (prefill/decode) and
#: scheduler.py (admission / page allocation)
SERVE_PREFILL = "serve.prefill"
SERVE_DECODE = "serve.decode"
SERVE_ADMISSION = "serve.admission"
SERVE_KV_ALLOC = "serve.kv_alloc"
#: forces a full prefix-cache eviction sweep at a scheduler step (the
#: drill proving eviction under pressure never corrupts a borrowed
#: stream — borrowed pages are refcount-pinned and survive the sweep)
SERVE_PREFIX_EVICT = "serve.prefix_evict"
#: faults the speculative draft-decode program (docs/serving.md
#: "Speculative decoding"): ``raise`` makes the scheduler fall back to
#: plain decode for the round, ``nan`` poisons the draft proposals —
#: the verify step rejects every poisoned token, so a faulted draft
#: can slow a stream but NEVER corrupt it.  Indices are spec rounds.
SERVE_DRAFT = "serve.draft"
#: fleet-control-plane sites (docs/serving.md "Fleet operations"):
#: hooks live in ``fleetctl`` — ``fleet.replica_crash`` kills a
#: replica mid-iteration (its live requests evacuate under the shared
#: retry budget), ``fleet.preempt`` delivers a SIGTERM-style preempt
#: notice (drain + migrate), ``fleet.router`` faults one routing
#: attempt (the request stays at the fleet door and re-routes next
#: tick).  Indices are fleet ticks.
FLEET_REPLICA_CRASH = "fleet.replica_crash"
FLEET_PREEMPT = "fleet.preempt"
FLEET_ROUTER = "fleet.router"

#: site -> (allowed modes, default mode).  parse_spec and Fault both
#: validate against this registry: an unknown site OR an unknown mode
#: raises instead of building a fault that never fires.
_SITE_REGISTRY: Dict[str, Tuple[Tuple[str, ...], str]] = {}


def register_site(
    site: str, modes: Tuple[str, ...], default_mode: Optional[str] = None,
) -> str:
    """Register an injection site and its legal modes (idempotent for
    an identical re-registration; conflicting modes raise).  Returns
    the site name so callers can do ``SITE = register_site(...)``."""
    if not site or not modes:
        raise ValueError("a chaos site needs a name and at least one mode")
    default_mode = default_mode or modes[0]
    if default_mode not in modes:
        raise ValueError(
            f"default mode {default_mode!r} not in modes {modes} "
            f"for site {site!r}"
        )
    spec = (tuple(modes), default_mode)
    prev = _SITE_REGISTRY.get(site)
    if prev is not None and prev != spec:
        raise ValueError(
            f"chaos site {site!r} already registered with modes "
            f"{prev[0]} (default {prev[1]!r})"
        )
    _SITE_REGISTRY[site] = spec
    return site


def registered_sites() -> Tuple[str, ...]:
    return tuple(_SITE_REGISTRY)


def site_modes(site: str) -> Tuple[str, ...]:
    """The legal modes of a registered site (KeyError on unknown)."""
    return _SITE_REGISTRY[site][0]


register_site(GRADS, ("nan", "inf"), "nan")
register_site(CHECKPOINT_SAVE, ("raise", "partial", "stall"), "raise")
register_site(CHECKPOINT_RESTORE, ("raise", "stall"), "raise")
register_site(COLLECTIVE, ("raise", "stall"), "raise")
register_site(RENDEZVOUS, ("raise", "stall"), "raise")
register_site(PREEMPTION, ("raise",), "raise")  # mode is vestigial
register_site(SERVE_PREFILL, ("raise", "stall", "nan"), "raise")
register_site(SERVE_DECODE, ("raise", "stall", "nan", "inf"), "raise")
register_site(SERVE_ADMISSION, ("raise", "stall"), "raise")
register_site(SERVE_KV_ALLOC, ("fail", "raise"), "fail")
register_site(SERVE_PREFIX_EVICT, ("force",), "force")
register_site(SERVE_DRAFT, ("raise", "stall", "nan"), "raise")
register_site(FLEET_REPLICA_CRASH, ("kill",), "kill")
register_site(FLEET_PREEMPT, ("notice",), "notice")
register_site(FLEET_ROUTER, ("raise",), "raise")


class InjectedFault(RuntimeError):
    """Raised by a chaos hook standing in for a real infrastructure error."""

    def __init__(self, site: str, step: int, mode: str):
        super().__init__(
            f"injected {mode!r} fault at site {site!r}, step {step}"
        )
        self.site = site
        self.step = step
        self.mode = mode


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection rule.

    ``steps`` wins over ``probability``; ``max_hits`` bounds how many times
    the rule fires over its lifetime (e.g. ``max_hits=1`` makes a save fail
    once and heal on retry).  ``stall_seconds`` applies to ``stall`` mode.
    """

    site: str
    steps: Tuple[int, ...] = ()
    probability: float = 0.0
    mode: str = "raise"
    max_hits: Optional[int] = None
    stall_seconds: float = 0.05

    def __post_init__(self):
        if self.site not in _SITE_REGISTRY:
            raise ValueError(
                f"unknown chaos site {self.site!r}; one of "
                f"{registered_sites()}"
            )
        modes = _SITE_REGISTRY[self.site][0]
        if self.mode not in modes:
            raise ValueError(
                f"unknown mode {self.mode!r} for chaos site "
                f"{self.site!r}; one of {modes}"
            )


_FAULTS: List[Fault] = []
_SEED: int = 0
_HITS: Dict[int, int] = {}  # id(index in _FAULTS) -> times fired
_ENV_LOADED = False


def configure(*new_faults: Fault, seed: int = 0) -> None:
    """Replace the active fault set (and reset hit counters)."""
    global _SEED
    _FAULTS[:] = list(new_faults)
    _SEED = seed
    _HITS.clear()


def clear() -> None:
    """Remove every active fault."""
    configure()


class inject:
    """Context manager: activate faults inside, restore the prior set after.

    >>> with chaos.inject(chaos.Fault(chaos.GRADS, steps=(3,), mode="nan")):
    ...     train()
    """

    def __init__(self, *new_faults: Fault, seed: int = 0):
        self._new = new_faults
        self._seed = seed

    def __enter__(self):
        self._prev = (list(_FAULTS), _SEED, dict(_HITS))
        configure(*self._new, seed=self._seed)
        return self

    def __exit__(self, *exc):
        prev_faults, prev_seed, prev_hits = self._prev
        configure(*prev_faults, seed=prev_seed)
        _HITS.update(prev_hits)


def _load_env() -> None:
    """One-shot pickup of ``APEX_TPU_CHAOS`` (real runs, no code changes)."""
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get("APEX_TPU_CHAOS")
    if spec and not _FAULTS:
        env_faults, seed = parse_spec(spec)
        configure(*env_faults, seed=seed)


def parse_spec(spec: str) -> Tuple[Tuple[Fault, ...], int]:
    """Parse an ``APEX_TPU_CHAOS`` spec string.

    ``;``-separated clauses of ``site[:mode][:p=0.01][:xN][@s1,s2]`` plus
    an optional ``seed=N`` clause (``xN`` bounds the fault to N firings —
    a transient that heals on retry).  Examples::

        grads:nan@3,7               # NaN grads at steps 3 and 7
        checkpoint_save:raise:x1@5  # ONE save IO error at step 5 (heals)
        preemption@12               # SIGTERM at step 12
        grads:inf:p=0.001           # seeded 0.1%-per-step Inf burst
        serve.decode:nan@9          # poisoned logits at decode iter 9

    Sites and modes are validated against the registered-site registry
    — an unknown site (``grdas:...``) or a typo'd token that would
    otherwise be swallowed as a bogus mode (``grads:nan:p0.001``)
    raises ``ValueError`` naming the clause, instead of yielding a
    fault that silently never fires while a chaos drill "passes".
    """
    out: List[Fault] = []
    seed = 0
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        if clause.startswith("seed="):
            seed = int(clause[len("seed=") :])
            continue
        steps: Tuple[int, ...] = ()
        probability = 0.0
        max_hits: Optional[int] = None
        raw = clause
        if "@" in clause:
            clause, _, steplist = clause.partition("@")
            steps = tuple(int(s) for s in steplist.split(",") if s)
        parts = clause.split(":")
        site, rest = parts[0], parts[1:]
        if site not in _SITE_REGISTRY:
            raise ValueError(
                f"unknown chaos site {site!r} in spec clause {raw!r}; "
                f"registered sites: {registered_sites()}"
            )
        modes, default_mode = _SITE_REGISTRY[site]
        mode = None
        for token in rest:
            if token.startswith("p="):
                probability = float(token[2:])
            elif token.startswith("x") and token[1:].isdigit():
                max_hits = int(token[1:])
            elif token in modes:
                mode = token
            else:
                raise ValueError(
                    f"unknown token {token!r} in spec clause {raw!r}: "
                    f"not a mode of site {site!r} {modes}, a "
                    f"probability (p=F), or a hit bound (xN)"
                )
        if mode is None:
            mode = default_mode
        out.append(
            Fault(
                site=site,
                steps=steps,
                probability=probability,
                mode=mode,
                max_hits=max_hits,
            )
        )
    return tuple(out), seed


def faults() -> Tuple[Fault, ...]:
    _load_env()
    return tuple(_FAULTS)


def _coin(site: str, mode: str, step: int, p: float) -> bool:
    digest = hashlib.sha256(
        f"{_SEED}:{site}:{mode}:{step}".encode()
    ).digest()
    frac = int.from_bytes(digest[:8], "big") / 2.0**64
    return frac < p


def active(site: str, step: int) -> Optional[Fault]:
    """The fault scheduled at ``(site, step)``, if any (counts the hit)."""
    _load_env()
    for i, f in enumerate(_FAULTS):
        if f.site != site:
            continue
        if f.max_hits is not None and _HITS.get(i, 0) >= f.max_hits:
            continue
        # steps wins over probability (the Fault contract): an explicit
        # schedule pins the fault to exactly those steps.
        if f.steps:
            hit = step in f.steps
        else:
            hit = f.probability > 0.0 and _coin(
                f.site, f.mode, step, f.probability
            )
        if hit:
            _HITS[i] = _HITS.get(i, 0) + 1
            return f
    return None


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------


def _leaves(tree):
    """Leaves depth first, dict keys sorted (the reference's pytree
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _replace_first(tree, new):
    """``tree`` with its first leaf (in :func:`_leaves`' order) replaced."""
    done = []

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return (type(node)(*out) if hasattr(node, "_fields")
                    else type(node)(out))
        if done:
            return node
        done.append(True)
        return new

    return walk(tree)


def corrupt_tree(tree, step: int, site: str = GRADS):
    """Return ``tree`` (dicts, lists and tuples of tensors) with its first
    leaf replaced by a tensor of NaN (``nan`` mode) or +inf when
    scheduled.  One leaf is enough to trip every downstream non-finite
    detector while keeping the rest of the pipeline realistic.  No-op
    when idle; the input is never modified."""
    fault = active(site, step)
    if fault is None:
        return tree
    leaves = _leaves(tree)
    if not leaves:
        return tree
    poison = float("nan") if fault.mode == "nan" else float("inf")
    return _replace_first(tree, torch.full_like(leaves[0], poison))


def maybe_fail(site: str, step: int, partial_dir=None) -> None:
    """Raise :class:`InjectedFault` when a ``raise``/``partial`` fault is
    scheduled at ``(site, step)``; stall (and return) in ``stall`` mode.

    ``partial`` mode first drops orbax-style uncommitted debris
    (``<step>.orbax-checkpoint-tmp-*``) under ``partial_dir`` — the
    on-disk shape of a host that died mid-write — then raises.
    """
    fault = active(site, step)
    if fault is None:
        return
    if fault.mode == "stall":
        time.sleep(fault.stall_seconds)
        return
    if fault.mode == "partial" and partial_dir is not None:
        debris = os.path.join(
            os.fspath(partial_dir),
            f"{step}.orbax-checkpoint-tmp-{os.getpid()}",
        )
        os.makedirs(debris, exist_ok=True)
        with open(os.path.join(debris, "params"), "w") as f:
            f.write("torn write\n")
    raise InjectedFault(site, step, fault.mode)


def maybe_stall(site: str, step: int) -> float:
    """Sleep when a ``stall`` fault is scheduled; returns seconds slept."""
    fault = active(site, step)
    if fault is not None and fault.mode == "stall":
        time.sleep(fault.stall_seconds)
        return fault.stall_seconds
    return 0.0


def maybe_preempt(step: int) -> bool:
    """Deliver SIGTERM to this process when a preemption is scheduled.

    Goes through the real signal machinery so the handler installed by
    :class:`apex_tpu_torch.resilience.runner.PreemptionHandler` is exercised
    exactly as a cloud preemption notice would exercise it.
    """
    if active(PREEMPTION, step) is None:
        return False
    os.kill(os.getpid(), signal.SIGTERM)
    return True
