"""Canary analysis for fleet deploys — fingerprints + drift verdicts.

Counterpart of ``apex_tpu/observability/canary.py``, host code copied
over; the fingerprint drives the port engine's ``probe_stream``.

A rolling deploy that ships regressed, corrupted, or miscompiled
weights rolls out fleet-wide with a clean verdict unless something
observes whether the *new weights* are any good.  This module is that
observer, in two independent halves:

**Golden-probe fingerprints** (bit-level identity).  A fixed seeded
probe-prompt set (:class:`GoldenProbeSet`) is run greedily through an
engine after every ``rebuild()``/redeploy and the token streams —
plus the prefill logits bytes, so even a corruption too small to flip
an argmax is visible — are hashed (blake2b) into a model fingerprint
(:func:`model_fingerprint`).  Same-weights rebuilds must match
bit-exactly (the supervised-recovery rebuild path gets this check for
free: rebuild determinism is already pinned by the serve stack);
an INTENTIONAL weight update records the old→new
:func:`fingerprint_distance` on the board instead of failing.  A
single-bit weight corruption flips the digest.

**Statistical drift verdicts** (distribution-level health).  The
:class:`CanaryAnalyzer` compares the canary replica's windowed metric
distributions (TTFT samples, per-slot decode progress, per-reason
terminal shed rates, poisoned-slot counts, speculative accept rate)
against the incumbent pool using nonparametric tests — a one-sided
Mann–Whitney U for continuous channels, a binomial tail against the
pooled incumbent rate for event channels — with a **min-sample
honesty floor**: below the floor a channel returns NO verdict (never
"pass"), the same cold-start honesty as
:class:`~apex_tpu_torch.observability.slo.BurnRateTracker`'s half-coverage
rule.  Verdicts land as
:class:`~apex_tpu_torch.observability.health.HealthEvent` s on the shared
timeline (``fleet_canary_*`` rules).

The fleet integration (:meth:`apex_tpu_torch.fleetctl.Fleet.
start_rolling_update` with a :class:`CanaryConfig`) makes the first
updated replica the canary, holds its router load share at
``canary_frac`` until the verdict passes, and on a failed verdict
halts the deploy, rebuilds the canary back to the incumbent weights,
and bumps ``fleet/deploys_rolled_back`` — bad-weight exposure is
provably bounded by the canary fraction (``apex_tpu_torch.tools.canary_drill``
re-proves the bound from the span dump).  See docs/serving.md
("Canary deploys") and docs/observability.md ("Canary analysis").
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "GoldenProbeSet",
    "model_fingerprint",
    "fingerprint_distance",
    "mann_whitney_p",
    "binom_tail",
    "CanaryVerdict",
    "CanaryAnalyzer",
    "CanaryConfig",
    "CanaryController",
]

#: shed reasons the drift analyzer treats as weight-health channels —
#: ``draining`` is deploy machinery (the canary itself drains twice on
#: a rollback) and would self-trigger; ``rerouted`` is a hop, not a
#: terminal, and never appears in ``scheduler.shed`` anyway
DRIFT_SHED_REASONS = (
    "deadline", "growth_victim", "pool_exhausted", "oversize",
    "poisoned", "queue_full", "retries_exhausted",
)


# ---------------------------------------------------------------------------
# golden-probe fingerprints
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GoldenProbeSet:
    """A fixed, seeded probe-prompt set — the model's identity quiz.

    The prompts are data, not randomness at probe time: two probes of
    the same weights ask the same questions, so the fingerprint is a
    pure function of the weights (+ the compiled programs, whose
    rebuild determinism the serve stack already pins).
    """

    prompts: Tuple[Tuple[int, ...], ...]
    max_new_tokens: int = 8

    @classmethod
    def generate(cls, vocab: int, *, n_probes: int = 4,
                 prompt_len: int = 8, max_new_tokens: int = 8,
                 seed: int = 0xCA9A) -> "GoldenProbeSet":
        """Deterministic probe prompts from a seed (no live RNG state:
        the set is reproducible from ``(vocab, n_probes, prompt_len,
        seed)`` alone)."""
        import numpy as np

        rs = np.random.RandomState(seed)
        prompts = tuple(
            tuple(int(t) for t in rs.randint(1, vocab, size=prompt_len))
            for _ in range(n_probes)
        )
        return cls(prompts=prompts, max_new_tokens=int(max_new_tokens))

    def total_tokens(self) -> int:
        return sum(len(p) for p in self.prompts) + \
            len(self.prompts) * self.max_new_tokens


def model_fingerprint(engine, probes: GoldenProbeSet) -> Dict[str, object]:
    """Run every probe greedily through ``engine`` and hash the token
    streams + prefill logits bytes (blake2b) into a fingerprint.

    The token streams alone would miss a corruption too small to flip
    any argmax; the prefill last-logits bytes make the digest
    sensitive to a SINGLE flipped weight bit.  Returns ``{"digest",
    "streams", "finite", "tokens"}`` — ``finite`` is False when any
    probe tripped the engine's in-step non-finite screen (NaN-poisoned
    weights fingerprint honestly instead of crashing the probe).
    """
    h = hashlib.blake2b(digest_size=16)
    streams: List[List[int]] = []
    finite = True
    for prompt in probes.prompts:
        toks, logits_bytes, ok = engine.probe_stream(
            list(prompt), probes.max_new_tokens
        )
        finite = finite and ok
        h.update(logits_bytes)
        h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                          for t in toks))
        h.update(b"\x00")  # probe separator
        streams.append(list(toks))
    return {
        "digest": h.hexdigest(),
        "streams": streams,
        "finite": finite,
        "tokens": sum(len(s) for s in streams),
    }


def fingerprint_distance(old: Dict[str, object],
                         new: Dict[str, object]) -> Dict[str, object]:
    """Token-level distance between two fingerprints: the fraction of
    stream positions that differ (0.0 = bit-exact, 1.0 = fully
    divergent), plus which probe/position diverged first — the number
    an INTENTIONAL weight update records on the board instead of
    failing the deploy."""
    if old["digest"] == new["digest"]:
        return {"distance": 0.0, "streams_differing": 0,
                "first_divergence": None, "match": True}
    total = differ = 0
    streams_differing = 0
    first: Optional[Tuple[int, int]] = None
    for pi, (a, b) in enumerate(zip(old["streams"], new["streams"])):
        stream_differs = False
        for ti in range(max(len(a), len(b))):
            total += 1
            ta = a[ti] if ti < len(a) else None
            tb = b[ti] if ti < len(b) else None
            if ta != tb:
                differ += 1
                stream_differs = True
                if first is None:
                    first = (pi, ti)
        if stream_differs:
            streams_differing += 1
    # digests differ but every token matched: the logits bytes moved
    # (a sub-argmax corruption) — report the smallest nonzero distance
    distance = (differ / total) if total else 0.0
    if distance == 0.0:
        distance = 1.0 / (total + 1) if total else 1.0
    return {"distance": distance, "streams_differing": streams_differing,
            "first_divergence": first, "match": False}


# ---------------------------------------------------------------------------
# nonparametric tests (dependency-free: no scipy)
# ---------------------------------------------------------------------------


def _norm_sf(z: float) -> float:
    """P[Z >= z] for a standard normal."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def mann_whitney_p(canary: Sequence[float], incumbent: Sequence[float],
                   *, worse: str = "greater") -> float:
    """One-sided Mann–Whitney U p-value for "the canary's distribution
    is WORSE than the incumbent's" — ``worse="greater"`` means higher
    values are worse (TTFT), ``worse="less"`` means lower values are
    worse (per-slot decode progress).  Normal approximation with tie
    correction and continuity correction; all-tied samples return 1.0
    (identical distributions are not drift)."""
    if worse not in ("greater", "less"):
        raise ValueError(f"worse must be 'greater'/'less', got {worse!r}")
    n1, n2 = len(canary), len(incumbent)
    if n1 == 0 or n2 == 0:
        return 1.0
    pooled = [(float(v), 0) for v in canary] + \
        [(float(v), 1) for v in incumbent]
    pooled.sort(key=lambda p: p[0])
    # average ranks over ties
    n = n1 + n2
    ranks = [0.0] * n
    tie_term = 0.0
    i = 0
    while i < n:
        j = i
        while j + 1 < n and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[k] = avg
        t = j - i + 1
        if t > 1:
            tie_term += t ** 3 - t
        i = j + 1
    r_canary = sum(r for r, (_, side) in zip(ranks, pooled) if side == 0)
    u_canary = r_canary - n1 * (n1 + 1) / 2.0
    mean = n1 * n2 / 2.0
    var = (n1 * n2 / 12.0) * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0.0:
        return 1.0  # every observation tied — no evidence of drift
    sigma = math.sqrt(var)
    if worse == "greater":
        # large U (canary ranks high) = canary worse
        z = (u_canary - mean - 0.5) / sigma
        return _norm_sf(z)
    z = (u_canary - mean + 0.5) / sigma
    return 1.0 - _norm_sf(z)


def binom_tail(k: int, n: int, p: float) -> float:
    """P[Bin(n, p) >= k], exactly, in log space (lgamma)."""
    k, n = int(k), int(n)
    if k <= 0:
        return 1.0
    if n <= 0 or k > n:
        return 0.0 if k > n else 1.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    log_p, log_q = math.log(p), math.log1p(-p)
    total = 0.0
    lg_n1 = math.lgamma(n + 1)
    for i in range(k, n + 1):
        log_c = lg_n1 - math.lgamma(i + 1) - math.lgamma(n - i + 1)
        total += math.exp(log_c + i * log_p + (n - i) * log_q)
    return min(total, 1.0)


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


class CanaryVerdict(NamedTuple):
    #: "pass" | "fail" | "no_verdict" — no_verdict means the honesty
    #: floor was not met on ANY channel; it is NOT a pass
    status: str
    #: per-channel evidence: metric, kind, sample counts, p, verdict
    checks: Tuple[Dict[str, object], ...]

    @property
    def failed(self) -> Tuple[Dict[str, object], ...]:
        return tuple(c for c in self.checks if c["verdict"] == "fail")


class CanaryAnalyzer:
    """Canary-vs-incumbent drift verdicts over named metric channels.

    Two channel kinds:

    - **samples** (:meth:`add_samples`): continuous observations
      (TTFT ms, per-slot tokens per tick) judged by a one-sided
      Mann–Whitney U in the channel's ``worse`` direction;
    - **events** (:meth:`add_events`): bad-event counts out of a total
      (per-reason sheds / terminals, spec rejects / drafts) judged by
      an exact binomial tail against the pooled incumbent rate
      (add-half smoothed).

    The **min-sample honesty floor**: a samples channel needs
    ``min_samples`` observations ON EACH SIDE, an events channel needs
    ``min_event_total`` trials on each side — below the floor the
    channel's verdict is ``None`` and contributes nothing, and an
    analyzer whose every channel is below floor returns
    ``"no_verdict"``, never ``"pass"`` (the BurnRateTracker
    half-coverage rule, applied to deploys).  A fail additionally
    requires ``min_events`` bad canary events (one unlucky request is
    an anecdote, not a regression).
    """

    def __init__(self, *, min_samples: int = 16, alpha: float = 1e-3,
                 min_events: int = 4, min_event_total: int = 8):
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.min_samples = int(min_samples)
        self.alpha = float(alpha)
        self.min_events = int(min_events)
        self.min_event_total = int(min_event_total)
        # metric -> {"canary": [...], "incumbent": [...], "worse": str}
        self._samples: Dict[str, Dict[str, object]] = {}
        # metric -> {"canary": [bad, total], "incumbent": [bad, total]}
        self._events: Dict[str, Dict[str, List[float]]] = {}

    @staticmethod
    def _side(side: str) -> str:
        if side not in ("canary", "incumbent"):
            raise ValueError(
                f"side must be 'canary'/'incumbent', got {side!r}"
            )
        return side

    def add_samples(self, side: str, metric: str,
                    values: Sequence[float], *,
                    worse: str = "greater") -> None:
        side = self._side(side)
        if worse not in ("greater", "less"):
            raise ValueError(
                f"channel {metric!r}: worse={worse!r} is not "
                f"'greater' or 'less'"
            )
        ch = self._samples.setdefault(
            metric, {"canary": [], "incumbent": [], "worse": worse}
        )
        if ch["worse"] != worse:
            raise ValueError(
                f"channel {metric!r} direction changed: "
                f"{ch['worse']!r} -> {worse!r}"
            )
        ch[side].extend(float(v) for v in values)

    def add_events(self, side: str, metric: str, bad: float,
                   total: float) -> None:
        side = self._side(side)
        if bad < 0 or total < 0 or bad > total:
            raise ValueError(
                f"channel {metric!r}: bad={bad} total={total} is not a "
                f"count of bad events out of a total"
            )
        ch = self._events.setdefault(
            metric, {"canary": [0.0, 0.0], "incumbent": [0.0, 0.0]}
        )
        ch[side][0] += float(bad)
        ch[side][1] += float(total)

    def verdict(self) -> CanaryVerdict:
        checks: List[Dict[str, object]] = []
        for metric in sorted(self._samples):
            ch = self._samples[metric]
            can, inc = ch["canary"], ch["incumbent"]
            check = {
                "metric": metric, "kind": "samples",
                "worse": ch["worse"],
                "n_canary": len(can), "n_incumbent": len(inc),
                "p": None, "verdict": None,
            }
            if len(can) >= self.min_samples and \
                    len(inc) >= self.min_samples:
                p = mann_whitney_p(can, inc, worse=ch["worse"])
                check["p"] = p
                check["verdict"] = "fail" if p < self.alpha else "pass"
            checks.append(check)
        for metric in sorted(self._events):
            ch = self._events[metric]
            bad_c, tot_c = ch["canary"]
            bad_i, tot_i = ch["incumbent"]
            check = {
                "metric": metric, "kind": "events",
                "bad_canary": bad_c, "n_canary": tot_c,
                "bad_incumbent": bad_i, "n_incumbent": tot_i,
                "p": None, "verdict": None,
            }
            if tot_c >= self.min_event_total and \
                    tot_i >= self.min_event_total:
                # pooled incumbent rate, add-half smoothed (a 0-count
                # incumbent never claims the bad rate is exactly 0)
                p_hat = (bad_i + 0.5) / (tot_i + 1.0)
                p = binom_tail(int(round(bad_c)), int(round(tot_c)),
                               p_hat)
                check["p"] = p
                check["verdict"] = (
                    "fail"
                    if p < self.alpha and bad_c >= self.min_events
                    else "pass"
                )
            checks.append(check)
        if any(c["verdict"] == "fail" for c in checks):
            status = "fail"
        elif any(c["verdict"] == "pass" for c in checks):
            status = "pass"
        else:
            status = "no_verdict"
        return CanaryVerdict(status=status, checks=tuple(checks))


# ---------------------------------------------------------------------------
# fleet-facing configuration + controller
# ---------------------------------------------------------------------------


@dataclass
class CanaryConfig:
    """Canary-gating knobs for :meth:`~apex_tpu_torch.fleetctl.Fleet.
    start_rolling_update`.

    ``frac`` is the router load-share ceiling while the verdict is
    out (the provable bad-weight exposure bound).  ``soak_ticks`` is
    the minimum window before a statistical PASS is accepted (a fail
    halts immediately); ``max_window_ticks`` bounds the wait — at
    expiry a floor-starved window closes ``inconclusive`` (warned,
    deploy proceeds) rather than blocking the fleet forever.
    """

    frac: float = 0.25
    probes: Optional[GoldenProbeSet] = None
    min_samples: int = 16
    alpha: float = 1e-3
    min_events: int = 4
    min_event_total: int = 8
    soak_ticks: int = 240
    max_window_ticks: int = 600

    def __post_init__(self):
        if not (0.0 < self.frac < 1.0):
            raise ValueError(
                f"canary_frac must be in (0, 1), got {self.frac}"
            )
        if self.max_window_ticks < self.soak_ticks:
            raise ValueError(
                f"max_window_ticks {self.max_window_ticks} < "
                f"soak_ticks {self.soak_ticks}"
            )


class CanaryController:
    """Windowed canary-vs-incumbent observation over live replicas.

    Opened by the fleet when the canary returns to service: baselines
    every replica's ledgers (completion index, terminal-shed index,
    token counter, spec counters), then :meth:`observe` once per fleet
    tick collects the per-tick continuous channel and
    :meth:`verdict` folds everything since the baseline through a
    fresh :class:`CanaryAnalyzer`.  Replicas that die mid-window keep
    contributing the samples they produced while alive (their ledgers
    persist) — the verdict never reads beyond what actually happened.
    """

    def __init__(self, canary, incumbents, config: CanaryConfig):
        self.canary = canary
        self.incumbents = list(incumbents)
        self.cfg = config
        self._base: Dict[str, Dict[str, object]] = {}
        self._last_tokens: Dict[str, int] = {}
        self._open_tokens: Dict[str, int] = {}
        self._tick_samples: Dict[str, List[float]] = {
            "canary": [], "incumbent": [],
        }
        for rep in [self.canary] + self.incumbents:
            self._base[rep.name] = self._snapshot(rep)
            self._last_tokens[rep.name] = rep.sched._tokens_out
            self._open_tokens[rep.name] = rep.sched._tokens_out

    @staticmethod
    def _snapshot(rep) -> Dict[str, object]:
        spec = (0.0, 0.0)
        if rep.engine.spec is not None and rep.registry is not None:
            vals = rep.registry.fetch()
            spec = (float(vals.get("serve/spec_drafted", 0.0)),
                    float(vals.get("serve/spec_accepted", 0.0)))
        return {
            "completed": len(rep.sched.completed),
            "shed": len(rep.sched.shed),
            "spec": spec,
        }

    def _sides(self):
        return (("canary", [self.canary]),
                ("incumbent", self.incumbents))

    def observe(self) -> None:
        """Per-tick channel: tokens emitted per RUNNING slot this tick
        — load-independent decode progress (a throttled/stalled decode
        shows up here even when every token is eventually produced)."""
        for side, reps in self._sides():
            for rep in reps:
                cur = rep.sched._tokens_out
                delta = cur - self._last_tokens[rep.name]
                self._last_tokens[rep.name] = cur
                running = len(rep.sched.running)
                if running > 0:
                    self._tick_samples[side].append(delta / running)

    def token_exposure(self) -> Tuple[int, int]:
        """``(canary_tokens, total_tokens)`` emitted since the window
        opened — the bad-token half of the exposure bound."""
        canary = total = 0
        for side, reps in self._sides():
            for rep in reps:
                d = rep.sched._tokens_out - self._open_tokens[rep.name]
                total += d
                if side == "canary":
                    canary += d
        return canary, total

    def analyzer(self) -> CanaryAnalyzer:
        cfg = self.cfg
        an = CanaryAnalyzer(
            min_samples=cfg.min_samples, alpha=cfg.alpha,
            min_events=cfg.min_events,
            min_event_total=cfg.min_event_total,
        )
        for side, reps in self._sides():
            ttfts: List[float] = []
            shed_by_reason = {r: 0 for r in DRIFT_SHED_REASONS}
            terminals = 0
            spec_drafted = spec_accepted = 0.0
            for rep in reps:
                base = self._base[rep.name]
                done = rep.sched.completed[base["completed"]:]
                shed = rep.sched.shed[base["shed"]:]
                ttfts.extend(
                    r.ttft_ms for r in done if r.ttft_ms is not None
                )
                terminals += len(done) + len(shed)
                for r in shed:
                    if r.shed_reason in shed_by_reason:
                        shed_by_reason[r.shed_reason] += 1
                if rep.engine.spec is not None and \
                        rep.registry is not None:
                    vals = rep.registry.fetch()
                    d0, a0 = base["spec"]
                    spec_drafted += \
                        float(vals.get("serve/spec_drafted", 0.0)) - d0
                    spec_accepted += \
                        float(vals.get("serve/spec_accepted", 0.0)) - a0
            an.add_samples(side, "ttft_ms", ttfts, worse="greater")
            an.add_samples(side, "tokens_per_slot_tick",
                           self._tick_samples[side], worse="less")
            for reason, n in shed_by_reason.items():
                an.add_events(side, f"shed_{reason}", n, terminals)
            if spec_drafted > 0:
                an.add_events(side, "spec_reject",
                              spec_drafted - spec_accepted, spec_drafted)
        return an

    def verdict(self) -> CanaryVerdict:
        return self.analyzer().verdict()
