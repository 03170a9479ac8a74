"""OpenMetrics exporter — the live half of the telemetry spine.

Counterpart of ``apex_tpu/observability/ometrics.py``, host code copied
over, so the port's exposition of the same values is the reference's
byte for byte (family names keep the ``apex_tpu_`` prefix, and the
arming variable stays ``APEX_TPU_OPS_PORT``):

- :func:`metric_name` — the deterministic mapping from the board and
  registry keys (``serve/ttft_queue_wait_fraction``) to legal
  OpenMetrics names (``apex_tpu_serve_ttft_queue_wait_fraction``):
  lowercase, separators to ``_``, the ``apex_tpu_`` prefix.
  :class:`ExportNamespace` rejects a key whose name, or a sample name
  it reserves (``<name>_total`` for a counter), collides with another
  key's, and :class:`~apex_tpu_torch.observability.metrics.
  MetricRegistry` declares every key through it, so a key that cannot
  be exported fails at declaration.
- :func:`render` — one exposition (``# TYPE``/``# UNIT``/``# HELP``,
  counter ``_total`` samples, histogram ``_bucket``/``_count``/``_sum``
  with cumulative ``le`` buckets, ``# EOF``) over registries, host-side
  :class:`Histogram` s and the board; ``# HELP`` carries the original
  key.
- :class:`Histogram` — a host-side bucket accumulator; the serving
  scheduler keeps its TTFT distribution in one.
- :class:`OpsServer` — a stdlib ``http.server`` thread serving ``GET
  /metrics`` from the registries' cached values (no device contact).
- :func:`parse_exposition` — a strict parser of what this module
  emits, so "OpenMetrics-valid" is a checked claim.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from apex_tpu_torch.observability.locks import TrackedLock

__all__ = [
    "ENV_OPS_PORT",
    "ops_port_from_env",
    "CONTENT_TYPE",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "metric_name",
    "ExportNamespace",
    "Histogram",
    "render",
    "parse_exposition",
    "OpsServer",
]

ENV_OPS_PORT = "APEX_TPU_OPS_PORT"

#: the OpenMetrics 1.0 content type every ``/metrics`` response carries
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: default latency buckets (milliseconds) — spans sub-ms CPU smoke runs
#: to multi-second tail blowups; SLO thresholds should land ON a bound
#: (``Histogram.count_le`` truncates to the nearest lower bound)
DEFAULT_LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

def ops_port_from_env(spec: Optional[str] = None) -> Optional[int]:
    """The ONE ``APEX_TPU_OPS_PORT`` parsing convention (``0`` =
    OS-assigned, unset/empty = disabled) — tools resolve their
    ``--ops-port`` default through this so the arming grammar cannot
    drift per surface."""
    spec = spec if spec is not None else os.environ.get(ENV_OPS_PORT)
    if spec is None or str(spec).strip() == "":
        return None
    return int(str(spec).strip())


_PREFIX = "apex_tpu_"
_LEGAL_NAME = re.compile(r"^[a-z_][a-z0-9_]*$")
#: characters that become ``_`` (everything else non-alphanumeric is
#: dropped — and the injectivity check catches any resulting collision)
_SEPARATORS = frozenset("/-. :")


def metric_name(key: str) -> str:
    """The OpenMetrics metric name for a board/registry ``key``.

    Deterministic and purely structural: lowercase, separators
    (``/ - . :`` and spaces) to ``_``, other non-``[a-z0-9_]``
    characters dropped, runs of ``_`` collapsed, ``apex_tpu_``
    prefixed.  Raises ``ValueError`` when nothing legal survives —
    injectivity over a *set* of keys is :class:`ExportNamespace`'s job.
    """
    out = []
    for ch in str(key):
        if ch.isascii() and ch.isalnum():
            out.append(ch.lower())
        elif ch in _SEPARATORS or ch == "_":
            out.append("_")
        # anything else: dropped (collision check guards the fallout)
    name = re.sub(r"__+", "_", "".join(out)).strip("_")
    if not name or not _LEGAL_NAME.match(name):
        raise ValueError(
            f"key {key!r} cannot be mapped to a legal OpenMetrics "
            f"metric name (got {name!r} after mangling)"
        )
    return _PREFIX + name


def _reserved_samples(family: str, kind: str) -> Tuple[str, ...]:
    """Every sample name a family of ``kind`` will emit (the collision
    surface: a counter ``x`` exposes ``x_total``, so a gauge named
    ``x_total`` must be rejected)."""
    if kind == "counter":
        return (family, family + "_total")
    if kind == "histogram":
        return (family, family + "_bucket", family + "_count",
                family + "_sum")
    return (family,)


class ExportNamespace:
    """Injectivity guard for the key→metric-name mapping.

    ``declare(key, kind)`` returns the family name, is idempotent for a
    re-declared ``(key, kind)``, and raises ``ValueError`` when the key
    is unmappable or any of its reserved sample names collides with a
    DIFFERENT key's — the registry-level validation that keeps the
    whole board vocabulary round-trippable through the exporter.
    """

    def __init__(self):
        self._families: Dict[str, Tuple[str, str]] = {}  # family -> (key, kind)
        self._samples: Dict[str, str] = {}  # sample name -> family

    def declare(self, key: str, kind: str = "gauge") -> str:
        # min/max registry kinds export as gauges
        kind = "gauge" if kind in ("min", "max") else kind
        family = metric_name(key)
        prev = self._families.get(family)
        if prev is not None:
            if prev == (key, kind):
                return family
            raise ValueError(
                f"key {key!r} ({kind}) mangles to {family!r} which is "
                f"already taken by key {prev[0]!r} ({prev[1]}) — the "
                "OpenMetrics mapping must stay injective; rename the key"
            )
        for sample in _reserved_samples(family, kind):
            owner = self._samples.get(sample)
            if owner is not None and owner != family:
                raise ValueError(
                    f"key {key!r} ({kind}) would emit sample "
                    f"{sample!r} which collides with family {owner!r} "
                    f"(key {self._families[owner][0]!r}) — rename the key"
                )
        self._families[family] = (key, kind)
        for sample in _reserved_samples(family, kind):
            self._samples[sample] = family
        return family

    @property
    def families(self) -> Dict[str, Tuple[str, str]]:
        return dict(self._families)


class Histogram:
    """Host-side cumulative-bucket histogram (OpenMetrics semantics).

    ``buckets`` are the finite upper bounds (``le`` is inclusive); the
    ``+Inf`` bucket is implicit.  ``observe`` is a bisect + two adds —
    cheap enough for per-request call sites.  ``count_le(bound)``
    returns the cumulative count at the nearest bucket bound ≤
    ``bound`` (exact when the bound IS a bucket edge — put SLO
    thresholds on edges): the good-event count of a latency SLO.
    """

    def __init__(self, key: str, buckets: Iterable[float],
                 unit: str = "", help: str = ""):
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket bounds must increase: {bounds}")
        if any(math.isnan(b) or math.isinf(b) for b in bounds):
            raise ValueError("bucket bounds must be finite (+Inf is implicit)")
        self.key = str(key)
        self.unit = str(unit)
        self.help = str(help)
        # fail unmappable names at construction, not at scrape
        metric_name(self.key)
        self._bounds = bounds
        self._counts = [0] * len(bounds)
        self._inf = 0
        self._sum = 0.0
        self._count = 0
        # observe() runs on the serving thread while a scrape renders
        # on the HTTP thread: without the lock a scrape could see a
        # bucket incremented but _count not yet — an exposition whose
        # _count disagrees with the +Inf bucket, which strict parsers
        # (including parse_exposition in the CI gate) reject
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            if i < len(self._bounds):
                self._counts[i] += 1
            else:
                self._inf += 1
            self._sum += v
            self._count += 1

    def _consistent_view(self) -> Tuple[List[Tuple[float, int]], int, float]:
        """``(cumulative, count, sum)`` captured under ONE lock — the
        render/snapshot source, so ``_count`` always equals the
        ``+Inf`` bucket in anything emitted."""
        with self._lock:
            counts = list(self._counts)
            inf, count, total = self._inf, self._count, self._sum
        out, running = [], 0
        for b, c in zip(self._bounds, counts):
            running += c
            out.append((b, running))
        out.append((math.inf, running + inf))
        return out, count, total

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le_bound, cumulative_count), ...]`` ending at ``+Inf``."""
        return self._consistent_view()[0]

    def count_le(self, bound: float) -> int:
        """Observations ≤ the nearest bucket bound ≤ ``bound`` (0 when
        ``bound`` sits under the first bucket).  Conservative by
        construction: a threshold between bounds under-counts good
        events rather than inventing them."""
        i = bisect.bisect_right(self._bounds, float(bound)) - 1
        if i < 0:
            return 0
        with self._lock:
            return sum(self._counts[: i + 1])

    def snapshot(self) -> Dict[str, Any]:
        cumulative, count, total = self._consistent_view()
        return {
            "key": self.key,
            "unit": self.unit,
            "count": count,
            "sum": total,
            "buckets": [
                {"le": ("+Inf" if math.isinf(b) else b), "count": c}
                for b, c in cumulative
            ],
        }


# -- exposition rendering ---------------------------------------------------


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _fmt(v) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else _fmt(bound)


class _Family:
    def __init__(self, name, kind, unit="", help=""):
        self.name, self.kind, self.unit, self.help = name, kind, unit, help
        self.lines: List[str] = []

    def render(self) -> List[str]:
        out = [f"# TYPE {self.name} {self.kind}"]
        # a UNIT line requires the name to end with the unit suffix —
        # emit it only when the vocabulary already follows the
        # convention (serve/ttft_ms etc.); the mapping itself never
        # rewrites names to force it
        if self.unit and self.name.endswith("_" + self.unit):
            out.append(f"# UNIT {self.name} {self.unit}")
        if self.help:
            out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.extend(self.lines)
        return out


def _unit_token(unit: str) -> str:
    """Unit metadata must itself be a legal name token; anything else
    (e.g. the registry's descriptive ``"fraction (…)"`` strings) is
    dropped from metadata rather than corrupting the exposition."""
    unit = (unit or "").strip().lower()
    return unit if re.match(r"^[a-z][a-z0-9_]*$", unit) else ""


def render(
    registries: Iterable[Any] = (),
    histograms: Iterable[Histogram] = (),
    board: Optional[Mapping[str, Any]] = None,
) -> str:
    """One OpenMetrics exposition over the given sources.

    - ``registries``: :class:`~apex_tpu_torch.observability.metrics.
      MetricRegistry` objects — declared kinds/units, **cached** values
      only (:meth:`values` — never a blocking fetch).
    - ``histograms``: :class:`Histogram` objects.
    - ``board``: a key→value mapping (pass ``board.snapshot()``);
      numeric values export as gauges, strings are skipped (the board
      holds config strings like ``serve/kv_wire`` that have no sample
      representation).

    Name collisions across sources resolve first-wins in the order
    above (a registry value is fresher than a board echo of it) —
    *within* a registry the :class:`ExportNamespace` validation already
    made collisions impossible.
    """
    families: Dict[str, _Family] = {}
    taken: set = set()

    def claim(name: str, kind: str) -> bool:
        reserved = _reserved_samples(name, kind)
        if name in families or any(s in taken for s in reserved):
            return False
        taken.update(reserved)
        return True

    for reg in registries:
        values = reg.values()
        for key in reg.names:
            kind = reg.kind(key)
            kind = "gauge" if kind in ("min", "max") else kind
            if key not in values:
                continue  # declared but never fetched: no sample yet
            name = metric_name(key)
            if not claim(name, kind):
                continue
            fam = families[name] = _Family(
                name, kind, _unit_token(reg.unit(key)),
                f"board key {key!r}",
            )
            sample = name + "_total" if kind == "counter" else name
            fam.lines.append(f"{sample} {_fmt(values[key])}")

    for hist in histograms:
        name = metric_name(hist.key)
        if not claim(name, "histogram"):
            continue
        fam = families[name] = _Family(
            name, "histogram", _unit_token(hist.unit),
            hist.help or f"board key {hist.key!r}",
        )
        # one consistent view: buckets, _count and _sum must agree even
        # while another thread observes mid-render
        cumulative, count, total = hist._consistent_view()
        for bound, cum in cumulative:
            fam.lines.append(
                f'{name}_bucket{{le="{_fmt_le(bound)}"}} {cum}'
            )
        fam.lines.append(f"{name}_count {count}")
        fam.lines.append(f"{name}_sum {_fmt(total)}")

    if board:
        for key in sorted(board):
            value = board[key]
            if isinstance(value, bool) or not isinstance(
                value, (int, float)
            ):
                continue
            try:
                name = metric_name(key)
            except ValueError:
                continue  # an unmappable ad-hoc board key: skip, not crash
            if not claim(name, "gauge"):
                continue
            fam = families[name] = _Family(
                name, "gauge", help=f"board key {key!r}"
            )
            fam.lines.append(f"{name} {_fmt(value)}")

    lines: List[str] = []
    for name in sorted(families):
        lines.extend(families[name].render())
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# -- strict validating parser (tests + the CI OPS gate) ---------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>\S+))?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    if tok == "NaN":
        return math.nan
    return float(tok)


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse + validate an OpenMetrics exposition (the subset
    :func:`render` emits).  Returns ``{family: {"type", "unit",
    "help", "samples": [(sample_name, labels, value)], "value"}}``
    (``value`` is the bare sample for gauge/counter families).

    Raises ``ValueError`` on: a missing/misplaced ``# EOF``, samples
    before their ``# TYPE``, metadata after samples of the same family,
    a counter sample not named ``<family>_total``, a ``# UNIT`` that is
    not a suffix of the name, histogram buckets whose ``le`` bounds are
    not strictly increasing / cumulative counts decreasing / missing
    ``+Inf`` / ``_count`` disagreeing with the ``+Inf`` bucket.
    The conformance tests run it over a live scrape.
    """
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition does not end with '# EOF'")
    lines.pop()

    families: Dict[str, Dict[str, Any]] = {}

    def family_for_sample(sample: str) -> Optional[str]:
        for suffix in ("_total", "_bucket", "_count", "_sum", ""):
            base = sample[: len(sample) - len(suffix)] if suffix else sample
            if suffix and not sample.endswith(suffix):
                continue
            if base in families:
                return base
        return None

    for i, line in enumerate(lines, 1):
        if line.startswith("# "):
            parts = line[2:].split(" ", 2)
            if len(parts) < 2:
                raise ValueError(f"line {i}: bad metadata line {line!r}")
            keyword, name = parts[0], parts[1]
            rest = parts[2] if len(parts) > 2 else ""
            if keyword == "EOF":
                raise ValueError(f"line {i}: '# EOF' before the end")
            if keyword == "TYPE":
                if name in families:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                families[name] = {
                    "type": rest, "unit": "", "help": "", "samples": [],
                }
            elif keyword in ("UNIT", "HELP"):
                fam = families.get(name)
                if fam is None:
                    raise ValueError(
                        f"line {i}: {keyword} for undeclared family {name}"
                    )
                if fam["samples"]:
                    raise ValueError(
                        f"line {i}: {keyword} after samples of {name}"
                    )
                if keyword == "UNIT":
                    if not name.endswith("_" + rest):
                        raise ValueError(
                            f"line {i}: unit {rest!r} is not a suffix "
                            f"of {name!r}"
                        )
                    fam["unit"] = rest
                else:
                    fam["help"] = rest
            else:
                raise ValueError(f"line {i}: unknown metadata {keyword!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: unparseable sample line {line!r}")
        sample = m.group("name")
        base = family_for_sample(sample)
        if base is None:
            raise ValueError(
                f"line {i}: sample {sample!r} before any matching # TYPE"
            )
        labels = dict(
            (k, v.replace('\\"', '"').replace("\\n", "\n")
             .replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        )
        value = _parse_value(m.group("value"))
        fam = families[base]
        kind = fam["type"]
        if kind == "counter":
            if sample != base + "_total":
                raise ValueError(
                    f"line {i}: counter sample must be {base}_total, "
                    f"got {sample!r}"
                )
            if value < 0:
                raise ValueError(f"line {i}: negative counter {value}")
        elif kind == "gauge":
            if sample != base:
                raise ValueError(
                    f"line {i}: gauge sample {sample!r} != family {base!r}"
                )
        elif kind == "histogram":
            if sample == base + "_bucket" and "le" not in labels:
                raise ValueError(f"line {i}: bucket without an le label")
        fam["samples"].append((sample, labels, value))

    for name, fam in families.items():
        if fam["type"] == "histogram":
            buckets = [
                (_parse_value(labels["le"]), value)
                for sample, labels, value in fam["samples"]
                if sample == name + "_bucket"
            ]
            if not buckets or not math.isinf(buckets[-1][0]):
                raise ValueError(
                    f"{name}: histogram must end with an le=\"+Inf\" bucket"
                )
            for (b1, c1), (b2, c2) in zip(buckets, buckets[1:]):
                if not b2 > b1:
                    raise ValueError(
                        f"{name}: le bounds not increasing ({b1} -> {b2})"
                    )
                if c2 < c1:
                    raise ValueError(
                        f"{name}: cumulative counts decreasing "
                        f"({c1} -> {c2} at le={_fmt_le(b2)})"
                    )
            counts = [
                value for sample, _l, value in fam["samples"]
                if sample == name + "_count"
            ]
            if counts and counts[0] != buckets[-1][1]:
                raise ValueError(
                    f"{name}: _count {counts[0]} != +Inf bucket "
                    f"{buckets[-1][1]}"
                )
        else:
            bare = [
                value for sample, _l, value in fam["samples"]
                if not sample.endswith(("_bucket",))
            ]
            fam["value"] = bare[0] if bare else None
    return families


# -- the HTTP endpoint ------------------------------------------------------


class OpsServer:
    """Serve ``GET /metrics`` from a daemon thread (stdlib only).

    >>> srv = OpsServer(registries=[reg], histograms=[hist],
    ...                 port=0).start()        # port 0 = OS-assigned
    >>> srv.url                                 # http://127.0.0.1:PORT/metrics
    >>> srv.stop()

    A scrape calls the optional ``collect`` hook (a sampler that
    refreshes board gauges), then renders the sources' **cached** values — no device contact, no
    blocking registry fetch; freshness is the registry's own
    ``2 × fetch_every`` contract.  Scrape count and duration publish to
    the board (``ops/scrapes``, ``ops/scrape_ms``) so the exporter
    observes itself.

    ``port=0`` binds an OS-assigned ephemeral port; :attr:`bound_port`
    (and the updated :attr:`port` / :attr:`url`) expose it after
    :meth:`start` — how N fleet replicas in ONE process each export
    ``/metrics`` without a port collision.  ``name=`` namespaces the
    self-observation board keys (``ops/<name>/scrapes``, ...): without
    it, N servers in one process would silently overwrite each other's
    gauges on the shared board.
    """

    def __init__(
        self,
        *,
        registries: Iterable[Any] = (),
        histograms: Iterable[Histogram] = (),
        include_board: bool = True,
        collect=None,
        host: str = "127.0.0.1",
        port: int = 0,
        name: Optional[str] = None,
    ):
        self.registries = list(registries)
        self.histograms = list(histograms)
        self.include_board = include_board
        self.collect = collect
        self.host = host
        self.port = int(port)
        self.name = name
        self.scrapes = 0
        self.last_scrape_ms: Optional[float] = None
        # scrape() runs on ThreadingHTTPServer handler threads while
        # tests/boards read the counters from the main thread
        self._lock = TrackedLock("ops.scrape")
        self._server = None
        self._thread = None

    def _board_key(self, leaf: str) -> str:
        return (
            f"ops/{self.name}/{leaf}" if self.name else f"ops/{leaf}"
        )

    @property
    def bound_port(self) -> Optional[int]:
        """The OS-assigned port after :meth:`start` (None before — a
        requested ``port=0`` is a *wish*, not an address)."""
        if self._server is None:
            return None
        return self._server.server_address[1]

    @classmethod
    def from_env(cls, spec: Optional[str] = None, **kwargs):
        """An UNSTARTED server armed by ``APEX_TPU_OPS_PORT=PORT``
        (``0`` = OS-assigned), or ``None`` when the env is unset/empty
        — the flight-recorder arming convention."""
        port = ops_port_from_env(spec)
        if port is None:
            return None
        return cls(port=port, **kwargs)

    def add_source(self, *, registry=None, histogram=None) -> None:
        """Late-bind a source (schedulers and their histograms usually
        exist only after the server that should export them)."""
        if registry is not None:
            self.registries.append(registry)
        if histogram is not None:
            self.histograms.append(histogram)

    def scrape(self) -> str:
        """One in-process exposition (the exact text ``/metrics``
        serves)."""
        t0 = time.perf_counter()
        if self.collect is not None:
            self.collect()
        board_snapshot = None
        if self.include_board:
            from apex_tpu_torch.observability.metrics import board

            board_snapshot = board.snapshot()
        text = render(self.registries, self.histograms, board_snapshot)
        with self._lock:
            self.scrapes += 1
            self.last_scrape_ms = 1e3 * (time.perf_counter() - t0)
            scrapes, scrape_ms = self.scrapes, self.last_scrape_ms
        if self.include_board:
            from apex_tpu_torch.observability.metrics import board

            board.set(self._board_key("scrapes"), scrapes)
            board.set(self._board_key("scrape_ms"), scrape_ms)
        return text

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "OpsServer":
        import http.server

        ops = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    body = ops.scrape().encode("utf-8")
                except Exception as e:  # pragma: no cover - defensive
                    self.send_error(500, f"scrape failed: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes are routine
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="apex-tpu-ops",
            daemon=True,
        )
        self._thread.start()
        from apex_tpu_torch.observability.metrics import board

        board.set(self._board_key("port"), self.port)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
