# Copy of src/repro/obs/export.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Snapshot export + exposition round-trip checks.

``write_snapshot`` dumps a registry to a JSON file (numpy scalars and
arrays coerced to plain JSON).  ``parse_prometheus`` is a minimal parser
for the text exposition our registry emits — CI uses it to prove the
scrape from a live serving run is well-formed (every sample line parses,
every histogram family carries a cumulative ``_bucket`` ladder ending in
``+Inf`` that agrees with its ``_sum``/``_count`` pair) without needing a
Prometheus binary in the container.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["write_snapshot", "parse_prometheus", "validate_exposition"]

_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)$"
)
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')
_ESCAPE = re.compile(r"\\(.)")


def _unescape_label(v: str) -> str:
    # text-format 0.0.4: `\\` -> backslash, `\"` -> quote, `\n` -> newline
    # (a single left-to-right pass — sequential str.replace would corrupt
    # values like `\\n`, turning an escaped backslash + n into a newline)
    return _ESCAPE.sub(lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def write_snapshot(reg: MetricsRegistry, path, extra: dict | None = None
                   ) -> Path:
    """Write ``reg.snapshot()`` (plus optional ``extra`` payload keys) as
    JSON to ``path``; returns the path written."""
    path = Path(path)
    payload = {"metrics": _jsonable(reg.snapshot())}
    if extra:
        payload.update(_jsonable(extra))
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def parse_prometheus(text: str) -> list:
    """Parse exposition text into ``(name, labels, value)`` tuples.

    Raises ``ValueError`` on any line that is neither a comment nor a
    well-formed sample.
    """
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels = {}
        if m.group("labels"):
            for lm in _LABEL.finditer(m.group("labels")):
                labels[lm.group("k")] = _unescape_label(lm.group("v"))
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: non-numeric value {m.group('value')!r}"
            ) from e
        out.append((m.group("name"), labels, value))
    return out


def _label_sig(labels: dict, drop: str) -> tuple:
    return tuple(sorted((k, v) for k, v in labels.items() if k != drop))


def validate_exposition(text: str) -> list:
    """Structural checks on exposition text; returns problem strings
    (empty = valid).

    Checks: every line parses, every value is finite, and every histogram
    family is a *real* cumulative-bucket histogram — each ``_bucket``
    series (grouped by base name + non-``le`` labels) carries a valid
    ``le`` ladder ending in ``+Inf``, its counts are non-decreasing in
    ``le`` order, the ``+Inf`` count equals the family's ``_count``, and
    the ``_sum`` / ``_count`` samples exist.
    """
    try:
        samples = parse_prometheus(text)
    except ValueError as e:
        return [str(e)]
    problems = []
    values = {}
    families: dict = {}
    for name, labels, value in samples:
        if not np.isfinite(value):
            problems.append(f"{name}{labels}: non-finite value {value}")
        values[(name, _label_sig(labels, drop=""))] = value
        if name.endswith("_bucket") and "le" in labels:
            base = name[: -len("_bucket")]
            fam = families.setdefault((base, _label_sig(labels, "le")), [])
            le = float("inf") if labels["le"] == "+Inf" else float(labels["le"])
            fam.append((le, value))

    for (base, sig), fam in families.items():
        where = f"{base}{{{','.join(f'{k}={v}' for k, v in sig)}}}"
        les = [le for le, _ in fam]
        if les != sorted(les) or len(set(les)) != len(les):
            problems.append(f"{where}: le ladder not strictly increasing")
        if not les or les[-1] != float("inf"):
            problems.append(f"{where}: missing +Inf bucket")
        counts = [c for _, c in sorted(fam)]
        if any(a > b for a, b in zip(counts, counts[1:])):
            problems.append(f"{where}: bucket counts not cumulative")
        for suffix in ("_sum", "_count"):
            if (base + suffix, sig) not in values:
                problems.append(f"{where}: missing {base + suffix}")
        total = values.get((base + "_count", sig))
        if fam and total is not None and sorted(fam)[-1][1] != total:
            problems.append(
                f"{where}: +Inf bucket {sorted(fam)[-1][1]} != _count "
                f"{total}"
            )
    return problems
