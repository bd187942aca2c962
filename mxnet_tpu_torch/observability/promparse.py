"""Minimal Prometheus text-format parser: the scrape side of the
exposition contract.

Counterpart of ``mxnet_tpu/observability/promparse.py``, plain Python.
``metrics.dump_metrics`` renders the registry in the text exposition
format; this module is the inverse, and the one place the parsing and
label-value unescaping rules live (the time-series plane renders its
series keys with :func:`labels_to_str`).

Scope: exactly the subset ``dump_metrics`` emits: ``# HELP`` / ``# TYPE``
comment lines, sample lines with an optional ``{...}`` label block, float
values (``NaN`` / ``+Inf`` included). Timestamps and exemplar syntax are
not produced by the renderer and not accepted here.
"""
from __future__ import annotations

import collections
import math

__all__ = ["ParsedScrape", "parse_text", "labels_to_str"]

# samples: {metric name: {sorted (key, value) label tuple: float}} —
# the tuple key is canonical (metrics._canon_labels order), so two
# scrapes of the same instrument always collide on one entry
ParsedScrape = collections.namedtuple("ParsedScrape",
                                      ["types", "helps", "samples"])

_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape_label_value(body, j):
    """Parse one double-quoted, escaped label value starting at
    ``body[j] == '"'``; returns (value, index past the closing quote)."""
    assert body[j] == '"', "label value must be quoted"
    j += 1
    out = []
    while body[j] != '"':
        if body[j] == "\\":
            out.append(_ESCAPES[body[j + 1]])
            j += 2
        else:
            out.append(body[j])
            j += 1
    return "".join(out), j + 1


def _parse_labels(body):
    """The inside of a ``{...}`` block -> sorted ((key, value), ...)."""
    labels = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq]
        val, i = _unescape_label_value(body, eq + 1)
        labels[key] = val
        if i < len(body) and body[i] == ",":
            i += 1
    return tuple(sorted(labels.items()))


def _parse_value(text):
    """Sample values per the exposition format (``+Inf``/``-Inf``/``NaN``
    are spelled exactly so); raises ValueError on malformed input."""
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def parse_text(text):
    """Parse one exposition document into a :class:`ParsedScrape`.

    Malformed sample lines raise ``ValueError`` — a scrape that cannot
    be trusted must fail, not contribute garbage to a merge. Unknown
    comment lines (``# retrace causes ...`` tails, blank lines) are
    skipped, matching real scrapers.
    """
    types, helps, samples = {}, {}, {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind.strip()
            continue
        if line.startswith("# HELP "):
            _, _, name, txt = line.split(None, 3)
            # HELP escaping is backslash + newline only (quotes legal)
            helps[name] = txt.replace("\\n", "\n").replace("\\\\", "\\")
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, value = rest.rsplit("}", 1)
            key = _parse_labels(body)
        else:
            name, value = line.rsplit(None, 1)
            key = ()
        samples.setdefault(name.strip(), {})[key] = _parse_value(
            value.strip())
    return ParsedScrape(types, helps, samples)


def labels_to_str(labels):
    """Render a canonical label tuple back to ``k="v",k2="v2"`` (no
    braces, values escaped) — the display/JSON key the time-series
    plane uses for one child series."""
    return ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in labels)
