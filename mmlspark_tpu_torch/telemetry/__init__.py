"""Runtime telemetry of the PyTorch port.

Only ``warn_once`` is ported so far (from ``mmlspark_tpu/telemetry``); the
metrics registry, tracer and exposition layers are ROADMAP.md Queue 1 item 13.
Until the registry exists, occurrences are counted in ``warning_counts``.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_warned_keys: set = set()  # guarded-by: _lock
#: occurrences per key — the JAX package counts these in the
#: ``mmlspark_warnings_total{key=...}`` metric
warning_counts: dict = {}  # guarded-by: _lock


def warn_once(logger, key: str, msg: str, *args):
    """Log ``msg`` at WARNING once per ``key`` per process; count EVERY
    occurrence (the log dedupes, the count keeps going)."""
    with _lock:
        warning_counts[key] = warning_counts.get(key, 0) + 1
        first = key not in _warned_keys
        _warned_keys.add(key)
    if first:
        logger.warning(msg, *args)
