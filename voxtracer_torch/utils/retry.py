"""Failure detection and retry (counterpart of voxtracer/utils/retry.py).

``with_retries`` re-runs a step after a backoff when it failed in a way
that leaves this process's runtime usable: a ``torch.distributed``
connection that was reset, closed or timed out, or a card that was busy
or unavailable (another process holding it in exclusive-process mode).
A sticky CUDA error (an illegal memory access, an unspecified launch
failure, a device-side assert, an uncorrectable ECC error) is never
retried, because it leaves the process's CUDA context unusable until the
process exits."""

from __future__ import annotations

import sys
import time


RETRYABLE_MARKERS = ("DistNetworkError", "connection reset", "connection closed",
                     "timed out", "busy or unavailable", "exclusive-process",
                     "DEADLINE_EXCEEDED")
STICKY_MARKERS = ("illegal memory access", "unspecified launch failure",
                  "device-side assert", "uncorrectable ECC error")


def is_retryable(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m.lower() in text for m in STICKY_MARKERS):
        return False
    return any(m.lower() in text for m in RETRYABLE_MARKERS)


def with_retries(fn, attempts: int = 3, backoff_s: float = 60.0,
                 log=lambda *a: print(*a, file=sys.stderr)):
    """Run fn() with retry-on-runtime-failure; re-raises non-retryable or
    exhausted errors."""
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 (classified below)
            if attempt + 1 >= attempts or not is_retryable(exc):
                raise
            log(f"[retry] attempt {attempt + 1} failed with retryable error: "
                f"{type(exc).__name__}; sleeping {backoff_s:.0f}s")
            time.sleep(backoff_s)
    raise RuntimeError("unreachable")
