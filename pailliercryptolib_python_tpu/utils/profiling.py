"""Tracing/profiling hooks (SURVEY.md §5 tracing row).

The reference's observability is per-test wall-clock prints and a
google_benchmark harness; here the framework wires the real device
profiler: `trace(dir)` captures a jax.profiler trace viewable in
TensorBoard/Perfetto, and `annotate(name)` scopes device ops so HE-level
phases (encrypt / obfuscate / CRT decrypt / reduce) show up as named
spans in the trace timeline.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profiler trace into log_dir (TensorBoard format).

    Usage:
        with profiling.trace("/tmp/jax-trace"):
            ct = pk.encrypt(x)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span context for device work (shows in profiler timelines)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Host wall-clock span: appends (label, seconds) to `sink` (a list)
    or prints to stderr.  The analog of the reference's per-test
    timing prints (/root/reference/tests/ipcl_python_test.py:17-19)."""
    import sys

    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            print(f"[timed] {label}: {dt * 1e3:.1f} ms", file=sys.stderr,
                  flush=True)
