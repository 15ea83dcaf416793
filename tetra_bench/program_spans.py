"""The program's own spans and counters over a run's measured window.

tetra_tpu_torch.spans (the program's tracer) closes one record a
superblock and keeps its records after the receiver is freed.  A traced
run decodes its window's superblocks, then PROFILE_DEVICE_SB and
PROFILE_SPAN_SB more under the profiler; the window's records are
therefore the last run.superblocks + 6 less the last 6.  Every reader
returns None where the program has no tracer, or fewer records than
that: a program without spans, or a run that did not reach them.
"""

from __future__ import annotations

from tetra_bench.harness import PROFILE_DEVICE_SB, PROFILE_SPAN_SB


def window(run):
    """The records of the run's window, oldest first, or None."""
    try:
        from tetra_tpu_torch import spans
    except ImportError:
        return None
    rec = spans.records()
    after = PROFILE_DEVICE_SB + PROFILE_SPAN_SB
    n = run.superblocks + after
    if not run.superblocks or len(rec) < n:
        return None
    return rec[len(rec) - n:len(rec) - after]


def mean(run, field: str, less: tuple = ()):
    """The window's mean a superblock of `field` less the `less` fields
    (span ns or counters, by name), or None."""
    rec = window(run)
    if rec is None or field not in rec.dtype.names:
        return None
    v = rec[field].astype(float)
    for f in less:
        v = v - rec[f]
    return float(v.mean())


def mean_ms(run, span: str, less: tuple = ()):
    """The window's host ms a superblock in `span` less its `less` spans."""
    v = mean(run, span, less)
    return None if v is None else v / 1e6
