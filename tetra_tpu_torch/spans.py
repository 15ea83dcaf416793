"""Host-clock spans and counters of the fleet receiver's hot path.

One process-wide tracer.  The receiver opens a span at each layer
boundary of a superblock (the host feed, the step's enqueue, the fetch,
the fleet engine, the typed FEC, ...) and adds to a few counters; each
superblock then closes one record: its sequence number, its first and
last host nanosecond, every span's nanoseconds and calls, and every
counter.  Spans that fall between superblocks (a host-feed call that
only buffers its samples) go into the next superblock's record: a
record is written when the superblock has ended and no span is open any
more, so the host-feed call that runs a superblock is in that
superblock's record whole.  Records go into a ring of RING_ROWS rows,
allocated once; they outlive the receiver that made them.  The receiver
records from the one thread that drives it; two receivers driven in one
process share the records.

    with spans.span("fetch"):          # or begin("fetch") ... end()
        ...
    spans.count("fec.rows", n)
    rec = spans.records()              # closed records, oldest first
    rec["fetch"].mean() / 1e6          # ms a superblock

The clock is time.perf_counter_ns.  A span around asynchronous device
work measures its enqueue; none synchronises.  While a torch profiler is
recording, every span also opens a torch.profiler.record_function range
named "tetra.<span>", so the program's ranges sit in the profiler's
trace beside the kernels they launch, on the profiler's clock; the
PROFILED names are such ranges only, with no host accumulator.  With no
profiler running no range is made.

Spans (parent in brackets):

    ingest                      TetraReceiver.process_wideband, fleet mode
      ingest.buffer   [ingest]  each write's copy into pinned staging
                                (on a CPU device, bookkeeping only)
      ingest.frame    [ingest]  the windows cut from the device ring and
                                its tail moved to its front (enqueued)
      ingest.upload   [ingest]  each write's copy into the ring (enqueued)
    superblock        [ingest]  one superblock until its PDUs are out
      step      [superblock]    the K cycles' enqueue
      fetch     [superblock]    the host blocked on the card
      engine    [superblock]    FleetEngine.process_packed2
        engine.feed   [engine]  native burst sync and RM(30,14)
        fec           [engine]  one typed FEC pass (its self time: enqueue)
          fec.wait    [fec]     the FEC's one synchronise
        engine.dispatch [engine] native MAC dispatch
        voice         [engine]  the voice monitor's stage (voice=True):
                                a superblock's speech slots to PCM
          voice.decode  [voice] the batched speech decode's enqueue and
                                its one wait
          voice.decrypt [voice] the cipher state, the TEA1 keystreams and
                                their XOR onto the codec frames
          voice.acelp   [voice] the batched ACELP synthesis: on a CUDA
                                device its upload, one kernel launch
                                and its fetch

Counters: fec.rows (rows handed to the card's FEC), fec.trellis_rows
(rows the trellis kernel decoded, counted where rx/viterbi.viterbi_decode
launches it; 0 on a CPU device), hunt.bits (bits fed
to carriers that were unlocked when the superblock's feed began),
ingest.bytes_fed (IQ bytes given to process_wideband),
ingest.bytes_copied (bytes the ingest wrote on the host: a dtype cast,
and each write's copy into pinned staging, or into the ring itself on a
CPU device), ingest.bytes_uploaded (bytes written into the ring from
host memory), and the voice monitor's voice.slots (full traffic slots
decoded), voice.halves (surviving halves of first-half steals decoded),
voice.bad_frames (codec frames flagged bad), voice.frames_decrypted
(codec frames TEA1-decrypted) and voice.acelp_rows (rows the ACELP kernel
synthesised, withheld rows not counted; 0 on a CPU device).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

SPANS = ("ingest", "ingest.buffer", "ingest.frame", "ingest.upload",
         "superblock", "step", "fetch", "engine", "engine.feed", "fec",
         "fec.wait", "engine.dispatch", "voice", "voice.decode",
         "voice.decrypt", "voice.acelp")
PROFILED = ("frontend", "demod")
COUNTERS = ("fec.rows", "hunt.bits", "ingest.bytes_fed",
            "ingest.bytes_copied", "ingest.bytes_uploaded", "voice.slots",
            "voice.halves", "voice.bad_frames", "voice.frames_decrypted",
            "fec.trellis_rows", "voice.acelp_rows")
RING_ROWS = 16384

_HEAD = ("seq", "start_ns", "end_ns")
_COLS = len(_HEAD) + len(SPANS) + len(COUNTERS) + len(SPANS)
# a record: the head, each span's ns and each counter by name, and the
# spans' calls in one (len(SPANS),) field; every field int64, so a row of
# the ring viewed as RECORD is one record
RECORD = np.dtype([(n, np.int64) for n in _HEAD + SPANS + COUNTERS]
                  + [("calls", np.int64, (len(SPANS),))])
_INDEX = {n: i for i, n in enumerate(SPANS)}
_CTR = {n: i for i, n in enumerate(COUNTERS)}

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_ring = np.zeros((RING_ROWS, _COLS), np.int64)
_stack: list = []           # open spans: (index, start ns, profiler range)
_ns = [0] * len(SPANS)
_calls = [0] * len(SPANS)
_ctr = [0] * len(COUNTERS)
_seq = 0
_start = None               # first ns of the record being gathered
_due = False                # its superblock has ended


def begin(name: str) -> None:
    """Open span `name` (one of SPANS); end() closes the innermost."""
    global _start
    rf = None
    if _profiling():
        rf = torch.profiler.record_function("tetra." + name)
        rf.__enter__()
    t = _clock()
    if _start is None:
        _start = t
    _stack.append((_INDEX[name], t, rf))


def end() -> None:
    """Close the innermost open span; write the record if its superblock
    has ended and this was the outermost span."""
    i, t0, rf = _stack.pop()
    t = _clock()
    _ns[i] += t - t0
    _calls[i] += 1
    if rf is not None:
        rf.__exit__(None, None, None)
    if _due and not _stack:
        _write(t)


def count(name: str, n: int) -> None:
    """Add n to counter `name` (one of COUNTERS)."""
    _ctr[_CTR[name]] += n


def close_superblock() -> None:
    """End the current superblock: its record is written now, or when the
    outermost open span closes."""
    global _due
    _due = True
    if not _stack:
        _write(_clock())


def _write(t: int) -> None:
    global _seq, _start, _due, _ns, _calls, _ctr
    _ring[_seq % RING_ROWS] = [_seq, t if _start is None else _start, t,
                               *_ns, *_ctr, *_calls]
    _seq += 1
    _start, _due = None, False
    _ns, _calls, _ctr = ([0] * len(SPANS), [0] * len(SPANS),
                         [0] * len(COUNTERS))


def records() -> np.ndarray:
    """The closed records still in the ring, oldest first (a copy; a
    RECORD array)."""
    n = min(_seq, RING_ROWS)
    rows = np.arange(_seq - n, _seq) % RING_ROWS
    return np.ascontiguousarray(_ring[rows]).view(RECORD).reshape(n)


def clear() -> None:
    """Drop every record and what the open record has gathered; spans
    still open close into the next record."""
    global _seq, _start, _due, _ns, _calls, _ctr
    _seq, _start, _due = 0, None, False
    _ns, _calls, _ctr = ([0] * len(SPANS), [0] * len(SPANS),
                         [0] * len(COUNTERS))


class _Span:
    __slots__ = ("name", "ends_superblock")

    def __init__(self, name: str):
        self.name = name
        self.ends_superblock = name == "superblock"

    def __enter__(self):
        begin(self.name)

    def __exit__(self, *exc):
        end()
        if self.ends_superblock:
            close_superblock()


_SPAN = {n: _Span(n) for n in SPANS}
_NO_RANGE = contextlib.nullcontext()


def span(name: str) -> _Span:
    """Span `name` as a context manager; leaving the "superblock" span
    ends the superblock (close_superblock)."""
    return _SPAN[name]


def profiled(name: str):
    """A "tetra.<name>" profiler range while a profiler records, else a
    context that does nothing (name: one of PROFILED)."""
    if _profiling():
        return torch.profiler.record_function("tetra." + name)
    return _NO_RANGE
