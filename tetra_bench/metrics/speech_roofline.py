"""The speech decode's share of its roofline, in %: the least time of the
slots and halves decoded in the traced span stretch (tetra_bench.
speech_work, from the program's voice.slots and voice.halves counters of
that stretch's records) over the device time of every kernel launched
while the program's tetra.voice.decode range was open in it."""

from tetra_bench import speech_work
from tetra_bench.harness import PROFILE_SPAN_SB


def read(run):
    dev = run.spans.get("program_device_s", {}).get("tetra.voice.decode")
    if not dev:
        return None
    try:
        from tetra_tpu_torch import spans
    except ImportError:
        return None
    rec = spans.records()
    if len(rec) < PROFILE_SPAN_SB or "voice.slots" not in rec.dtype.names:
        return None
    rec = rec[len(rec) - PROFILE_SPAN_SB:]
    least = speech_work.speech_ms(float(rec["voice.slots"].sum()),
                                  float(rec["voice.halves"].sum()))
    return 100.0 * least / 1e3 / dev
