"""Host ms a superblock in the voice stage's batched ACELP synthesis, one
C++ call over the engine's worker threads (the program's voice.acelp
span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "voice.acelp")
