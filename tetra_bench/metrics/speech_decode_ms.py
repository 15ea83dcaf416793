"""Host ms a superblock in the voice stage's batched speech decode: its
enqueue and its one wait for the card (the program's voice.decode
span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "voice.decode")
