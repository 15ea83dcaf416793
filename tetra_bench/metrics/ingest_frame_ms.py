"""Host feed only: host ms a superblock framing the windows, the stack
and the cast to float32 (the program's ingest.frame span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "ingest.frame")
