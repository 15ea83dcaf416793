"""Host feed only: host ms a superblock in process_wideband's growing
buffer, the concatenate of every call (the program's ingest.buffer
span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "ingest.buffer")
