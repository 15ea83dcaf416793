"""Host feed only: host ms a superblock in the windows' pageable
host-to-device copies (the program's ingest.upload span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "ingest.upload")
