"""Host feed only: bytes the ingest's concatenate, stack and cast wrote
over the IQ bytes fed, over the window (the program's
ingest.bytes_copied and ingest.bytes_fed counters)."""

from tetra_bench import program_spans


def read(run):
    copied = program_spans.mean(run, "ingest.bytes_copied")
    fed = program_spans.mean(run, "ingest.bytes_fed")
    return copied / fed if copied is not None and fed else None
