"""Host ms a superblock the typed FEC waits for the card (the program's
fec.wait span around its one synchronise, _Dispatch.wait)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "fec.wait")
