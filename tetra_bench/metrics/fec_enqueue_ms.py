"""Host ms a superblock in the typed FEC outside its one synchronise:
uploads, the trellis ops' launches and the fetch copies (the program's
fec span less fec.wait)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "fec", ("fec.wait",))
