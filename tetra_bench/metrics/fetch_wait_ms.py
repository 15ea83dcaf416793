"""Host ms a superblock blocked on the card for the superblock step's
output (the program's fetch span, TetraReceiver._fused_host: the one
wait of the superblock outside the FEC)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "fetch")
