"""Host ms a superblock in the fleet engine's voice stage (the program's
voice span: the batched speech decode, the TEA1 decryption and the ACELP
synthesis of the superblock's voice slots; inside the engine span)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "voice")
