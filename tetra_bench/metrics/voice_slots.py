"""Full traffic slots a superblock the voice monitor decoded (the
program's voice.slots counter)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean(run, "voice.slots")
