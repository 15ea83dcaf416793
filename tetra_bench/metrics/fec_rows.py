"""Rows a superblock handed to the card's FEC (the program's fec.rows
counter)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean(run, "fec.rows")
