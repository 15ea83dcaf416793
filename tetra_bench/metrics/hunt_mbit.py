"""Mbit a superblock fed to carriers that were hunting for a burst
(unlocked) when the superblock's feed began (the program's hunt.bits
counter): the burst-sync search the fleet engine runs on empty
carriers."""

from tetra_bench import program_spans


def read(run):
    v = program_spans.mean(run, "hunt.bits")
    return None if v is None else v / 1e6
