"""Carriers one card keeps in real time: the configuration's carriers x
the seconds of air the window decoded / the window's wall seconds (every
superblock over all the time, each ending in its fetch and engine call;
a host feed's chunks included)."""


def read(run):
    return run.carriers * run.air_s / run.wall_s
