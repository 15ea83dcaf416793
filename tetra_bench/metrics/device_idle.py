"""The share of the traced device stretch (several steady superblocks,
CUDA activity only) in which no kernel, copy or memset ran on the card,
in %."""


def read(run):
    busy, wall = run.device.get("busy_s"), run.device.get("window_s")
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
