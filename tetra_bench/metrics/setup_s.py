"""Set-up: process start, kernel load from the build cache, air synthesis
on the card, receiver construction and the traffic's warm-up air, up to
the first superblock of the window, in seconds."""


def read(run):
    return run.setup_s
