"""setup_s: process start to the window's start, less the seconds spent
making the data from the seed (host clock)."""


def read(run):
    return run.setup_s
