"""setup_s: seconds from the process's start to the window's: importing,
making the stacks on the card, building the kernels (a checkout's first
run), and one warm-up unit."""

__all__ = ["read"]


def read(run):
    return run.setup_s
