"""deconv_mvox_iter_s: the volume's voxels (every lane's) times the object
iterations of the units completed in the window, over the seconds from the
window's start to the end of its last completed unit, in millions."""

from benchmark.rates import mvox_iter_per_s

__all__ = ["read"]


def read(run):
    return mvox_iter_per_s(run.units, run.t_start, run.seconds)
