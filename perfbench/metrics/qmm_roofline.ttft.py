"""K1 and K2 through ``qmm``: ``readers.roofline`` of the qmm family."""
from perfbench.readers import roofline


def read(run):
    return roofline(run, "qmm")
