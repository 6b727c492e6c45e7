"""K5 through ``adaround_forward``: ``readers.roofline`` of the fakequant family."""
from perfbench.readers import roofline


def read(run):
    return roofline(run, "fakequant")
