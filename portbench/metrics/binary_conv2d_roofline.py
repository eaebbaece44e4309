"""``binary_conv2d``'s share of its roofline over the profiled slice: the sum of
its calls' least times (``portbench.roofline.binary_conv2d_bound``, from the
configuration's layer each call's input shapes name) over the sum of their
device times."""
from portbench.readers import roofline_pct

UNIT = "%"


def read(rec):
    return roofline_pct(rec, "binary_conv2d")
