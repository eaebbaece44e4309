"""The window's images times one image's forward at the chip's peaks
(binary MACs at the int8 peak, the float stem and head at the bf16 peak;
``portbench.roofline.forward_min_s``), over the window's seconds."""
from portbench.roofline import forward_min_s

UNIT = "%"


def read(rec):
    if rec.kind != "serve" or not rec.window.get("images"):
        return None
    return 100 * forward_min_s(rec.config) * rec.window["images"] / rec.window["seconds"]
