"""The window's images times one image's training step at the bf16 peak
(3 x the forward's MACs; ``portbench.roofline.train_min_s``), over the
window's seconds."""
from portbench.roofline import train_min_s

UNIT = "%"


def read(rec):
    if rec.kind != "train" or not rec.window.get("images"):
        return None
    return 100 * train_min_s(rec.config) * rec.window["images"] / rec.window["seconds"]
