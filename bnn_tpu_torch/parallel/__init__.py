"""Training loop bodies (counterpart of ``bnn_tpu/parallel``). Only the
single-device steps are ported; the mesh, pipeline, ZeRO-1 and tensor
parallelism are still to come (ROADMAP.md queue 1)."""
from .trainstep import make_eval_step, make_train_step

__all__ = ["make_train_step", "make_eval_step"]
