from .deploy import DeployedConv, DeployedLinear, deploy, set_gemm_impl
from .export import batched_call
from .optimize import fold_bn_after, fold_bn_before, optimize_deployed
from .serving import Predictor
from .stem import FusedStem, SpaceToDepthConv, fuse_stem, space_to_depth_stem

__all__ = [
    "DeployedConv",
    "DeployedLinear",
    "deploy",
    "set_gemm_impl",
    "batched_call",
    "fold_bn_after",
    "fold_bn_before",
    "optimize_deployed",
    "Predictor",
    "FusedStem",
    "SpaceToDepthConv",
    "fuse_stem",
    "space_to_depth_stem",
]
