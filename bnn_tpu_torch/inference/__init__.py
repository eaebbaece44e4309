from .batching import BatcherStats, ContinuousBatcher
from .compress import (QuantizedConv, QuantizedLinear, quantize_float_layers,
                       state_bytes)
from .deploy import (DeployedConv, DeployedLinear, deploy, model_weight_bytes,
                     packed_weight_bytes, set_gemm_impl)
from .export import (ExportedServer, batched_call, export_serving,
                     load_serving)
from .megablock import (FusedBlock, FusedBottleneck, FusedDownBlock,
                        default_fuse_predicate, fuse_blocks)
from .optimize import fold_bn_after, fold_bn_before, optimize_deployed
from .serving import Predictor
from .stages import (FusedEntry, FusedStage, fuse_entry, fuse_head,
                     fuse_stages)
from .stem import FusedStem, SpaceToDepthConv, fuse_stem, space_to_depth_stem
from .tp import shard_tp_state, tag_tensor_parallel, tp_state_specs
from .tp_packed import (PackedTPLayer, ici_bytes_per_layer, pack_chain_weights,
                        packed_tp_chain, reference_chain)

__all__ = [
    "BatcherStats",
    "ContinuousBatcher",
    "QuantizedConv",
    "QuantizedLinear",
    "quantize_float_layers",
    "state_bytes",
    "model_weight_bytes",
    "packed_weight_bytes",
    "DeployedConv",
    "DeployedLinear",
    "deploy",
    "set_gemm_impl",
    "batched_call",
    "ExportedServer",
    "export_serving",
    "load_serving",
    "FusedBlock",
    "FusedBottleneck",
    "FusedDownBlock",
    "default_fuse_predicate",
    "fuse_blocks",
    "fold_bn_after",
    "fold_bn_before",
    "optimize_deployed",
    "Predictor",
    "FusedEntry",
    "FusedStage",
    "fuse_entry",
    "fuse_head",
    "fuse_stages",
    "FusedStem",
    "SpaceToDepthConv",
    "fuse_stem",
    "space_to_depth_stem",
    "tag_tensor_parallel",
    "tp_state_specs",
    "shard_tp_state",
    "PackedTPLayer",
    "pack_chain_weights",
    "packed_tp_chain",
    "ici_bytes_per_layer",
    "reference_chain",
]
