from .cache import enable_compilation_cache
from .checkpoint import (gather_replicated, load_checkpoint,
                         optimizer_state_dict, restore_into,
                         restore_optimizer, save_checkpoint)
from .debug import assert_finite, checkify_errors, debug_nans
from .flops import OpCount, count_ops
from .jax_weights import jax_to_port, load_jax_state
from .meters import AverageMeter, ProgressMeter, accuracy, count_parameters
from .precision import cast_float_tree, cast_floats
from .profiling import compiled_stats, trace
from .timing import loop_time
from .torch_import import (import_torch_checkpoint, load_torch_file,
                           torch_to_state_dict)

__all__ = ["AverageMeter", "OpCount", "ProgressMeter", "accuracy",
           "assert_finite", "cast_float_tree", "cast_floats",
           "checkify_errors", "compiled_stats", "count_ops",
           "count_parameters", "debug_nans", "enable_compilation_cache",
           "gather_replicated", "import_torch_checkpoint", "jax_to_port",
           "load_checkpoint", "load_jax_state", "load_torch_file",
           "loop_time", "optimizer_state_dict", "restore_into",
           "restore_optimizer", "save_checkpoint", "torch_to_state_dict",
           "trace"]
