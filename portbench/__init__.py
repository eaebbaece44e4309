"""The benchmark of the PyTorch and CUDA port (``bnn_tpu_torch``) on one
H100: ``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``PERF.md`` for the cells and metrics."""
