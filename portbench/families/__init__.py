"""The architecture families under the benchmark (:mod:`portbench.arch`)."""
