"""The benchmark of tpucomp_torch: batched lossless compression on one NVIDIA GPU.

``run.py`` runs one cell once; ``README.md`` says how to add a
configuration, a cell or a metric as new files only.
"""
