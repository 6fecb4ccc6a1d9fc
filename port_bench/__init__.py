"""The benchmark of rank_tpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
harness is driven by data: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``, whose
``driver`` names a module of ``drivers/``); each per-layer metric is a reader
in ``metrics/<name>.py``; each model has a plain reference in
``reference/<model>.py`` and a work count in ``work/<model>.py``; each cell
has the limits of its output check in ``limits/<cell>.json``.

Nothing here imports JAX, flax or the JAX package ``rank_tpu``.
"""
