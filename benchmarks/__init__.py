"""The benchmark of the PyTorch and CUDA port (``ilqr_tpu_torch``): one
command, ``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, cells and metrics named in ``BENCHMARK.json`` at the
repository's root. See ``benchmarks/README.md``."""
