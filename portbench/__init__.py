"""The benchmark of the PyTorch and CUDA port (``crdt_tpu_torch``) on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; the cells are listed in ``BENCHMARK.json``
at the repository's root.  See ``portbench/harness.py``."""
