"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on an
NVIDIA H100: ``python3 chipbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
