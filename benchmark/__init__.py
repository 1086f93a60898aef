"""The benchmark of the PyTorch and CUDA port (``bokego_tpu_torch``):
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
