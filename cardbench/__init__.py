"""The benchmark of the PyTorch/CUDA port (``randlapack_tpu_torch``) on
one NVIDIA H100: ``python3 cardbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``README.md``."""
