"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json`` and the files beside this
one.  Nothing here imports JAX or the JAX package."""
