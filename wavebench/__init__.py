"""The benchmark of ``pytorch_wavenet_tpu_torch`` on one NVIDIA H100.

One run of one cell: ``python3 wavebench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout (README.md).
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
