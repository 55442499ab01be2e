"""The plain reference: WaveNet in plain PyTorch, the sampling noise, and
the comparisons that decide ``correct``. It imports nothing of
``pytorch_wavenet_tpu_torch``, nor JAX, nor the JAX package, and takes
nothing the program made: the harness hands it the weights and inputs it
made itself, and the program's outputs to judge.
"""
