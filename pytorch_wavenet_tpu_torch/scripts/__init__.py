"""The port's single-card tools, each run as ``python -m
pytorch_wavenet_tpu_torch.scripts.<name>``: ``benchmark`` (the full
sweep), ``serving_bench`` (closed-loop load on the continuous batcher),
``serving_soak`` (the pool's lifecycle invariants under mixed load),
``distill_demo`` (teacher, IAF student and their quality metrics) and
``make_demo_data`` (a seeded synthetic dataset). Importing a tool runs
nothing."""
