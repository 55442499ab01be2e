"""The multi-device layer on ``torch.distributed``: meshes and collectives
(``mesh``), partition specs and the Megatron head (``sharding``), the
data- and model-parallel train step and sharded generation
(``training``), each rank's block of a batch stream (``data_sharding``),
the time-sharded trunk (``time_sharding``) and layer-pipelined generation
(``pipeline``): the JAX package's ``parallel/``, one rank a process."""
