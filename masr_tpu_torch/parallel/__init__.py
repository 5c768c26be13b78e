"""Data and tensor parallelism over processes (port of masr_tpu/parallel/):
mesh.py the process groups, the (data, model) grid and batch sharding;
tp.py the tensor-parallel rules and the sliced parameters and optimizer
state."""
