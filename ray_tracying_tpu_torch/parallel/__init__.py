"""Multi-device rendering on torch.distributed: process-group setup
(cluster.py) and the rays sharded over the ranks (sharding.py).

Port of the JAX package's parallel/."""
