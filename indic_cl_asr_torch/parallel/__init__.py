"""The DP x TP runtime on torch.distributed (distributed.py: the process
group; sharding.py: the mesh, the batch's rows and the model's shards)."""
