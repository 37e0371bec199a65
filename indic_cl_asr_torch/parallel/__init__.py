"""The data-parallel runtime on torch.distributed (distributed.py: the
process group; sharding.py: the data axis and the batch's rows)."""
