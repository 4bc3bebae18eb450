"""Tensor parallelism over ``torch.distributed`` ranks (``sharding.py``)."""
