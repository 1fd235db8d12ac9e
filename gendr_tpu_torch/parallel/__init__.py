"""Rendering across devices over ``torch.distributed``
(``gendr_tpu_torch.parallel.sharding``)."""
