"""parallel subpackage of rome_tpu_torch (counterpart of ``rome_tpu/parallel``):
the distributed solves over ``torch.distributed`` ranks, one process per rank."""
