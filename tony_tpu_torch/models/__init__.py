"""Model families: the flagship decoder LM (transformer, KV-cache
decoding, continuous batching, weight conversion, training), BERT MLM
pretraining, ResNet (data-parallel, synchronised batch norm) and the
MNIST MLP/CNN of the north-star recipe."""

from tony_tpu_torch.models import mnist, resnet

__all__ = ["mnist", "resnet"]
