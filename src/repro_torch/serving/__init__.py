"""Compressed serving plane: the paper's codecs at inference time.

* `delta` — AC-SGD-style delta codec for the inter-stage decode hop;
* `kvcache` — quantized KV cache (the ``kv`` plane of CommConfig);
* `batcher` — continuous batching of a request stream over a pool of
  cache slots, with the kv-plane slot guard.
"""
from repro_torch.serving.batcher import ContinuousBatcher, ServeRequest
from repro_torch.serving.delta import DeltaHopCodec
from repro_torch.serving.kvcache import KVCodec

__all__ = ["ContinuousBatcher", "DeltaHopCodec", "KVCodec", "ServeRequest"]
