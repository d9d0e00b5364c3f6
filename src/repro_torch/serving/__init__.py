"""Compressed serving plane: the paper's codecs at inference time.

* `delta` — AC-SGD-style delta codec for the inter-stage decode hop;
* `kvcache` — quantized KV cache (the ``kv`` plane of CommConfig).
"""
from repro_torch.serving.delta import DeltaHopCodec
from repro_torch.serving.kvcache import KVCodec

__all__ = ["DeltaHopCodec", "KVCodec"]
