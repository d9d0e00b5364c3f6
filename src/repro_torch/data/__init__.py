"""Sample-id-stable datasets for AQ-SGD's per-sample message buffers."""
