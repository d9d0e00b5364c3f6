"""Core algorithm layer: the quantizer Q, dense bit-packing, and the
backend-selectable boundary ops every wire crossing routes through."""
