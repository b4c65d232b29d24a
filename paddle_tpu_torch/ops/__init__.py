"""Device functions of the port: the K1 flash-attention forward
(flash_attention.py, a hand-written Hopper kernel) and the LM server's
KV-cached transformer functions (transformer_ops.py)."""
