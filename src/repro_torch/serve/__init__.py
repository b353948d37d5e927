"""LM serving: prefill/decode steps (``steps``) and the wave / continuous
batching engine (``engine``)."""
