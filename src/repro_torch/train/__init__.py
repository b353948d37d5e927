"""LM training (torch port of ``repro.train``): hand-written AdamW with
int8 gradient compression (``optimizer``), the loss and the train step
with microbatches, remat and the MoE aux loss (``steps``), and the
router histogram (``router_stats``)."""
