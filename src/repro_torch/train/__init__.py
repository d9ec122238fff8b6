"""LM training on the port: AdamW and schedules (``optimizer``), the
training step (``train_step``) and the loop with checkpoint, restart and
heartbeat hooks (``trainer``)."""
