"""Bench tools of the port (counterparts of ``flash_attention_from_scratch_tpu/tools``)."""
