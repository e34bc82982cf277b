"""Serving (counterpart of ``paddle_tpu/serving/``): so far the paged
greedy ``generation.SlotDecodeSession`` and its page pool."""
