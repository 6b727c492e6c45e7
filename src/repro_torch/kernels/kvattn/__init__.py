"""int8-KV decode attention: ``kv_decode`` (CUDA) with its plain version."""
