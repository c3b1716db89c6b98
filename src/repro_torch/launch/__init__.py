"""Launch layer: the store-backed compressed serving path, the prefill and
serve steps, the checkpoint-backed ``ModelServer`` and a step profiler."""
