"""Launch layer: the store-backed compressed serving path, the train,
prefill and serve steps, the checkpoint-backed ``ModelServer`` and
``Trainer``, and a step profiler."""
