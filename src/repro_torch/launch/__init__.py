"""Launch layer: the compressed serving paths (store-backed, and
host-quantized from a parameter tree), the train, prefill and serve steps,
the checkpoint-backed ``ModelServer`` and ``Trainer``, the shape stand-ins
on the ``meta`` device, and a step profiler."""
