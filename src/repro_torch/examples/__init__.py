"""Runnable examples on the port: ``quickstart``, ``finetune_dedup``,
``serve_compressed`` and ``train_e2e``, each as ``python -m
repro_torch.examples.<name>`` and as ``main(argv)``, which returns the
numbers it prints. They run on the card unless given ``--device cpu``.
"""
