"""Distributed runtime: error-feedback gradient compression over
``torch.distributed`` (the port of the reference's ``repro/distributed``;
its pod-mesh sharding layer is not ported yet)."""
