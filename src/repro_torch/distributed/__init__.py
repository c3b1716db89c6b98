"""Distributed runtime over ``torch.distributed`` (the port of the
reference's ``repro/distributed``): the logical-axis sharding rules and
their DTensor placements (``sharding``) and error-feedback gradient
compression (``compression``). Tensor-parallel compute over ``model`` is
not ported: sharded steps compute on local tensors
(``launch.shardings.sharded``)."""
