"""Distributed runtime over ``torch.distributed`` (the port of the
reference's ``repro/distributed``): the logical-axis sharding rules and
their DTensor placements (``sharding``) and error-feedback gradient
compression (``compression``). ``sharding`` also carries the
tensor-parallel compute over ``model`` of the dense models' steps
(``constrain``, ``einsum``, ``local_seam`` on DTensors inside
``launch.shardings.sharded``'s ``"tp"`` route)."""
